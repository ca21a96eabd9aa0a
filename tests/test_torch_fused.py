"""The fused panel updates and the right transposed TRSM, on the CPU.

On CPU tensors the wrappers of ``repro_torch.kernels.fused_panel_update``
and ``trsm.trsm_right_lower_t`` run their plain PyTorch versions (the
CUDA kernels are held against those on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here the plain
versions meet the reference:

* the fused plain versions against ``fused_*_ref``, the eager twins of the
  reference's Pallas kernels (their bodies, bitwise the kernels on the
  interpret backend).  Those compute in float32 whatever the input dtype,
  so the tolerance is 200·max(m,n,8)·eps(f32); LU pivots must be equal;
* the right TRSM's plain version against ``repro.kernels.ref
  .trsm_right_lower_t`` at the input dtype, 200·max(m,n,8)·eps;
* the Cholesky panel kernel's plain version against the reference's
  ``repro.core.cholesky.cholesky_panel`` (jnp ops, no Pallas kernel) at the
  input dtype, 200·max(m,n,8)·eps, and bitwise against the ``"cuda"``
  backend's composed panel on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from repro.core import cholesky as ref_chol
from repro.kernels import fused_panel_update as ref_fpu
from repro.kernels import ref as ref_kernels
from repro_torch.core.cholesky import cholesky_panel
from repro_torch.kernels import fused_panel_update as fpu
from repro_torch.kernels import ops, trsm

jax.config.update("jax_enable_x64", True)

DTYPES = (np.float32, np.float64)


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(m, n, dtype=np.float32):
    return 200.0 * max(m, n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _lu_operands(m, b, bn, dtype, seed=0):
    _, l, _ = sla.lu(_rand((b, b), seed, np.float64))
    return (np.ascontiguousarray(l, dtype=dtype), _rand((m, b), seed + 1, dtype),
            _rand((b, bn), seed + 2, dtype), _rand((m, bn), seed + 3, dtype))


def _chol_operands(m, b, bn, dtype, seed=0):
    """lrow, l21, panel of a real step: the first b columns of L of an SPD
    matrix factored, the next bn columns still to update and factor."""
    g = _rand((b + m, b + m), seed, np.float64)
    a = g @ g.T + (b + m) * np.eye(b + m)
    l = np.linalg.cholesky(a)[:, :b]
    c = lambda x: np.ascontiguousarray(x, dtype=dtype)    # noqa: E731
    return c(l[b : b + bn]), c(l[b:]), c(a[b:, b : b + bn])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,b,bn", [(32, 16, 16), (45, 16, 8), (16, 8, 16),
                                    (1, 1, 1)])
def test_fused_lu_plain_matches_reference(dtype, m, b, bn):
    l11, l21, a1l, a2l = _lu_operands(m, b, bn, dtype)
    ref_u12, ref_packed, ref_piv = ref_fpu.fused_lu_panel_update_ref(
        *map(jnp.asarray, (l11, l21, a1l, a2l)))
    t = [torch.from_numpy(x.copy()) for x in (l11, l21, a1l, a2l)]
    u12, packed, piv = fpu.fused_lu_panel_update(*t)
    assert u12 is t[2] and packed is t[3]          # written in place
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(ref_piv))
    assert _rel(u12, ref_u12) < _tol(b, bn)
    assert _rel(packed, ref_packed) < _tol(m, bn)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,b,bn", [(32, 16, 16), (45, 16, 8), (8, 8, 8),
                                    (1, 1, 1)])
def test_fused_cholesky_plain_matches_reference(dtype, m, b, bn):
    lrow, l21, panel = _chol_operands(m, b, bn, dtype)
    ref = ref_fpu.fused_cholesky_panel_update_ref(
        *map(jnp.asarray, (lrow, l21, panel)))
    t = [torch.from_numpy(x.copy()) for x in (lrow, l21, panel)]
    out = fpu.fused_cholesky_panel_update(*t)
    assert out is t[2]
    assert float(torch.triu(out[:bn], 1).abs().max()) == 0.0
    assert _rel(out, ref) < _tol(m, bn)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_plain_versions_equal_the_composed_backend_ops(dtype):
    # the composed path of la (backend "cuda" on CPU tensors), bit for bit
    l11, l21, a1l, a2l = map(torch.from_numpy, _lu_operands(40, 16, 16, dtype))
    u12 = a1l.clone()
    ops.trsm(l11, u12, lower=True, unit_diagonal=True, out=u12)
    panel = ops.update(a2l.clone(), l21, u12)
    piv = ops.lu_panel(panel)
    got = fpu.fused_lu_panel_update(l11, l21, a1l.clone(), a2l.clone())
    assert torch.equal(got[0], u12) and torch.equal(got[1], panel)
    assert torch.equal(got[2], piv)

    lrow, l21, p = map(torch.from_numpy, _chol_operands(40, 16, 16, dtype))
    want = ops.update(p.clone(), l21, lrow.mT.contiguous())
    cholesky_panel(want, 16, "cuda")
    assert torch.equal(fpu.fused_cholesky_panel_update(lrow, l21, p.clone()),
                       want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,bn", [(40, 16), (3, 7), (1, 1)])
@pytest.mark.parametrize("unit", [False, True])
def test_trsm_right_plain_matches_reference(dtype, m, bn, unit):
    g = _rand((bn, bn), 4, np.float64)
    l = np.linalg.cholesky(g @ g.T + bn * np.eye(bn)).astype(dtype)
    b = _rand((m, bn), 5, dtype)
    ref = ref_kernels.trsm_right_lower_t(jnp.asarray(l), jnp.asarray(b),
                                         unit_diagonal=unit)
    got = trsm.trsm_right_lower_t(torch.from_numpy(l), torch.from_numpy(b),
                                  unit_diagonal=unit)
    assert _rel(got, ref) < _tol(m, bn, dtype)
    # the backend routes X·Lᵀ = B to the kernel wrapper, in place
    rhs = torch.from_numpy(b.copy())
    out = ops.trsm(torch.from_numpy(l), rhs, side="right", lower=True,
                   trans=True, unit_diagonal=unit, out=rhs)
    assert out is rhs and torch.equal(out, got)


def _chol_panel(m, nb, dtype, seed=6):
    """An m x nb panel of an SPD matrix's first block column."""
    g = _rand((m, m), seed, np.float64)
    a = g @ g.T + m * np.eye(m)
    return np.ascontiguousarray(a[:, :nb], dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(40, 16), (16, 16), (33, 7), (1, 1),
                                  (9, 1)])
def test_cholesky_panel_plain_matches_reference(dtype, m, nb):
    """The panel kernel's CPU path (its plain version) against the
    reference's jnp panel on the same inputs; lower, upper triangle of the
    top block zero."""
    panel = _chol_panel(m, nb, dtype)
    ref = ref_chol.cholesky_panel(jnp.asarray(panel), nb)
    t = torch.from_numpy(panel.copy())
    out = fpu.cholesky_panel(t, nb)
    assert out is t
    assert float(torch.triu(out[:nb], 1).abs().max()) == 0.0
    assert _rel(out, ref) < _tol(m, nb, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(40, 16), (16, 16), (33, 7)])
def test_cholesky_panel_cpu_is_bitwise_the_composed_panel(dtype, m, nb):
    """On the CPU the panel kernel's wrapper, and the registry's panel, give
    the bits of the ``"cuda"`` backend's composed panel (``cholesky_unblocked``
    and the right TRSM wrapper)."""
    panel = torch.from_numpy(_chol_panel(m, nb, dtype))
    want = cholesky_panel(panel.clone(), nb, "cuda")
    assert torch.equal(fpu.cholesky_panel(panel.clone(), nb), want)
    assert torch.equal(ops.PANEL_KERNELS["cholesky"](panel.clone(), nb,
                                                     "cuda"), want)
    assert torch.equal(fpu.cholesky_panel_plain(panel.clone(), nb), want)


def test_cholesky_panel_is_the_backends_panel_kernel():
    assert ops.PANEL_KERNELS["cholesky"] is fpu.cholesky_panel
    assert ops.KERNELS["cholesky_panel"] is fpu.cholesky_panel
    assert ops.CUDA_BACKEND.panel_fns["cholesky"] is fpu.cholesky_panel


def test_cpu_tensors_count_no_launch():
    ops.reset_launches()
    fpu.fused_lu_panel_update(*map(torch.from_numpy,
                                   _lu_operands(20, 8, 8, np.float64)))
    fpu.fused_cholesky_panel_update(*map(torch.from_numpy,
                                         _chol_operands(20, 8, 8, np.float64)))
    fpu.cholesky_panel(torch.from_numpy(_chol_panel(20, 8, np.float64)), 8)
    l = torch.eye(4, dtype=torch.float64)
    trsm.trsm_right_lower_t(l, torch.ones(6, 4, dtype=torch.float64))
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("call", ["lu_shape", "lu_dtype", "lu_stride",
                                  "chol_shape", "chol_short", "right_shape",
                                  "right_dtype", "panel_width", "panel_short",
                                  "panel_dtype", "panel_stride", "panel_dim"])
def test_wrappers_raise_on_bad_operands(call):
    l11, l21, a1l, a2l = map(torch.from_numpy,
                             _lu_operands(20, 8, 8, np.float64))
    lrow, c21, p = map(torch.from_numpy, _chol_operands(20, 8, 8, np.float64))
    calls = {
        "lu_shape": lambda: fpu.fused_lu_panel_update(l11, l21[:5], a1l, a2l),
        "lu_dtype": lambda: fpu.fused_lu_panel_update(l11.float(), l21, a1l,
                                                      a2l),
        "lu_stride": lambda: fpu.fused_lu_panel_update(l11.mT, l21, a1l, a2l),
        "chol_shape": lambda: fpu.fused_cholesky_panel_update(lrow, c21,
                                                              p[:, :4]),
        "chol_short": lambda: fpu.fused_cholesky_panel_update(
            lrow, c21[:5], p[:5]),
        "right_shape": lambda: trsm.trsm_right_lower_t(l11, a2l[:, :4]),
        "right_dtype": lambda: trsm.trsm_right_lower_t(l11, a2l.half()),
        "panel_width": lambda: fpu.cholesky_panel(p, 4),
        "panel_short": lambda: fpu.cholesky_panel(p[:5], 8),
        "panel_dtype": lambda: fpu.cholesky_panel(p.half(), 8),
        "panel_stride": lambda: fpu.cholesky_panel(p.mT, 20),
        "panel_dim": lambda: fpu.cholesky_panel(p[0], 8),
    }
    with pytest.raises(ValueError):
        calls[call]()
