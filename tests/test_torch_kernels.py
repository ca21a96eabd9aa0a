"""The port's kernel modules against the reference Pallas kernels, on the CPU.

On CPU tensors every kernel wrapper of ``repro_torch.kernels`` runs its
plain PyTorch version — the same algorithm and accumulation order as the
CUDA kernel, which ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
it against on the card.  Here the plain versions meet the reference's
Pallas kernels, run as the reference's own tests run them (interpret mode
on the CPU).  The Pallas kernels accumulate in float32 whatever the input
dtype, so the tolerance is the reference's 200·max(m,n,8)·eps at float32;
GETF2 pivots must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from repro.core import blocking as ref_blocking
from repro.core.backend import trsm_jnp
from repro.kernels import ops as ref_ops
from repro.kernels.trsm import trsm_left_lower
from repro_torch.core import blocking
from repro_torch.kernels import blis_gemm, ops, panel_lu, trsm

jax.config.update("jax_enable_x64", True)

DTYPES = (np.float32, np.float64)


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(m, n):
    """Pallas-reference tolerance: the reference kernels compute in f32."""
    return 200.0 * max(m, n, 8) * float(np.finfo(np.float32).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _lu_factors(n, seed, dtype):
    """Unit-lower L and upper U of a random matrix: well-scaled triangles."""
    _, l, u = sla.lu(_rand((n, n), seed, np.float64))
    return (np.ascontiguousarray(l, dtype=dtype),
            np.ascontiguousarray(u, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(33, 16, 20), (1, 1, 1)])
def test_gemm_accum_plain_matches_pallas(dtype, m, k, n):
    c, a, b = _rand((m, n), 1, dtype), _rand((m, k), 2, dtype), \
        _rand((k, n), 3, dtype)
    ref = ref_ops.gemm_accum(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b))
    got = blis_gemm.gemm_accum(torch.from_numpy(c), torch.from_numpy(a),
                               torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(c).dtype
    assert _rel(got, ref) < _tol(m, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(40, 24, 17)])
def test_gemm_plain_matches_pallas(dtype, m, k, n):
    a, b = _rand((m, k), 4, dtype), _rand((k, n), 5, dtype)
    ref = ref_ops.gemm(jnp.asarray(a), jnp.asarray(b))
    got = ops.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got, ref) < _tol(m, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,w", [(16, 40), (1, 3)])
@pytest.mark.parametrize("unit", [True, False])
def test_trsm_lower_plain_matches_pallas(dtype, nb, w, unit):
    l, _ = _lu_factors(nb, 6, dtype)
    if not unit:
        l = l + np.diag(1.0 + np.abs(_rand((nb,), 7, dtype))).astype(dtype)
    b = _rand((nb, w), 8, dtype)
    ref = trsm_left_lower(jnp.asarray(l), jnp.asarray(b),
                          unit_diagonal=unit, interpret=True)
    got = trsm.trsm(torch.from_numpy(l), torch.from_numpy(b), lower=True,
                    unit_diagonal=unit)
    assert _rel(got, ref) < _tol(nb, w)


def test_trsm_chain_refuses_a_cpu_tensor():
    # the kernels' rounding contract is a check on the card, never a route
    t = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device only"):
        trsm.trsm_chain(t, torch.ones(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="lower L only"):
        trsm.trsm_chain(t, torch.ones(2, 4, dtype=torch.float64),
                        lower=False, right=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("unit", [True, False])
def test_trsm_upper_plain_matches_trsm_jnp(dtype, unit):
    # the reference sends upper solves to its library path, trsm_jnp
    _, u = _lu_factors(24, 9, dtype)
    b = _rand((24, 10), 10, dtype)
    ref = trsm_jnp(jnp.asarray(u), jnp.asarray(b), lower=False,
                   unit_diagonal=unit)
    got = trsm.trsm(torch.from_numpy(u), torch.from_numpy(b), lower=False,
                    unit_diagonal=unit)
    eps = float(np.finfo(dtype).eps)
    assert _rel(got, ref) < 200.0 * max(24, 10, 8) * eps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(40, 16), (9, 4), (1, 1)])
def test_lu_panel_plain_matches_pallas(dtype, m, nb):
    panel = _rand((m, nb), 11, dtype)
    ref_packed, ref_piv = ref_ops.lu_panel(jnp.asarray(panel))
    work = torch.from_numpy(panel.copy())
    piv = panel_lu.lu_panel(work)
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(ref_piv))
    assert _rel(work, ref_packed) < _tol(m, nb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nrhs", [(32, 33), (1, 1)])
def test_lu_solve_small_plain_matches_pallas(dtype, n, nrhs):
    lu = np.ascontiguousarray(
        sla.lu_factor(_rand((n, n), 12, np.float64))[0], dtype=dtype)
    b = _rand((n, nrhs), 13, dtype)
    ref = ref_ops.lu_solve_small(jnp.asarray(lu), jnp.asarray(b))
    got = ops.lu_solve_small(torch.from_numpy(lu), torch.from_numpy(b))
    assert _rel(got, ref) < _tol(n, nrhs)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    a = torch.from_numpy(_rand((12, 12), 14, np.float64))
    ops.reset_launches()
    ops.update(a[4:, 4:], a[4:, :4], a[:4, 4:])
    ops.trsm(a[:4, :4], a[:4, 4:], lower=True, unit_diagonal=True)
    ops.lu_panel(a[:, :4])
    ops.lu_solve_small(a, a[:, :2])
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)


def test_update_and_trsm_write_in_place():
    a = _rand((20, 20), 15, np.float64)
    t = torch.from_numpy(a.copy())
    want = a[8:, 8:] - a[8:, :8] @ a[:8, 8:]
    out = ops.update(t[8:, 8:], t[8:, :8], t[:8, 8:])
    assert out.data_ptr() == t[8:, 8:].data_ptr()
    np.testing.assert_allclose(t[8:, 8:].numpy(), want, rtol=1e-12,
                               atol=1e-12)
    l, _ = _lu_factors(8, 16, np.float64)
    rhs = torch.from_numpy(_rand((8, 5), 17, np.float64))
    want = sla.solve_triangular(l, rhs.numpy(), lower=True,
                                unit_diagonal=True)
    ops.trsm(torch.from_numpy(l), rhs, lower=True, unit_diagonal=True,
             out=rhs)
    np.testing.assert_allclose(rhs.numpy(), want, rtol=1e-12, atol=1e-12)


def test_backend_trsm_library_cases_match_trsm_jnp():
    # transposed and right-side solves go to the library, as in the
    # reference — except X·Lᵀ = B (right, lower, transposed), which goes to
    # the right TRSM kernel's wrapper (here its plain version)
    l, u = _lu_factors(10, 18, np.float64)
    b = _rand((10, 10), 19, np.float64)
    for t, lower in ((l, True), (u, False)):
        for side in ("left", "right"):
            for trans in (False, True):
                ref = trsm_jnp(jnp.asarray(t), jnp.asarray(b), side=side,
                               lower=lower, trans=trans)
                got = ops.trsm(torch.from_numpy(t), torch.from_numpy(b),
                               side=side, lower=lower, trans=trans)
                assert _rel(got, ref) < 1e-12, (lower, side, trans)


@pytest.mark.parametrize("call", ["gemm_stride", "gemm_shape", "gemm_dtype",
                                  "trsm_shape", "panel_dtype", "panel_rank"])
def test_wrappers_raise_on_bad_operands(call):
    a = torch.from_numpy(_rand((6, 6), 20, np.float64))
    calls = {
        "gemm_stride": lambda: ops.gemm(a.mT, a),
        "gemm_shape": lambda: ops.gemm(a, a[:4]),
        "gemm_dtype": lambda: ops.gemm(a, a.float()),
        "trsm_shape": lambda: ops.trsm(a, a[:4]),
        "panel_dtype": lambda: ops.lu_panel(a.to(torch.bfloat16)),
        "panel_rank": lambda: ops.lu_panel(a[0]),
    }
    with pytest.raises(ValueError):
        calls[call]()


@pytest.mark.parametrize("n,b", [(48, 16), (50, 16), (7, 16), (1, 16),
                                 (100, [48, 32, 16]), (64, (8,))])
def test_blocking_copy_matches_reference(n, b):
    assert blocking.expand_schedule(n, b) == ref_blocking.expand_schedule(n, b)
    assert list(blocking.panel_steps(n, b)) == \
        [tuple(s) for s in ref_blocking.panel_steps(n, b)]
    assert blocking.max_width(b) == ref_blocking.max_width(b)
    assert blocking.split_trailing(16, 8, n) == \
        ref_blocking.split_trailing(16, 8, n)
