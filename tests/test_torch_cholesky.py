"""The port's Cholesky and ``posv`` against the reference's, on the CPU.

The same NumPy SPD inputs (the reference's ``_spd`` recipe,
``tests/conformance.py``) go through ``repro.core.cholesky`` /
``repro.solve`` (JAX on the CPU, jnp backend, factor and solve under one
``jax.jit`` per case) and ``repro_torch`` (``device="cpu"``: the ``"cuda"``
backend's plain kernel versions, and the ``"torch"`` library backend),
over mtb/rtm/la/la2/la_mb × f32/f64 × four shape classes.  Factors and
solutions agree within the reference's 200·max(n,8)·eps at the input dtype
(the port computes at the input dtype, la_mb included), and the
reference's own Cholesky contract check runs on the port's output.  The
reference's variants are bitwise equal to one another (its own
``tests/test_pipeline.py``), so it runs ``mtb`` once per dtype and shape.

Also here: the port's schedules bitwise equal to one another, la_mb
against the reference's la_mb, the engine's span order, and carrying a
factor across the two packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformance
import repro.solve as ref_solve
from repro.core import cholesky as ref_chol
from repro.core.lookahead import get_variant as ref_get_variant
from repro.kernels import fused_panel_update as ref_fpu
from repro.kernels import ref as ref_kernels
from repro.obs import tracer as ref_tracer
from repro.solve.factors import CholeskyFactors as RefCholeskyFactors
from repro_torch.core import cholesky, lookahead
from repro_torch.obs import tracer
from repro_torch.solve import CholeskyFactors, cholesky_factor, posv

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
VARIANTS = ("mtb", "rtm", "la", "la2", "la_mb")
#: shape class -> (n, block): one, small (n < b), ragged (n % b != 0), square
SHAPES = {"one": (1, 16), "small": (7, 16), "ragged": (50, 16),
          "square": (48, 16)}
NRHS = 3


def _spd(n, dtype, seed=0):
    """The reference's SPD recipe (``conformance._spd``), plus a RHS."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n)).astype(dtype)
    a = g @ g.T + n * np.eye(n, dtype=dtype)
    return a, rng.standard_normal((n, NRHS)).astype(dtype)


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


@functools.lru_cache(maxsize=None)
def _reference(dtype, shape):
    """The reference's factor object and solution, once per case."""
    n, b = SHAPES[shape]
    a, rhs = _spd(n, dtype)

    @jax.jit
    def factor_and_solve(a, rhs):
        fac = ref_solve.cholesky_factor(a, b, variant="mtb")
        return fac, fac.solve(rhs)

    fac, x = factor_and_solve(jnp.asarray(a), jnp.asarray(rhs))
    return fac, np.asarray(x)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_posv_matches_reference(variant, dtype, shape, backend):
    n, b = SHAPES[shape]
    a, rhs = _spd(n, dtype)
    ref, ref_x = _reference(dtype, shape)
    fac = cholesky_factor(a, b, variant=variant, backend=backend,
                          device="cpu")
    x = posv(a, rhs, b, variant=variant, backend=backend, device="cpu")
    assert torch.equal(x, fac.solve(rhs))
    tol = _tol(n, dtype)
    assert _rel(fac.l, ref.l) < tol
    assert _rel(x, ref_x) < tol
    conformance._check_cholesky(jnp.asarray(a), jnp.asarray(fac.l.numpy()),
                                tol, b, None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b", [(48, 16), (50, 16), (40, [16, 8, 12])])
def test_cuda_backend_schedules_are_bitwise_equal(dtype, n, b):
    a, _ = _spd(n, dtype, seed=1)
    base = cholesky.cholesky_blocked(a, b, device="cpu")
    for variant in ("rtm", "la", "la2", "la3", "la_mb", "la_mb2"):
        got = lookahead.get_variant("cholesky", variant)(a, b, device="cpu")
        assert torch.equal(got, base), variant


@pytest.mark.parametrize("variant", ["mtb", "rtm", "la", "la2", "la_mb"])
def test_cuda_backend_factors_each_panel_with_the_panel_kernel(monkeypatch,
                                                               variant):
    """The ``"cuda"`` backend's Cholesky PF is ``PANEL_KERNELS["cholesky"]``
    (the panel kernel's wrapper) for every panel of every variant (la_mb:
    the first; the fused update factors the others), and its factor is the
    PyTorch-op panel's (``panel_fn=cholesky_panel``) bit for bit."""
    from repro_torch.kernels import ops
    calls = []
    kernel = ops.PANEL_KERNELS["cholesky"]

    def counted(panel, nb, backend):
        calls.append(nb)
        return kernel(panel, nb, backend)

    monkeypatch.setitem(ops.PANEL_KERNELS, "cholesky", counted)
    a, _ = _spd(50, "float64", seed=3)
    got = lookahead.get_variant("cholesky", variant)(a, 16, device="cpu")
    assert calls == ([16] if variant == "la_mb" else [16, 16, 16, 2])
    want = cholesky.cholesky_blocked(a, 16, panel_fn=cholesky.cholesky_panel,
                                     device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb", [1, 5, 16])
def test_cholesky_unblocked_matches_reference(dtype, nb):
    a, _ = _spd(nb, dtype, seed=2)
    ref = ref_chol.cholesky_unblocked(jnp.asarray(a))
    got = cholesky.cholesky_unblocked(torch.from_numpy(a.copy()))
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    assert _rel(got, ref) < _tol(nb, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cholesky_la_mb_matches_reference_la_mb(dtype):
    """As the LU test of ``test_torch_lu.py``: against the reference's
    ``la`` at the input dtype, against its composed oracle
    ``ref.fused_cholesky_panel_update`` (whose ``ref.gemm`` accumulates in
    float32, so at eps(f32)), and against the Pallas body's own f32
    numerics ``fused_cholesky_panel_update_ref`` (conformance tolerance)."""
    n, b = conformance.SHAPE_CLASSES["fused"][1:]
    a, _ = _spd(n, dtype, seed=3)
    l = lookahead.get_variant("cholesky", "la_mb")(a, b, device="cpu")
    f32_tol = conformance.tolerance(conformance.Case(
        "cholesky", "la_mb", "jnp", dtype, "fused"))
    for fused, tol in ((None, _tol(n, dtype)),
                       (ref_kernels.fused_cholesky_panel_update, f32_tol),
                       (ref_fpu.fused_cholesky_panel_update_ref, f32_tol)):
        ref_l = jax.jit(lambda x: ref_chol.cholesky_lookahead(
            x, b, fused_pu=fused))(jnp.asarray(a))
        assert _rel(l, ref_l) < tol
    conformance._check_cholesky(jnp.asarray(a), jnp.asarray(l.numpy()),
                                _tol(n, dtype), b, None)


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("variant", ["mtb", "rtm", "la2", "la_mb", "la_mb2"])
def test_engine_issues_hooks_in_reference_order(variant):
    a, _ = _spd(20, np.float64, seed=4)
    kw = {"fused_pu": ref_kernels.fused_cholesky_panel_update} \
        if variant.startswith("la_mb") else {}
    with ref_tracer.trace(fence=False) as ref_tr:
        ref_get_variant("cholesky", variant)(jnp.asarray(a), [8, 4], **kw)
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant("cholesky", variant)(a, [8, 4], device="cpu")
    assert _span_keys(tr.spans) == _span_keys(ref_tr.spans)


@pytest.mark.parametrize("dtype", DTYPES)
def test_factors_solve_logdet_inverse_match_reference(dtype):
    n, b = SHAPES["square"]
    a, rhs = _spd(n, dtype)
    ref, ref_x = _reference(dtype, "square")
    fac = cholesky_factor(a, b, variant="la_mb", device="cpu")
    tol = _tol(n, dtype)
    assert _rel(fac.solve(rhs), ref_x) < tol
    xv = fac.solve(rhs[:, 0])
    assert xv.shape == (n,) and _rel(xv, ref_x[:, 0]) < tol
    assert torch.equal(fac.solve(rhs, trans=True), fac.solve(rhs))
    sign, logdet = fac.logdet()
    ref_sign, ref_logdet = jax.jit(lambda f: f.logdet())(ref)
    assert float(sign) == float(ref_sign) == 1.0
    assert abs(float(logdet) - float(ref_logdet)) < tol * abs(float(ref_logdet))
    ref_inv = jax.jit(lambda f: f.inverse())(ref)
    assert _rel(fac.inverse(), ref_inv) < tol
    with pytest.raises(ValueError, match="rhs rows"):
        fac.solve(rhs[:5])


@pytest.mark.parametrize("dtype", DTYPES)
def test_factors_carry_across_the_two_packages(dtype):
    n, b = SHAPES["square"]
    a, rhs = _spd(n, dtype)
    ref, ref_x = _reference(dtype, "square")
    port = CholeskyFactors.from_numpy(np.asarray(ref.l), block=b,
                                      device="cpu")
    np.testing.assert_array_equal(port.to_numpy(), np.asarray(ref.l))
    assert _rel(port.solve(rhs), ref_x) < _tol(n, dtype)
    back = RefCholeskyFactors(l=jnp.asarray(
        cholesky_factor(a, b, device="cpu").to_numpy()), block=b)
    assert _rel(jax.jit(lambda f, r: f.solve(r))(back, jnp.asarray(rhs)),
                ref_x) < _tol(n, dtype)


def test_inputs_are_copied_and_checked():
    a, rhs = _spd(20, "float64", seed=5)
    a0 = a.copy()
    posv(a, rhs, 8, device="cpu")
    posv(torch.from_numpy(a), torch.from_numpy(rhs), 8, variant="la_mb",
         device="cpu")
    np.testing.assert_array_equal(a, a0)
    with pytest.raises(ValueError, match="square"):
        cholesky_factor(np.ones((4, 3)), 2, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        cholesky.cholesky_lookahead(a, 8, depth=0, device="cpu")


def test_posv_la_mb_with_a_block_wider_than_256_matches_reference():
    """As the LU test of ``test_torch_lu.py``: ``posv`` la_mb at a block past
    256 against the reference's ``posv`` la_mb (its fused kernel computes in
    float32: 200·max(n,8)·eps(f32)); the port's la_mb factor bitwise its
    mtb's."""
    n, b = 320, 288
    a, rhs = _spd(n, "float64", seed=23)
    x = posv(a, rhs, b, variant="la_mb", device="cpu")
    ref_x = ref_solve.posv(jnp.asarray(a), jnp.asarray(rhs), b,
                           variant="la_mb")
    assert _rel(x, ref_x) < _tol(n, "float32")
    fac = cholesky_factor(a, b, variant="la_mb", device="cpu")
    base = cholesky_factor(a, b, variant="mtb", device="cpu")
    assert torch.equal(fac.l, base.l)
