"""The port's LU engine against the reference, on the CPU.

* Within the port, every schedule of the ``"cuda"`` backend (its plain
  kernel versions on the CPU) gives **bitwise** the same factors:
  la ≡ la2 ≡ la3 ≡ la_mb ≡ la_mb2 ≡ mtb ≡ rtm, as the reference promises
  for its own engine (la_mb's fused plain version is the composed path).
  The ``"torch"`` (library) backend is held to tolerance only.  (Factors
  against the reference's: ``tests/test_torch_solve.py``.)
* The engine issues its hooks in the reference's order: the traced span
  sequence equals the reference engine's, name for name.
* The composed one-gather ``laswp`` equals sequential row swaps, and the
  pivot helpers equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lu as ref_lu
from repro.core.backend import JNP_BACKEND
from repro.core.lookahead import get_variant as ref_get_variant
from repro.kernels import ref as ref_kernels
from repro.obs import tracer as ref_tracer
from repro_torch.core import lookahead, lu, pipeline
from repro_torch.kernels import fused_panel_update, ops
from repro_torch.obs import tracer
from repro_torch.solve import LUFactors, gesv, lu_factor

jax.config.update("jax_enable_x64", True)

DTYPES = (np.float32, np.float64)
REF_BACKEND = dataclasses.replace(
    JNP_BACKEND, panel_fns={"lu": jax.jit(ref_lu.lu_unblocked)})
SHAPES = [(48, 16), (50, 16), (7, 16), (1, 16), (40, [16, 8, 12])]


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b", SHAPES)
def test_cuda_backend_schedules_are_bitwise_equal(dtype, n, b):
    a = _rand((n, n), 0, dtype)
    base_lu, base_piv = lu.lu_blocked(a, b, device="cpu")
    for variant in ("rtm", "la", "la2", "la3", "la_mb", "la_mb2"):
        fac, piv = lookahead.get_variant("lu", variant)(a, b, device="cpu")
        assert torch.equal(fac, base_lu), variant
        assert torch.equal(piv, base_piv), variant


def test_torch_backend_schedules_agree_to_tolerance():
    a = _rand((50, 50), 2, np.float64)
    base, piv = lu.lu_blocked(a, 16, backend="torch", device="cpu")
    for variant in ("rtm", "la", "la2"):
        fac, p = lookahead.get_variant("lu", variant)(a, 16, backend="torch",
                                                      device="cpu")
        assert torch.equal(p, piv)
        assert _rel(fac, base) < _tol(50, np.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,nb", [(80, 16), (16, 16), (5, 8)])
def test_lu_unblocked_matches_reference(dtype, m, nb):
    panel = _rand((m, nb), 3, dtype)
    ref_packed, ref_piv = ref_lu.lu_unblocked(jnp.asarray(panel))
    work = torch.from_numpy(panel.copy())
    piv = lu.lu_unblocked(work)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(ref_piv))
    assert _rel(work, ref_packed) < _tol(m, dtype)


@pytest.mark.parametrize("piv", [[5, 3, 2, 3], [0, 1, 2], [7, 7, 7, 7],
                                 [9, 0, 4, 3, 8]])
def test_laswp_one_gather_equals_sequential_swaps(piv):
    a = _rand((12, 5), 4, np.float64)
    want = a.copy()
    for j, p in enumerate(piv):           # the swaps one at a time
        want[[j + 2, p + 2]] = want[[p + 2, j + 2]]
    got = torch.from_numpy(a.copy())
    lu.laswp(got, torch.tensor(piv, dtype=torch.int32), offset=2)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = ref_lu.laswp(jnp.asarray(a[2:]), jnp.asarray(piv, jnp.int32))
    np.testing.assert_array_equal(got.numpy()[2:], np.asarray(ref))


def test_permutation_and_unpack_match_reference():
    piv = np.array([3, 3, 5, 4, 4, 5], np.int32)
    perm = lu.permutation_from_pivots(torch.from_numpy(piv), 6)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(ref_lu.permutation_from_pivots(
            jnp.asarray(piv), 6)))
    a = _rand((6, 6), 5, np.float64)
    for got, ref in zip(lu.unpack_lu(torch.from_numpy(a)),
                        ref_lu.unpack_lu(jnp.asarray(a))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("variant", ["mtb", "la2", "la_mb", "la_mb2"])
def test_engine_issues_hooks_in_reference_order(variant):
    a = _rand((20, 20), 6, np.float64)
    # la_mb: the reference's composed fused oracle, not its Pallas kernel
    kw = {"fused_pu": ref_kernels.fused_lu_panel_update} \
        if variant.startswith("la_mb") else {}
    with ref_tracer.trace(fence=False) as ref_tr:
        # the reference's own panel, jitted through its panel_fns hook
        ref_get_variant("lu", variant)(jnp.asarray(a), [8, 4],
                                       backend=REF_BACKEND, **kw)
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant("lu", variant)(a, [8, 4], device="cpu")
    assert _span_keys(tr.spans) == _span_keys(ref_tr.spans)
    assert tr.by_cat("PF") and tr.total() >= 0.0
    fused = [s for s in tr.spans if s.meta.get("fused")]
    # widths 8, 4, 4, 4: one fused PU+PF per panel after the first
    assert len(fused) == (3 if variant.startswith("la_mb") else 0)


def test_tracer_span_math_with_a_fake_clock():
    ticks = iter(range(100))
    tr = tracer.Tracer(clock=lambda: float(next(ticks)))
    assert tr.wrap("PF", "PF(0)", lambda: 7, step=0, it=-1, depth=1) == 7
    tr.wrap("TU", "TU(0)", lambda: None, step=0, it=0)
    assert [s.dur for s in tr.spans] == [1.0, 1.0]
    assert tr.total("PF") == 1.0 and len(tr.by_cat("TU")) == 1
    assert tracer.active() is None
    with tracer.trace(tr) as inner:
        assert tracer.active() is inner
    assert tracer.active() is None


def test_tracing_is_bitwise_invisible():
    a = _rand((40, 40), 7, np.float64)
    plain = lu.lu_lookahead(a, 16, depth=2, device="cpu")
    with tracer.trace():
        traced = lu.lu_lookahead(a, 16, depth=2, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(plain, traced))


def test_variant_registry():
    for dmf in ("lu", "qrcp_local"):
        assert lookahead.list_variants(dmf) == ("mtb", "rtm", "la", "la2",
                                                "la_mb", "tuned")
    for dmf in ("cholesky", "qr"):
        assert lookahead.list_variants(dmf) == ("mtb", "rtm", "tiled", "la",
                                                "la2", "la_mb", "tuned")
    assert lookahead.list_variants("qrcp") == ("mtb", "rtm", "tuned")
    assert lookahead.parse_variant("la3") == ("la", 3)
    assert lookahead.parse_variant("la_mb2") == ("la_mb", 2)
    assert lookahead.parse_variant("mtb") == ("mtb", 1)
    assert lookahead.deepen("la", 2) == "la2"
    assert lookahead.deepen("la_mb", 2) == "la_mb2"
    assert lookahead.deepen("la", 1) == "la"
    with pytest.raises(ValueError):
        lookahead.deepen("mtb", 2)
    assert lookahead.get_variant("lu", "tuned").__name__ == "lu_tuned"
    assert lookahead.get_variant("cholesky", "tiled").__name__ == \
        "_cholesky_tiles"
    with pytest.raises(KeyError, match="not available"):
        lookahead.get_variant("lu", "tiled")
    with pytest.raises(KeyError, match="unknown DMF"):
        lookahead.get_variant("svd", "la")
    assert set(lookahead.FACTORIZATIONS) == {
        "lu", "cholesky", "qr", "ldlt", "gauss_jordan", "band_reduction",
        "qrcp", "qrcp_local", "hessenberg"}
    with pytest.raises(KeyError, match="excluded by policy"):
        lookahead.get_variant("qrcp", "la")
    with pytest.raises(KeyError):
        lookahead.get_variant("lu", "rtm2")
    with pytest.raises(ValueError, match="pins depth=2"):
        lookahead.get_variant("lu", "la2")(np.eye(4), 2, depth=3,
                                           device="cpu")


def test_engine_rejects_what_it_does_not_run():
    a = np.eye(4)
    with pytest.raises(TypeError, match="expects a torch.distributed"):
        pipeline.factorize(lu.LU_OPS, a, 2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="square"):
        lu.lu_blocked(np.ones((4, 3)), 2, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        lu.lu_lookahead(a, 2, depth=0, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        lu.lu_blocked(a, 2, backend="jnp", device="cpu")


@pytest.mark.parametrize("dmf", ["lu", "cholesky"])
@pytest.mark.parametrize("variant", ["la_mb", "la_mb2"])
def test_la_mb_resolves_the_fused_kernel_and_honours_an_explicit_one(
        dmf, variant):
    rng = np.random.default_rng(8)
    g = rng.standard_normal((24, 24))
    a = g @ g.T + 24 * np.eye(24) if dmf == "cholesky" else g
    calls = []
    plain = {"lu": fused_panel_update.fused_lu_panel_update_plain,
             "cholesky": fused_panel_update.fused_cholesky_panel_update_plain}

    def spy(*args):
        calls.append(args[-1].shape)
        return plain[dmf](*args)

    fn = lookahead.get_variant(dmf, variant)
    ops.reset_launches()
    base = fn(a, 8, device="cpu")          # backend "cuda": ops.FUSED_PU
    torch_be = fn(a, 8, backend="torch", device="cpu")
    spied = fn(a, 8, fused_pu=spy, device="cpu")
    # 3 panels: the fused PU runs for PF(1) and PF(2)
    assert calls == [(16, 8), (8, 8)]
    for x, y in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (base, spied))):
        assert torch.equal(x, y)
    assert type(torch_be) is type(base)
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)   # CPU: no launch
    with pytest.raises(ValueError, match="pins depth=2"):
        lookahead.get_variant(dmf, "la_mb2")(a, 8, depth=3, device="cpu")


def _ref_la(dmf_module, driver, a, b, **kw):
    return jax.jit(lambda x: getattr(dmf_module, driver)(
        x, b, **kw))(jnp.asarray(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_la_mb_matches_reference_la_mb(dtype):
    """The port's la_mb (computed at the input dtype) against the
    reference's, run without interpret-mode kernels:

    * its ``la`` on the jnp backend, at the input dtype throughout: within
      200·max(n,8)·eps of the input dtype, ipiv equal in f64;
    * its ``la_mb`` with the composed oracle ``ref.fused_lu_panel_update``
      (as ``tests/test_pipeline.py`` runs it): that oracle's GEMM is
      ``ref.gemm``, which accumulates in float32 whatever the input dtype,
      so the tolerance is at eps(f32); ipiv equal in f64;
    * its ``la_mb`` with the Pallas body's own f32 numerics
      (``fused_lu_panel_update_ref``): within the conformance tolerance
      (f32 effective)."""
    import conformance
    from repro.kernels import fused_panel_update as ref_fpu

    n, b = conformance.SHAPE_CLASSES["fused"][1:]
    a = _rand((n, n), 9, dtype)
    fac, piv = lookahead.get_variant("lu", "la_mb")(a, b, device="cpu")
    f32_tol = conformance.tolerance(conformance.Case(
        "lu", "la_mb", "jnp", np.dtype(dtype).name, "fused"))
    for fused, tol in ((None, _tol(n, dtype)),
                       (ref_kernels.fused_lu_panel_update, f32_tol),
                       (ref_fpu.fused_lu_panel_update_ref, f32_tol)):
        ref_fac, ref_piv = _ref_la(ref_lu, "lu_lookahead", a, b,
                                   fused_pu=fused, backend=REF_BACKEND)
        if dtype == np.float64 and fused is not ref_fpu.fused_lu_panel_update_ref:
            np.testing.assert_array_equal(piv.numpy(), np.asarray(ref_piv))
        assert _rel(fac, ref_fac) < tol
    conformance._check_lu(jnp.asarray(a), (jnp.asarray(fac.numpy()),
                                          jnp.asarray(piv.numpy())),
                          _tol(n, dtype), b, None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_inverse_matches_reference(dtype):
    from repro.solve.factors import LUFactors as RefLUFactors

    n, b = 30, 8
    a = _rand((n, n), 10, dtype)
    ref_lu_, ref_piv = jax.jit(lambda x: ref_lu.lu_blocked(
        x, b, backend=REF_BACKEND))(jnp.asarray(a))
    ref = RefLUFactors.from_packed(ref_lu_, ref_piv, block=b,
                                   backend=REF_BACKEND)
    port = LUFactors.from_numpy(np.asarray(ref_lu_), np.asarray(ref_piv),
                                block=b, device="cpu")
    inv = port.inverse()
    assert inv.shape == (n, n)
    assert _rel(inv, ref.inverse()) < _tol(n, dtype)
    assert _rel(a @ inv.numpy(), np.eye(n)) < _tol(n, dtype)


def test_gesv_la_mb_with_a_block_wider_than_256_matches_reference():
    """A block past 256 (the widest the card took before): the port's
    ``gesv`` la_mb against the reference's ``gesv`` la_mb, whose fused
    kernel computes in float32, so within 200·max(n,8)·eps(f32), the
    conformance tolerance of la_mb; and the port's la_mb factors bitwise
    its mtb's."""
    import repro.solve as ref_solve

    n, b = 320, 288
    a = _rand((n, n), 21, np.float64)
    rhs = _rand((n, 3), 22, np.float64)
    x = gesv(a, rhs, b, variant="la_mb", device="cpu")
    ref_x = ref_solve.gesv(jnp.asarray(a), jnp.asarray(rhs), b,
                           variant="la_mb")
    assert _rel(x, ref_x) < _tol(n, np.float32)
    fac = lu_factor(a, b, variant="la_mb", device="cpu")
    base = lu_factor(a, b, variant="mtb", device="cpu")
    assert torch.equal(fac.lu, base.lu) and torch.equal(fac.ipiv, base.ipiv)
