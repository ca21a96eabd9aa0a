"""The port's LDLᵀ, Gauss–Jordan inversion and band reduction against the
reference's, on the CPU.

The same NumPy inputs (the reference's recipes: quasi-definite symmetric
for LDLᵀ, SPD for Gauss–Jordan, Gaussian for band reduction) go through
``repro.core`` (JAX on the CPU, jnp backend, one ``jax.jit`` per case) and
``repro_torch`` (``device="cpu"``: the ``"cuda"`` backend's plain kernel
versions, and the ``"torch"`` library backend), over every variant ×
f32/f64.  Outputs agree within the reference's 200·max(n,8)·eps at the
input dtype; the reference's variants agree with one another
(``tests/test_core_ldlt_gj_band.py``), so it runs ``mtb`` once per case.

Also here: the port's schedules bitwise equal to ``mtb`` under ``"cuda"``,
the engine's hook order (the epilogue of a two-sided DMF included) against
a stub and against the reference's traced spans, Gauss–Jordan's update
against a row-block alias, the drivers ``ldlt_factor`` and
``getri(method="gj")`` against the reference's, and carrying an LDLᵀ
factor across the two packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solve as ref_solve
from repro.core import band_reduction as ref_band
from repro.core import gauss_jordan as ref_gj
from repro.core import ldlt as ref_ldlt
from repro.core.backend import JNP_BACKEND
from repro.core.lookahead import get_variant as ref_get_variant
from repro.obs import tracer as ref_tracer
from repro.solve.factors import LDLTFactors as RefLDLTFactors
from repro_torch.core import band_reduction, gauss_jordan, ldlt, lookahead, \
    pipeline
from repro_torch.core.backend import TORCH_BACKEND
from repro_torch.kernels import ops
from repro_torch.obs import tracer
from repro_torch.solve import LDLTFactors, getri, ldlt_factor

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
BACKENDS = ("cuda", "torch")
#: DMF -> (n, block): ragged panels for the engine's DMFs; band reduction
#: needs n % w == 0
SHAPES = {"ldlt": (50, 16), "gauss_jordan": (64, 16),
          "band_reduction": (48, 16)}
VARIANTS = {"ldlt": ("mtb", "la", "la2", "la_mb"),
            "gauss_jordan": ("mtb", "la", "la2", "la_mb"),
            "band_reduction": ("mtb", "la", "la_mb")}
NRHS = 3


def _quasi_definite(n, dtype, seed=0):
    """Symmetric, diagonally dominant, indefinite (``conformance``'s)."""
    g = np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)
    signs = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    return (g + g.T) / 2 + np.diag(signs * 2.0 * n).astype(dtype)


def _spd(n, dtype, seed=0):
    g = np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)
    return g @ g.T + n * np.eye(n, dtype=dtype)


def _input(dmf, dtype, seed=0):
    n, _ = SHAPES[dmf]
    if dmf == "ldlt":
        return _quasi_definite(n, dtype, seed)
    if dmf == "gauss_jordan":
        return _spd(n, dtype, seed)
    return np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


_REF_DRIVERS = {"ldlt": ref_ldlt.ldlt_blocked,
                "gauss_jordan": ref_gj.gj_inverse_blocked,
                "band_reduction": ref_band.band_reduction_blocked}


@functools.lru_cache(maxsize=None)
def _reference(dmf, dtype):
    _, b = SHAPES[dmf]
    fn = _REF_DRIVERS[dmf]
    return np.asarray(jax.jit(lambda x: fn(x, b))(
        jnp.asarray(_input(dmf, dtype))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf,variant", [(d, v) for d in VARIANTS
                                         for v in VARIANTS[d]])
def test_port_matches_reference(dmf, variant, dtype, backend):
    n, b = SHAPES[dmf]
    got = lookahead.get_variant(dmf, variant)(_input(dmf, dtype), b,
                                              backend=backend, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, n)
    assert _rel(got, _reference(dmf, dtype)) < _tol(n, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf", list(VARIANTS))
def test_cuda_backend_schedules_are_bitwise_mtb(dmf, dtype):
    n, b = SHAPES[dmf]
    a = _input(dmf, dtype, seed=1)
    base = lookahead.get_variant(dmf, "mtb")(a, b, device="cpu")
    deeper = ("la3",) if dmf != "band_reduction" else ()
    for variant in VARIANTS[dmf][1:] + deeper:
        got = lookahead.get_variant(dmf, variant)(a, b, device="cpu")
        assert torch.equal(got, base), variant
    # a block schedule, and a block wider than the matrix
    if dmf != "band_reduction":
        for blk in ([16, 8, 12], 80):
            base = lookahead.get_variant(dmf, "mtb")(a, blk, device="cpu")
            for variant in ("la", "la2"):
                got = lookahead.get_variant(dmf, variant)(a, blk,
                                                          device="cpu")
                assert torch.equal(got, base), (variant, blk)


@pytest.mark.parametrize("dmf", list(VARIANTS))
def test_torch_backend_schedules_agree_to_tolerance(dmf):
    n, b = SHAPES[dmf]
    a = _input(dmf, "float64", seed=2)
    base = lookahead.get_variant(dmf, "mtb")(a, b, backend="torch",
                                             device="cpu")
    for variant in VARIANTS[dmf][1:]:
        got = lookahead.get_variant(dmf, variant)(a, b, backend="torch",
                                                  device="cpu")
        assert _rel(got, base) < _tol(n, np.float64), variant


@pytest.mark.parametrize("dtype", DTYPES)
def test_unblocked_sweeps_match_reference(dtype):
    a = _quasi_definite(16, dtype, 3)
    got = ldlt.ldlt_unblocked(torch.from_numpy(a.copy()))
    assert _rel(got, ref_ldlt.ldlt_unblocked(jnp.asarray(a))) \
        < _tol(16, dtype)
    s = _spd(16, dtype, 4)
    got = gauss_jordan.gj_inverse_unblocked(torch.from_numpy(s.copy()))
    assert _rel(got, ref_gj.gj_inverse_unblocked(jnp.asarray(s))) \
        < _tol(16, dtype)
    # the LDLᵀ panel: diagonal block and the solve below it
    panel = np.concatenate([a, np.random.default_rng(5).standard_normal(
        (20, 16)).astype(dtype)])
    ref = ref_ldlt.ldlt_panel(jnp.asarray(panel), 16)
    for backend in BACKENDS:
        got = ldlt.ldlt_panel(torch.from_numpy(panel.copy()), 16, backend)
        assert _rel(got, ref) < _tol(36, dtype)


def test_ldlt_of_the_quasi_definite_input_has_d_of_both_signs():
    _, d = ldlt.unpack_ldlt(ldlt.ldlt_blocked(_quasi_definite(48, "float64"),
                                              16, device="cpu"))
    assert float(d.min()) < 0 < float(d.max())
    ref_l, ref_d = ref_ldlt.unpack_ldlt(jnp.asarray(_reference(
        "ldlt", "float64")))
    l, d = ldlt.unpack_ldlt(torch.tensor(_reference("ldlt", "float64")))
    np.testing.assert_array_equal(l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))


@pytest.mark.parametrize("backend", BACKENDS)
def test_gauss_jordan_applied_twice_gives_back_a(backend):
    a = _spd(48, "float64", 11)
    inv = gauss_jordan.gj_inverse_blocked(a, 16, backend=backend,
                                          device="cpu")
    twice = gauss_jordan.gj_inverse_lookahead(inv, 16, backend=backend,
                                              device="cpu")
    assert _rel(twice, a) < 1e-10


def _row_block_backend():
    """The plain backend with an update that writes its rows 8 at a time,
    each block reading B as it then stands — a tiled in-place kernel with
    no alias check.  Where B aliases rows of C, later blocks read rows the
    earlier ones already wrote."""
    def update(c, a, b):
        for r in range(0, c.shape[0], 8):
            c[r : r + 8] -= a[r : r + 8] @ b
        return c
    return dataclasses.replace(TORCH_BACKEND, name="row_blocks",
                               update=update)


@pytest.mark.parametrize("variant", ["mtb", "la", "la2"])
def test_gauss_jordan_update_copies_the_row_block_it_reads(variant):
    """Each update reads ``A[kr, c0:c1]`` while it writes ``A[:, c0:c1]``:
    the hook copies that row block first, so an update that writes as it
    goes still inverts A."""
    a = _spd(48, "float64", 12)
    inv = lookahead.get_variant("gauss_jordan", variant)(
        a, 16, backend=_row_block_backend(), device="cpu")
    ref = lookahead.get_variant("gauss_jordan", variant)(
        a, 16, backend="torch", device="cpu")
    assert _rel(inv, ref) < _tol(48, np.float64)
    assert _rel(a @ inv.numpy(), np.eye(48)) < _tol(48, np.float64)


def test_band_reduction_refuses_a_ragged_width():
    for n, w in ((33, 8), (48, [16, 8]), (96, [128])):
        for variant in ("mtb", "la"):
            with pytest.raises(ValueError, match="band reduction requires"):
                lookahead.get_variant("band_reduction", variant)(
                    np.eye(n), w, device="cpu")
    with pytest.raises(ValueError, match="square"):
        band_reduction.band_reduction_blocked(np.ones((8, 16)), 8,
                                              device="cpu")
    band_reduction.check_uniform_tiling(48, [16, 16])


def test_band_reduction_takes_the_backends_qr_panel():
    """No ``panel_fn``: ``backend.panel_fns["qr"]`` (on ``"cuda"`` the QR
    panel kernel's wrapper, here its plain version) factors both panels of
    every step; ``"torch"`` has no registry and runs the plain GEQR2."""
    n, w = SHAPES["band_reduction"]
    a = _input("band_reduction", "float64")
    calls = []
    kernel = ops.PANEL_KERNELS["qr"]

    def spy(panel):
        calls.append(tuple(panel.shape))
        return kernel(panel)

    be = dataclasses.replace(ops.CUDA_BACKEND,
                             panel_fns={**ops.PANEL_KERNELS, "qr": spy})
    got = band_reduction.band_reduction_lookahead(a, w, backend=be,
                                                  device="cpu")
    assert calls == [(48, 16), (32, 16), (32, 16), (16, 16), (16, 16)]
    assert torch.equal(got, band_reduction.band_reduction_blocked(
        a, w, device="cpu"))
    i, j = np.indices((n, n))
    assert float(got[torch.from_numpy((j < i) | (j > i + w))].abs().max()) \
        == 0.0


def test_la2_on_band_reduction_raises_the_reason():
    for variant in ("la2", "la_mb2"):
        with pytest.raises(KeyError, match="two coupled panels"):
            lookahead.get_variant("band_reduction", variant)
    assert lookahead.list_variants("band_reduction") == ("mtb", "la",
                                                         "la_mb")
    with pytest.raises(KeyError, match="defines the output"):
        lookahead.get_variant("band_reduction", "tuned")
    for dmf in ("ldlt", "gauss_jordan"):
        assert lookahead.list_variants(dmf) == ("mtb", "la", "la2", "la_mb",
                                                "tuned")
        with pytest.raises(KeyError, match="not available"):
            lookahead.get_variant(dmf, "rtm")
        assert callable(lookahead.get_variant(dmf, "tuned"))
        with pytest.raises(KeyError, match="not available"):
            lookahead.get_variant(dmf, "tiled")


@functools.lru_cache(maxsize=None)
def _reference_ldlt_factor(dtype):
    """The reference's ``ldlt_factor`` (``la``) with its solve, inverse and
    logdet, under one ``jax.jit``."""
    _, b = SHAPES["ldlt"]

    @jax.jit
    def run(a, rhs):
        fac = ref_solve.ldlt_factor(a, b)
        return fac.packed, fac.solve(rhs), fac.inverse(), fac.logdet()

    return run(jnp.asarray(_input("ldlt", dtype)), jnp.asarray(_rhs(dtype)))


def _rhs(dtype):
    n, _ = SHAPES["ldlt"]
    return np.random.default_rng(6).standard_normal((n, NRHS)).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["mtb", "la2"])
def test_ldlt_factor_solve_logdet_inverse_match_reference(dtype, variant):
    n, b = SHAPES["ldlt"]
    a, rhs = _input("ldlt", dtype), _rhs(dtype)
    packed, ref_x, ref_inv, (ref_sign, ref_logabs) = \
        _reference_ldlt_factor(dtype)
    for backend in BACKENDS:
        fac = ldlt_factor(a, b, variant=variant, backend=backend,
                          device="cpu")
        assert _rel(fac.packed, packed) < _tol(n, dtype)
        assert _rel(fac.solve(rhs), ref_x) < _tol(n, dtype)
        assert _rel(fac.solve(rhs[:, 0]), np.asarray(ref_x)[:, 0]) \
            < _tol(n, dtype)
        assert _rel(fac.inverse(), ref_inv) < _tol(n, dtype)
        sign, logabs = fac.logdet()
        assert float(sign) == float(ref_sign)
        assert abs(float(logabs) - float(ref_logabs)) \
            < _tol(n, dtype) * abs(float(ref_logabs))


def test_ldlt_factors_cross_the_packages():
    n, b = SHAPES["ldlt"]
    packed = _reference("ldlt", "float64")
    rhs = np.random.default_rng(7).standard_normal((n, NRHS))
    port = LDLTFactors.from_numpy(packed, block=b, device="cpu")
    ref = RefLDLTFactors(packed=jnp.asarray(packed), block=b)
    assert _rel(port.solve(rhs), ref.solve(jnp.asarray(rhs))) \
        < _tol(n, np.float64)
    back = RefLDLTFactors(packed=jnp.asarray(port.to_numpy()), block=b)
    np.testing.assert_array_equal(np.asarray(back.packed), packed)


@pytest.mark.parametrize("dtype", DTYPES)
def test_getri_gauss_jordan_matches_reference(dtype):
    n, b = SHAPES["gauss_jordan"]
    a = _input("gauss_jordan", dtype)
    ref = np.asarray(jax.jit(lambda x: ref_solve.getri(x, b, method="gj"))(
        jnp.asarray(a)))
    for variant in ("mtb", "la", "la2"):
        for backend in BACKENDS:
            inv = getri(a, b, variant=variant, backend=backend, method="gj",
                        device="cpu")
            assert _rel(inv, ref) < _tol(n, dtype), (variant, backend)
    lu_inv = getri(a, b, device="cpu")
    assert _rel(inv, lu_inv) < _tol(n, dtype)
    with pytest.raises(ValueError, match="method"):
        getri(a, b, method="qr", device="cpu")


def _inv_residual(a, x):
    """‖A·X − I‖₁ / (‖A‖₁·‖X‖₁·n·eps)."""
    a, x = np.asarray(a, np.float64), np.asarray(x, np.float64)
    n = a.shape[0]
    return float(np.linalg.norm(a @ x - np.eye(n), 1) / (
        np.linalg.norm(a, 1) * np.linalg.norm(x, 1) * n
        * np.finfo(np.float64).eps))


@pytest.mark.parametrize("scale", [1 / 256, 1.0, 16.0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_gauss_jordan_residual_is_the_reference_formulations(scale, backend):
    """The blocked sweep forms the panel's own rows as
    ``A[kr, :] − (I − D⁻¹)·A[kr, :]``, as the reference does, so their
    rounding follows ``|A[kr, :]|``, about ``|D|`` times the result's, and
    the right residual grows with the input's scale.  The port's residual
    is the reference's at every scale: the gap to an LU-based inverse is
    the formulation's, not the port's."""
    n, b = 128, 32
    a = _spd(n, "float64", 13) * scale     # diagonal about 2n·scale
    ref = np.asarray(jax.jit(lambda x: ref_gj.gj_inverse_blocked(x, b))(
        jnp.asarray(a)))
    got = gauss_jordan.gj_inverse_blocked(a, b, backend=backend,
                                          device="cpu")
    ref_res, got_res = _inv_residual(a, ref), _inv_residual(a, got)
    lu_res = _inv_residual(a, np.linalg.inv(a))
    if scale < 1:      # a diagonal of order 1: both as accurate as LU
        assert max(got_res, ref_res) < 10 * lu_res, (got_res, ref_res,
                                                      lu_res)
    else:
        assert 0.5 < got_res / ref_res < 2.0, (got_res, ref_res)
        assert got_res > 100 * scale * lu_res, (got_res, lu_res)


# ---------------------------------------------------------------------------
# The engine's hook order.
# ---------------------------------------------------------------------------
def _stub(calls, *, bulk):
    def factor(state, st, backend, panel_fn):
        calls.append(("PF", st.k))
        return state, st.k

    def update(state, ctx, st, c0, c1, backend):
        calls.append(("TU", ctx, c0, c1))
        return state

    def update_left(state, ctx, st, backend):
        calls.append(("LEFT", ctx))
        return state

    def commit(state, ctx, st, backend):
        calls.append(("COMMIT", ctx))
        return state

    def update_all(state, ctx, st, backend):
        calls.append(("ALL", ctx))
        return state

    return pipeline.StepOps(name="stub", init=lambda a: (a, None),
                            factor=factor, update=update,
                            finalize=lambda state: state[0],
                            update_left=update_left, commit=commit,
                            update_all=update_all if bulk else None)


@pytest.mark.parametrize("variant,depth,bulk,want", [
    ("la", 1, True, [
        ("PF", 0),
        ("TU", 0, 4, 8), ("PF", 4), ("TU", 0, 8, 12), ("COMMIT", 0),
        ("TU", 4, 8, 12), ("PF", 8), ("LEFT", 4), ("COMMIT", 4),
        ("LEFT", 8), ("COMMIT", 8)]),
    ("la", 2, True, [
        ("PF", 0),
        ("TU", 0, 4, 8), ("PF", 4), ("TU", 0, 8, 12), ("COMMIT", 0),
        ("TU", 4, 8, 12), ("PF", 8), ("LEFT", 4), ("COMMIT", 4),
        ("LEFT", 8), ("COMMIT", 8)]),
    ("mtb", 1, True, [("PF", 0), ("ALL", 0), ("PF", 4), ("ALL", 4),
                      ("PF", 8), ("ALL", 8)]),
    ("mtb", 1, False, [
        ("PF", 0), ("TU", 0, 4, 12), ("COMMIT", 0),
        ("PF", 4), ("TU", 4, 8, 12), ("LEFT", 4), ("COMMIT", 4),
        ("PF", 8), ("LEFT", 8), ("COMMIT", 8)]),
])
def test_engine_runs_the_epilogue_after_every_iteration(variant, depth, bulk,
                                                        want):
    """PF, PU, PF(k+1), TU, then EPI (update_left from the second panel,
    commit) — the last panel's epilogue too, which look-ahead reaches
    through its early exit."""
    calls = []
    with tracer.trace(fence=False) as tr:
        pipeline.factorize(_stub(calls, bulk=bulk), np.zeros((12, 12)), 4,
                           variant=variant, depth=depth, device="cpu")
    assert calls == want
    epi = [s.name for s in tr.by_cat("EPI")]
    assert epi == ([] if bulk and variant == "mtb"
                   else ["EPI(0)", "EPI(1)", "EPI(2)"])
    assert "EPI" in tracer.CATEGORIES


_REF_LDLT_PANEL = jax.jit(ref_ldlt.ldlt_panel, static_argnums=1)
REF_BACKEND = dataclasses.replace(JNP_BACKEND, panel_fns={
    "ldlt": lambda panel, nb, backend: _REF_LDLT_PANEL(panel, nb),
    "gauss_jordan": jax.jit(ref_gj.gj_inverse_unblocked)})


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("dmf", ["ldlt", "gauss_jordan"])
@pytest.mark.parametrize("variant", ["mtb", "la", "la2"])
def test_engine_issues_hooks_in_reference_order(dmf, variant):
    a = _input(dmf, "float64")[:16, :16]
    with ref_tracer.trace(fence=False) as ref_tr:
        # the reference's own panels, jitted through its panel_fns hook
        ref_get_variant(dmf, variant)(jnp.asarray(a), [8, 4],
                                      backend=REF_BACKEND)
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant(dmf, variant)(a, [8, 4], device="cpu")
    assert _span_keys(tr.spans) == _span_keys(ref_tr.spans)
    assert bool(tr.by_cat("EPI")) == (dmf == "gauss_jordan"
                                      and variant != "mtb")


@pytest.mark.parametrize("variant,names", [
    ("mtb", ["QR(0)", "TUL(0)", "LQ(0)", "TUR(0)", "QR(1)", "TUL(1)",
             "LQ(1)", "TUR(1)", "QR(2)"]),
    ("la", ["QR(0)", "TUL(0)", "LQ(0)", "W(0)", "PU(0->1)", "QR(1)",
            "TUR(0)", "TUL(1)", "LQ(1)", "W(1)", "PU(1->2)", "QR(2)"])])
def test_band_reduction_spans_and_tracing_is_bitwise_invisible(variant,
                                                               names):
    a = _input("band_reduction", "float64")
    fn = lookahead.get_variant("band_reduction", variant)
    plain = fn(a, 16, device="cpu")
    with tracer.trace(fence=False) as tr:
        traced = fn(a, 16, device="cpu")
    assert torch.equal(plain, traced)
    assert [s.name for s in tr.spans] == names
    assert {s.cat for s in tr.spans} <= set(tracer.CATEGORIES)
    pf = [s for s in tr.spans if s.name == "QR(1)"][0]
    assert (pf.step, pf.it, pf.depth) == ((1, 0, 1) if variant == "la"
                                          else (1, 1, 0))
