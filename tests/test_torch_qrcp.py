"""The port's column-pivoted QR (global ``qrcp``, windowed ``qrcp_local``),
``geqp3`` and ``gels(pivot=True)`` against the reference's, on the CPU.

The same NumPy inputs go through ``repro.core.qrcp`` / ``repro.solve`` (JAX
on the CPU, jnp backend, one ``jax.jit`` per case) and ``repro_torch``
(``device="cpu"``: the plain xLAQPS sweep and the other plain kernel
versions).  As in ``test_torch_qr.py`` the inputs hold float32 values in
both dtypes and the reference runs once per case in float64.  Tolerance:
200·max(m,n,8)·eps at the input dtype (``tests/conformance.py``); ``jpvt``
equal to the reference's in both dtypes; the reference's ``_check_qrcp`` /
``_check_qrcp_local`` on the port's output.

The plain xLAQPS sweep is held to the reference's traced sweep (both
dtypes) and to its Pallas panel in interpret mode (float64), pivots
equal.  Also here: the
``qrcp_local`` schedules bitwise equal to ``mtb``, the engine's span
order, rank on a rank-deficient input, carrying factors across the two
packages, and the look-ahead exclusion of global QRCP.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformance
import repro.solve as ref_solve
from repro.core.lookahead import get_variant as ref_get_variant
from repro.kernels import ops as ref_kops
from repro.kernels import panels as ref_panels
from repro.obs import tracer as ref_tracer
from repro.solve.factors import QRCPFactors as RefQRCPFactors
from repro_torch.core import lookahead, pipeline, qrcp
from repro_torch.kernels import panel_qrcp
from repro_torch.obs import tracer
from repro_torch.solve import QRCPFactors, geqp3, gels

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
#: shape class -> (m, n, block)
SHAPES = {"tall": (28, 16, 8), "wide_ragged": (12, 20, [8, 4])}
#: (local, variant) pairs of geqp3
POLICIES = [(False, "mtb"), (False, "rtm"), (True, "mtb"), (True, "rtm"),
            (True, "la"), (True, "la2"), (True, "la_mb")]
NRHS = 2


def _rand(shape, seed, dtype=np.float32):
    """float32 values in ``dtype`` (one float64 reference serves both)."""
    g = np.random.default_rng(seed).standard_normal(shape)
    return g.astype(np.float32).astype(dtype)


def _tol(m, n, dtype):
    return 200.0 * max(m, n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _f64(*xs):
    return [jnp.asarray(np.asarray(x, np.float64)) for x in xs]


@functools.lru_cache(maxsize=None)
def _reference(shape, local):
    m, n, b = SHAPES[shape]
    a = _rand((m, n), 0, np.float64)
    return jax.jit(lambda x: ref_solve.geqp3(
        x, b, local=local, variant="mtb"))(jnp.asarray(a))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local,variant", POLICIES)
def test_geqp3_matches_reference(local, variant, dtype, shape):
    m, n, b = SHAPES[shape]
    a = _rand((m, n), 0, dtype)
    ref = _reference(shape, local)
    fac = geqp3(a, b, variant=variant, local=local, device="cpu")
    tol = _tol(m, n, dtype)
    assert fac.taus.shape == (min(m, n),) and fac.jpvt.dtype == torch.int32
    # equal in both dtypes: these seeded inputs have no near-tie of norms
    np.testing.assert_array_equal(fac.jpvt.numpy(), np.asarray(ref.jpvt))
    assert _rel(fac.packed, ref.packed) < tol
    assert _rel(fac.taus, ref.taus) < tol
    if variant == ("la" if local else "mtb") and shape == (
            "wide_ragged" if local else "tall"):   # the others: bitwise
        # (in float64 arithmetic on the port's values, at the dtype's tol)
        a64, packed, taus = _f64(a, fac.packed, fac.taus)
        out = (packed, taus, jnp.asarray(fac.jpvt.numpy()))
        if local:
            conformance._check_qrcp_local(a64, out, tol, b, None)
        else:
            # the packed output does not depend on the blocking, so the
            # check's form_q runs as one panel (one compile per case)
            conformance._check_qrcp(a64, out, tol, max(m, n), None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,b", [(40, 30, 8), (12, 28, 8),
                                   (30, 30, [8, 16])])
def test_qrcp_local_schedules_are_bitwise_equal(dtype, m, n, b):
    a = _rand((m, n), 2, dtype)
    base = qrcp.qrcp_local_blocked(a, b, device="cpu")
    for variant in ("rtm", "la", "la2", "la_mb", "la_mb2"):
        got = lookahead.get_variant("qrcp_local", variant)(a, b,
                                                           device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(got, base)), variant
    g = qrcp.qrcp_blocked(a, b, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(qrcp.qrcp_tiled(a, b, device="cpu"), g))


@pytest.mark.parametrize("r,c,steps,dtype", [(24, 24, 8, "float64"),
                                             (16, 24, 8, "float32"),
                                             (24, 16, 16, "float32")])
def test_plain_sweep_matches_reference_panels(r, c, steps, dtype):
    block = _rand((r, c), 3, dtype)
    block[:, 5] = 0.0                   # a zero column
    got = panel_qrcp.qrcp_panel(torch.from_numpy(block.copy()), steps)
    assert got[2].shape == (c, steps) and got[2].stride() == (1, c)
    tol = _tol(r, c, dtype)
    wants = [ref_panels.qrcp_panel(jnp.asarray(block), steps)]
    if dtype == "float64" and r == c:
        wants.append(ref_kops.qrcp_panel(jnp.asarray(block), steps))
    for want in wants:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        for x, y in zip(got[:4], want[:4]):
            assert _rel(x, y) < tol


GELS_SHAPE = (30, 16, 8)


@functools.lru_cache(maxsize=None)
def _reference_gels(local):
    b = GELS_SHAPE[2]

    @jax.jit
    def reference(a, rhs, rcond):
        fac = ref_solve.geqp3(a, b, local=local)
        return fac.rank(rcond), fac.solve(rhs, rcond=rcond)

    return reference


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local", [False, True])
def test_gels_pivot_full_rank_and_rank_deficient(dtype, local):
    """Rank at the input dtype's cutoff (rcond = max(m, n)·eps), which the
    float64 reference is given too; the deficient input is a product of two
    seeded Gaussian factors, formed in the input dtype."""
    m, n, b = GELS_SHAPE
    full = _rand((m, n), 4, dtype)
    deficient = _rand((m, n // 2), 9, dtype) @ _rand((n // 2, n), 10, dtype)
    rhs = _rand((m, NRHS), 5, dtype)
    tol = _tol(m, n, dtype)
    rcond = max(m, n) * float(np.finfo(dtype).eps)
    for a in (full, deficient):
        ref_rank, ref_x = _reference_gels(local)(*_f64(a, rhs), rcond)
        fac = geqp3(a, b, local=local, device="cpu")
        assert fac.rank(rcond) == int(ref_rank)
        x = gels(a, rhs, b, pivot=True, local=local, rcond=rcond,
                 device="cpu")
        assert torch.equal(x, fac.solve(rhs, rcond=rcond))
        assert x.shape == (n, NRHS)
        if a is full:
            assert _rel(x, ref_x) < tol
            assert fac.rank(rcond) == n
        else:
            assert fac.rank(rcond) == n // 2
            # the basic solutions may differ; both are least-squares
            a64 = a.astype(np.float64)
            res = np.linalg.norm(a64 @ np.asarray(x, np.float64) - rhs)
            ref_res = np.linalg.norm(a64 @ np.asarray(ref_x) - rhs)
            assert res <= ref_res * (1 + tol) + tol * np.linalg.norm(rhs)


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("dmf,variant", [("qrcp_local", "la2")])
def test_engine_issues_hooks_in_reference_order(dmf, variant):
    a = _rand((6, 14), 6, np.float64)       # wide: the row-exhaustion stop
    with ref_tracer.trace(fence=False) as ref_tr:
        ref_get_variant(dmf, variant)(jnp.asarray(a), [4])
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant(dmf, variant)(a, [4], device="cpu")
    # the reference's traced QRCP panel adds a span of its own
    assert _span_keys(tr.spans) == _span_keys(
        [s for s in ref_tr.spans if s.cat != "panel"])


def test_factors_carry_across_packages():
    m, n, b = SHAPES["tall"]
    a = _rand((m, n), 0, np.float64)
    rhs = _rand((m, NRHS), 7, np.float64)
    ref = _reference("tall", False)
    port = QRCPFactors.from_numpy(*(np.asarray(x) for x in
                                    (ref.packed, ref.taus, ref.jpvt)),
                                  block=b, device="cpu")
    for got, want in zip(port.to_numpy(), (ref.packed, ref.taus, ref.jpvt)):
        np.testing.assert_array_equal(got, np.asarray(want))
    fac = geqp3(a, b, device="cpu")
    back = RefQRCPFactors(*(jnp.asarray(x) for x in fac.to_numpy()),
                          block=b)
    x_ref, x_back = jax.jit(lambda f, g, r: (f.solve(r), g.solve(r)))(
        ref, back, jnp.asarray(rhs))
    tol = _tol(m, n, np.float64)
    assert _rel(port.solve(rhs), x_ref) < tol
    assert _rel(x_back, x_ref) < tol
    assert _rel(port.apply_qt(rhs), fac.apply_qt(rhs)) < tol
    assert port.solve(rhs[:, 0]).shape == (n,)


def test_lookahead_exclusion_and_error_paths():
    a = _rand((12, 8), 8, np.float64)
    assert lookahead.list_variants("qrcp") == ("mtb", "rtm", "tuned")
    assert lookahead.list_variants("qrcp_local") == ("mtb", "rtm", "la",
                                                     "la2", "la_mb", "tuned")
    for variant in ("la", "la2", "la_mb", "tiled"):
        with pytest.raises(KeyError, match="excluded by policy"):
            lookahead.get_variant("qrcp", variant)
    with pytest.raises(ValueError, match="stale norms"):
        pipeline.factorize(qrcp.QRCP_OPS, a, 4, variant="la", device="cpu")
    with pytest.raises(ValueError, match="requires local=True"):
        geqp3(a, 4, depth=2, device="cpu")
    with pytest.raises(KeyError, match="excluded by policy"):
        gels(a, a[:, :1], 4, pivot=True, variant="la2", device="cpu")
    with pytest.raises(ValueError, match="m >= n"):
        geqp3(a.T, 4, device="cpu").solve(np.ones((8, 1)))
    with pytest.raises(ValueError, match="steps"):
        panel_qrcp.qrcp_panel(torch.ones(4, 3, dtype=torch.float64), 4)
    # gels(pivot=True) maps the default la to mtb for global pivoting
    x = gels(a, a[:, :1], 4, pivot=True, device="cpu")
    assert torch.equal(x, geqp3(a, 4, variant="mtb", device="cpu").solve(
        a[:, :1]))
