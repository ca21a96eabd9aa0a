"""The port's Hessenberg reduction (``gehrd``, ``HessenbergFactors``), and
its ``gecon`` and ``getri``, against the reference's, on the CPU.

The same NumPy inputs go through ``repro.core.hessenberg`` /
``repro.solve`` (JAX on the CPU, jnp backend) and ``repro_torch``
(``device="cpu"``: the ``"cuda"`` backend's plain kernel versions).  As in
``test_torch_qr.py`` the inputs hold float32 values in both dtypes and the
reference runs once per shape in float64, so a float32 port result is held
to the float32 tolerance against it.  Tolerance: 200·max(n,8)·eps at the
input dtype (``tests/conformance.py``); the reference's
``_check_hessenberg`` runs on the port's output.

The plain xLAHR2 sweep is held to the reference's jit sweep and to its
Pallas panel in interpret mode, at panels that reach the last two columns
of the matrix (``tau = 0``) and a ragged width.  Also here: mtb ≡ rtm
bitwise, the engine's span order, the look-ahead exclusion, tiny and
non-square inputs, carrying a reduction across the two packages, the
spectrum of a symmetric input, and ``gecon``/``getri``.
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
from repro.kernels import panel_hessenberg as ref_pallas_panel
from repro.kernels import panels as ref_panels
from repro.obs import tracer as ref_tracer
from repro.solve.factors import HessenbergFactors as RefHessenbergFactors
from repro_torch.core import hessenberg, lookahead, pipeline
from repro_torch.kernels import ops, panel_hessenberg
from repro_torch.obs import tracer
from repro_torch.solve import HessenbergFactors, gecon, gehrd, getri

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
#: shape class -> (n, block)
SHAPES = {"square": (32, 8), "ragged": (37, 8), "schedule": (30, [8, 4])}


def _rand(shape, seed, dtype=np.float32):
    """float32 values in ``dtype`` (one float64 reference serves both)."""
    g = np.random.default_rng(seed).standard_normal(shape)
    return g.astype(np.float32).astype(dtype)


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


@functools.lru_cache(maxsize=None)
def _reference(shape):
    """The reference's float64 reduction and its Q, once per shape."""
    n, b = SHAPES[shape]
    a = _rand((n, n), 0, np.float64)

    @jax.jit
    def reference(x):
        fac = ref_solve.gehrd(x, b)
        return fac, fac.q()

    return reference(jnp.asarray(a))


# ---------------------------------------------------------------------------
# The plain xLAHR2 sweep against the reference's panels.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,k,bk", [(16, 0, 8), (16, 8, 8), (24, 16, 8),
                                    (20, 4, 6)])
def test_plain_sweep_matches_reference_panels(n, k, bk, dtype):
    a = _rand((n, n), 3, dtype)
    got = panel_hessenberg.hessenberg_panel(torch.from_numpy(a.copy()), k, bk)
    wants = [ref_panels.hessenberg_panel(jnp.asarray(a), k, bk),
             ref_pallas_panel.hessenberg_panel(jnp.asarray(a), k, bk,
                                               interpret=True)]
    tol = _tol(n, dtype)
    for want in wants:
        for x, y in zip(got, want):
            assert x.shape == y.shape
            assert _rel(x, y) < tol
    tau = got[4]
    if k + bk >= n - 1:   # the columns kj >= n − 2 reduce no rows
        assert float(tau[n - 2 - k]) == 0.0
        assert not got[1][:, n - 2 - k].any()
    # only the panel's columns change, in place
    np.testing.assert_array_equal(got[0][:, :k].numpy(), a[:, :k])
    np.testing.assert_array_equal(got[0][:, k + bk :].numpy(), a[:, k + bk :])


def test_panel_wrapper_checks_its_operands():
    a = torch.ones(6, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="square"):
        panel_hessenberg.hessenberg_panel(torch.ones(6, 4,
                                                     dtype=torch.float64),
                                          0, 2)
    with pytest.raises(ValueError, match="outside"):
        panel_hessenberg.hessenberg_panel(a, 4, 4)
    with pytest.raises(ValueError, match="dtype"):
        panel_hessenberg.hessenberg_panel(a.to(torch.float16), 0, 2)
    assert ops.PANEL_KERNELS["hessenberg"] is panel_hessenberg.hessenberg_panel
    assert ops.KERNELS["hessenberg_panel"] is panel_hessenberg.hessenberg_panel


# ---------------------------------------------------------------------------
# gehrd against the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["mtb", "rtm"])
def test_gehrd_matches_reference(variant, dtype, shape):
    n, b = SHAPES[shape]
    a = _rand((n, n), 0, dtype)
    ref, ref_q = _reference(shape)
    fac = gehrd(a, b, variant=variant, device="cpu")
    tol = _tol(n, dtype)
    assert fac.packed.dtype == getattr(torch, dtype)
    assert fac.taus.shape == (n,) and fac.n == n
    assert _rel(fac.packed, ref.packed) < tol
    assert _rel(fac.taus, ref.taus) < tol
    assert not torch.tril(fac.h, -2).any()          # exactly Hessenberg
    assert _rel(fac.q(), ref_q) < tol
    if (variant, dtype) == ("mtb", "float64"):
        # the packed output does not depend on the blocking, so the
        # check's form_q_hess runs as one panel
        conformance._check_hessenberg(
            jnp.asarray(a), (jnp.asarray(fac.packed.numpy()),
                             jnp.asarray(fac.taus.numpy())), tol, n, None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,b", [(40, 8), (33, [8, 4]), (16, 16), (9, 4)])
def test_cuda_backend_schedules_are_bitwise_equal(dtype, n, b):
    a = _rand((n, n), 2, dtype)
    base = hessenberg.hessenberg_blocked(a, b, device="cpu")
    got = lookahead.get_variant("hessenberg", "rtm")(a, b, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(got, base))


def test_torch_backend_agrees_to_tolerance():
    n, b = 40, 8
    a = _rand((n, n), 4, np.float64)
    base = gehrd(a, b, device="cpu")
    tol = _tol(n, np.float64)
    for variant in ("mtb", "rtm"):
        fac = gehrd(a, b, variant=variant, backend="torch", device="cpu")
        assert _rel(fac.packed, base.packed) < tol
        assert _rel(fac.reconstruct(), a) < tol


def test_torch_backend_calls_no_kernel_wrapper(monkeypatch):
    """``backend="torch"`` takes no panel or larft wrapper, for Hessenberg,
    both column-pivoted QRs and Cholesky (the rule of
    ``core/backend.py``)."""
    from repro_torch.kernels import fused_panel_update, ops, panel_qr, \
        panel_qrcp
    from repro_torch.solve import cholesky_factor, geqp3

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran under backend='torch'")

    for mod, name in ((panel_hessenberg, "hessenberg_panel"),
                      (panel_qrcp, "qrcp_panel"), (panel_qr, "larft"),
                      (fused_panel_update, "cholesky_panel")):
        monkeypatch.setattr(mod, name, refuse)
    # (la_mb's fused update runs under "torch" too, as the reference's jnp
    # backend runs its Pallas kernel; its first panel is the engine's own)
    monkeypatch.setitem(ops.PANEL_KERNELS, "cholesky", refuse)
    spd = _rand((24, 24), 7, np.float64)
    spd = spd @ spd.T + 24 * np.eye(24)
    for variant in ("mtb", "rtm", "la", "la2", "la_mb"):
        cholesky_factor(spd, 8, variant=variant, backend="torch", device="cpu")
    a = _rand((24, 24), 6, np.float64)
    base = gehrd(a, 8, device="cpu")
    for variant in ("mtb", "rtm"):
        fac = gehrd(a, 8, variant=variant, backend="torch", device="cpu")
        assert _rel(fac.packed, base.packed) < _tol(24, np.float64)
    for local, variant in ((False, "mtb"), (True, "la")):
        geqp3(a, 8, local=local, variant=variant, backend="torch",
              device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_tiny(n):
    a = _rand((n, n), 5 + n, np.float64)

    @jax.jit
    def reference(x):
        fac = ref_solve.gehrd(x, 2)
        return fac, fac.q()

    return reference(jnp.asarray(a))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_inputs_match_reference(n, dtype):
    a = _rand((n, n), 5 + n, dtype)
    ref, ref_q = _reference_tiny(n)
    fac = gehrd(a, 2, device="cpu")
    tol = _tol(n, dtype)
    np.testing.assert_allclose(fac.packed.numpy(), np.asarray(ref.packed),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(fac.taus.numpy(), np.asarray(ref.taus),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(fac.q().numpy(), np.asarray(ref_q),
                               rtol=tol, atol=tol)
    assert _rel(fac.reconstruct(), a) < tol


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("variant", ["mtb", "rtm"])
def test_engine_issues_hooks_in_reference_order(variant):
    a = _rand((16, 16), 6, np.float64)
    with ref_tracer.trace(fence=False) as ref_tr:
        ref_get_variant("hessenberg", variant)(jnp.asarray(a), [8, 4])
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant("hessenberg", variant)(a, [8, 4], device="cpu")
    # the reference's traced panel adds a span of its own
    assert _span_keys(tr.spans) == _span_keys(
        [s for s in ref_tr.spans if s.cat != "panel"])
    assert len(tr.by_cat("PF")) == 3


def test_lookahead_exclusion_and_error_paths():
    a = _rand((12, 12), 8, np.float64)
    assert lookahead.list_variants("hessenberg") == ("mtb", "rtm", "tuned")
    for variant in ("la", "la2", "la_mb", "tiled"):
        with pytest.raises(KeyError, match="excluded by policy"):
            lookahead.get_variant("hessenberg", variant)
    with pytest.raises(KeyError, match="stale bulk columns"):
        gehrd(a, 4, variant="la2", device="cpu")
    with pytest.raises(ValueError, match="stale bulk columns"):
        pipeline.factorize(hessenberg.HESSENBERG_OPS, a, 4, variant="la",
                           device="cpu")
    with pytest.raises(ValueError, match="square"):
        gehrd(_rand((12, 8), 8, np.float64), 4, device="cpu")
    with pytest.raises(ValueError, match="square"):
        hessenberg.hessenberg_tiled(np.ones(5), 4, device="cpu")


# ---------------------------------------------------------------------------
# HessenbergFactors across the two packages; the spectrum.
# ---------------------------------------------------------------------------
def test_factors_carry_across_packages():
    n, b = SHAPES["square"]
    a = _rand((n, n), 0, np.float64)
    other = _rand((n, n), 9, np.float64)
    ref, ref_q = _reference("square")
    port = HessenbergFactors.from_numpy(np.asarray(ref.packed),
                                        np.asarray(ref.taus), block=b,
                                        device="cpu")
    for got, want in zip(port.to_numpy(), (ref.packed, ref.taus)):
        np.testing.assert_array_equal(got, np.asarray(want))
    tol = _tol(n, np.float64)
    fac = gehrd(a, b, device="cpu")
    back = RefHessenbergFactors(*(jnp.asarray(x) for x in fac.to_numpy()),
                                block=b)
    ref_rec, ref_sim, back_q, back_rec = jax.jit(
        lambda f, g, o: (f.reconstruct(), f.similarity(o), g.q(),
                         g.reconstruct()))(ref, back, jnp.asarray(other))
    assert _rel(port.q(), ref_q) < tol
    assert _rel(port.reconstruct(), ref_rec) < tol
    assert _rel(port.similarity(other), ref_sim) < tol
    assert _rel(back_q, ref_q) < tol
    assert _rel(back_rec, a) < tol
    ev = np.sort_complex(fac.eigvals().numpy())
    ev_ref = np.sort_complex(np.asarray(ref.eigvals()))
    assert np.abs(ev - ev_ref).max() < 1e-10


@pytest.mark.parametrize("n,b,seed", [(24, 8, 0), (17, 4, 1), (40, 16, 2)])
def test_symmetric_input_keeps_its_spectrum(n, b, seed):
    """The reference's property (``tests/test_property.py``): H of a
    symmetric A has real eigenvalues equal to A's."""
    g = np.random.default_rng(seed).standard_normal((n, n))
    a = (g + g.T) / 2
    fac = gehrd(a, b, device="cpu")
    assert not torch.tril(fac.h, -2).any()
    ev = fac.eigvals().numpy()
    assert np.abs(ev.imag).max() < 1e-8 * n
    ev_a = np.sort(np.linalg.eigvalsh(a))
    scale = max(float(np.abs(ev_a).max()), 1.0)
    np.testing.assert_allclose(np.sort(ev.real), ev_a, atol=1e-8 * n * scale)


# ---------------------------------------------------------------------------
# gecon and getri.
# ---------------------------------------------------------------------------
GECON = (30, 8)


@functools.lru_cache(maxsize=None)
def _reference_gecon():
    """The reference's float64 ``gecon`` and ``getri`` (its variants are
    bitwise equal, so ``la`` serves both)."""
    n, b = GECON
    a = jnp.asarray(_rand((n, n), 11, np.float64))
    return jax.jit(lambda x: (ref_solve.gecon(x, b), ref_solve.getri(x, b)))(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["la", "mtb"])
def test_gecon_and_getri_match_reference(dtype, variant):
    n, b = GECON
    a = _rand((n, n), 11, dtype)
    a64 = a.astype(np.float64)
    ref_rcond, ref_inv = _reference_gecon()
    tol = _tol(n, dtype)
    rcond = gecon(a, b, variant=variant, device="cpu")
    assert rcond.dim() == 0 and rcond.dtype == getattr(torch, dtype)
    assert abs(float(rcond) - float(ref_rcond)) < tol * float(ref_rcond)
    exact = 1.0 / (np.abs(a64).sum(0).max()
                   * np.abs(np.linalg.inv(a64)).sum(0).max())
    assert 1.0 <= float(rcond) / exact * (1 + 1e-6) and \
        float(rcond) / exact <= 10.0       # a lower bound of ‖A⁻¹‖₁
    inv = getri(a, b, variant=variant, device="cpu")
    # κ₁(A) ≈ 3.2e3 for this seed, so eps·κ₁ allows 3.8e-4 relative error
    # in float32 and 7.1e-13 in float64; the forward error is about
    # 0.02·eps·κ₁ in both.  The residual is held as the card test holds it.
    eps = float(np.finfo(dtype).eps)
    assert _rel(inv, ref_inv) < eps * float(np.linalg.cond(a64, 1))
    x = inv.double().numpy()
    assert np.linalg.norm(a64 @ x - np.eye(n)) / (
        n * eps * np.linalg.norm(a64) * np.linalg.norm(x)) < 200.0
    assert torch.equal(inv, getri(a, b, variant=variant, method="lu",
                                  device="cpu"))


def test_getri_methods():
    a = np.eye(4) * 2.0
    np.testing.assert_array_equal(getri(a, 2, method="gj",
                                        device="cpu").numpy(), np.eye(4) / 2)
    with pytest.raises(ValueError, match="method"):
        getri(a, 2, method="qr", device="cpu")
    np.testing.assert_allclose(getri(a, 2, device="cpu").numpy(),
                               np.eye(4) / 2.0)
    assert float(gecon(a, 2, device="cpu")) == pytest.approx(1.0)
