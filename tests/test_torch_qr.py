"""The port's Householder QR, ``qr_factor`` and ``gels`` against the
reference's, on the CPU.

The same NumPy inputs go through ``repro.core.qr`` / ``repro.solve`` (JAX
on the CPU, jnp backend, one ``jax.jit`` per case) and ``repro_torch``
(``device="cpu"``: the ``"cuda"`` backend's plain kernel versions), over
mtb/rtm/la/la2/la_mb × f32/f64 × {square, tall, wide (factor only),
ragged schedule}.  Tolerance: 200·max(m,n,8)·eps at the input dtype (the
port computes at the input dtype; ``tests/conformance.py``), and the
reference's ``_check_qr`` runs on the port's output.  The reference's
variants are bitwise equal to one another, so it runs ``mtb`` once per
shape, in float64: the inputs hold float32 values in both dtypes, so one
float64 reference (and one compile) serves both, and a float32 result is
held to the float32 tolerance against it.  The plain panel (GEQR2 + LARFT) is held to the
reference's routines and to its Pallas panel in interpret mode.

Also here: the port's schedules bitwise equal to one another, the engine's
span order against the reference's, carrying factors across the two
packages, ``logdet``/``inverse``, and the error paths.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformance
import repro.solve as ref_solve
from repro.core import qr as ref_qr
from repro.core.lookahead import get_variant as ref_get_variant
from repro.kernels import ops as ref_kops
from repro.obs import tracer as ref_tracer
from repro.solve.factors import QRFactors as RefQRFactors
from repro_torch.core import lookahead, pipeline, qr
from repro_torch.kernels import ops, panel_qr
from repro_torch.obs import tracer
from repro_torch.solve import QRFactors, gels, qr_factor

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
VARIANTS = ("mtb", "rtm", "la", "la2", "la_mb")
#: shape class -> (m, n, block)
SHAPES = {"square": (32, 32, 16), "tall": (48, 24, 16), "wide": (12, 24, 8),
          "ragged": (40, 30, [8, 16])}
NRHS = 2


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tol(m, n, dtype):
    return 200.0 * max(m, n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _inputs(shape, dtype):
    """float32 values, in ``dtype``."""
    m, n, _ = SHAPES[shape]
    return (_rand((m, n), 0, np.float32).astype(dtype),
            _rand((m, NRHS), 1, np.float32).astype(dtype))


@functools.lru_cache(maxsize=None)
def _reference(shape):
    """The reference's float64 factor object, once per shape, and the
    least-squares solution (m ≥ n) of the same data."""
    m, n, b = SHAPES[shape]
    a, rhs = _inputs(shape, np.float64)
    fac = jax.jit(lambda x: ref_solve.qr_factor(x, b, variant="mtb"))(
        jnp.asarray(a))
    x = np.linalg.lstsq(a.astype(np.float64), rhs.astype(np.float64),
                        rcond=None)[0] if m >= n else None
    return fac, x


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_qr_and_gels_match_reference(variant, dtype, shape):
    m, n, b = SHAPES[shape]
    a, rhs = _inputs(shape, dtype)
    ref, ref_x = _reference(shape)
    fac = qr_factor(a, b, variant=variant, device="cpu")
    tol = _tol(m, n, dtype)
    assert fac.taus.shape == (min(m, n),)
    assert _rel(fac.packed, ref.packed) < tol
    assert _rel(fac.taus, ref.taus) < tol
    if variant == "la" and shape in ("tall", "wide"):   # the others: bitwise
        # the packed GEQRF output does not depend on the blocking, so the
        # check's form_q runs as one panel (one reference compile per case)
        # (in float64 arithmetic on the port's values, at the dtype's tol)
        f64 = [jnp.asarray(np.asarray(x, np.float64))
               for x in (a, fac.packed, fac.taus)]
        conformance._check_qr(f64[0], tuple(f64[1:]), tol, max(m, n), None)
    if m >= n:
        x = gels(a, rhs, b, variant=variant, device="cpu")
        assert torch.equal(x, fac.solve(rhs))
        assert _rel(x, ref_x) < tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,b", [(48, 40, 16), (24, 50, 8),
                                   (40, 30, [8, 16, 12])])
def test_cuda_backend_schedules_are_bitwise_equal(dtype, m, n, b):
    a = _rand((m, n), 2, dtype)
    base = qr.qr_blocked(a, b, device="cpu")
    for variant in ("rtm", "la", "la2", "la3", "la_mb", "la_mb2"):
        got = lookahead.get_variant("qr", variant)(a, b, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(got, base)), variant


def test_torch_backend_schedules_agree_to_tolerance():
    a = _rand((40, 30), 3, np.float64)
    base = qr.qr_blocked(a, 8, backend="torch", device="cpu")
    for variant in ("rtm", "la2"):
        got = lookahead.get_variant("qr", variant)(a, 8, backend="torch",
                                                   device="cpu")
        assert _rel(got[0], base[0]) < _tol(40, 30, np.float64)


@pytest.mark.parametrize("m,nb,zero,dtype", [(20, 8, 3, "float64"),
                                             (5, 8, None, "float32")])
def test_panel_plain_versions_match_reference(m, nb, zero, dtype):
    """GEQR2, LARFT and the reflector against the reference's routines and
    its Pallas panel (interpret mode); a zero column gives tau = 0, and an
    m < nb panel reflects only its first m columns."""
    p = _rand((m, nb), 4, dtype)
    if zero is not None:
        p[:, zero] = 0.0
    tol = _tol(m, nb, dtype)
    got = panel_qr.qr_panel(torch.from_numpy(p.copy()))     # CPU: plain
    packed, tau = ref_qr.qr_unblocked(jnp.asarray(p))
    wants = [(packed, tau, ref_qr.build_t_matrix(ref_qr.unpack_v(packed, nb),
                                                 tau))]
    if zero is not None:          # the Pallas panel, once (interpret mode)
        wants.append(ref_kops.qr_panel(jnp.asarray(p)))
    for want in wants:
        for x, y in zip(got, want):
            assert _rel(x, y) < tol
    if zero is not None:
        assert float(got[1][zero]) == 0.0
    assert bool((got[1][min(m, nb):] == 0).all())
    v = qr.unpack_v(got[0], nb)
    np.testing.assert_array_equal(
        v.numpy(), np.asarray(ref_qr.unpack_v(jnp.asarray(got[0].numpy()),
                                              nb)))
    assert torch.equal(qr.build_t_matrix(v, got[1]), got[2])
    x = torch.from_numpy(p[:, 1].copy())
    for j in (0, 2):
        hv = qr.householder_vector(x, j)
        want = ref_qr.householder_vector(jnp.asarray(p[:, 1]), j)
        for g, w in zip(hv, want):
            assert _rel(g, w) < tol


def _span_keys(spans):
    return [(s.cat, s.name, s.step, s.it, s.depth) for s in spans]


@pytest.mark.parametrize("variant", ["la2"])
def test_engine_issues_hooks_in_reference_order(variant):
    """On a wide input: the row-exhaustion stop and the dd = 0 rule."""
    a = _rand((6, 16), 5, np.float64)
    with ref_tracer.trace(fence=False) as ref_tr:
        ref_get_variant("qr", variant)(jnp.asarray(a), [4])
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant("qr", variant)(a, [4], device="cpu")
    assert _span_keys(tr.spans) == _span_keys(ref_tr.spans)


@pytest.mark.parametrize("dtype", DTYPES)
def test_factors_carry_across_packages_logdet_inverse(dtype):
    m, n, b = SHAPES["square"]
    a, rhs = _inputs("square", dtype)
    ref, ref_x = _reference("square")
    tol = _tol(m, n, dtype)
    packed, taus = (np.asarray(x).astype(dtype) for x in (ref.packed,
                                                          ref.taus))
    port = QRFactors.from_numpy(packed, taus, block=b, device="cpu")
    for got, want in zip(port.to_numpy(), (packed, taus)):
        np.testing.assert_array_equal(got, want)
    assert _rel(port.solve(rhs), ref_x) < tol
    assert port.solve(rhs[:, 0]).shape == (n,)
    fac = qr_factor(a, b, variant="la", device="cpu")
    back = RefQRFactors(*(jnp.asarray(x.astype(np.float64))
                          for x in fac.to_numpy()), block=b)

    @jax.jit
    def reference_ops(ref, back, rhs):
        return (ref.apply_qt(rhs), back.solve(rhs), ref.logdet(),
                ref.inverse(), ref_qr.form_q(ref.packed, ref.taus, b))

    qtb, x_back, (ref_sign, ref_logdet), ref_inv, ref_q = reference_ops(
        ref, back, jnp.asarray(rhs.astype(np.float64)))
    assert _rel(port.apply_qt(rhs), qtb) < tol
    assert _rel(x_back, ref_x) < tol
    sign, logdet = fac.logdet()
    assert float(sign) == float(ref_sign)
    assert abs(float(logdet) - float(ref_logdet)) < tol * abs(
        float(ref_logdet))
    assert _rel(fac.inverse(), ref_inv) < tol
    assert _rel(qr.form_q(fac.packed, fac.taus, b), ref_q) < tol


def test_error_paths():
    a, rhs = _inputs("tall", "float64")
    a0 = a.copy()
    gels(a, rhs, 16, device="cpu")
    np.testing.assert_array_equal(a, a0)           # the input is copied
    wide = qr_factor(_rand((4, 6), 6, np.float64), 2, device="cpu")
    with pytest.raises(ValueError, match="m >= n"):
        wide.solve(np.ones((4, 1)))
    with pytest.raises(ValueError, match="square"):
        wide.logdet()
    with pytest.raises(ValueError, match="square"):
        wide.inverse()
    with pytest.raises(ValueError, match="requires pivot=True"):
        gels(a, rhs, 16, local=True, device="cpu")
    with pytest.raises(ValueError, match="rcond requires pivot=True"):
        gels(a, rhs, 16, rcond=1e-3, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh, got builtins.object"):
        gels(a, rhs, 16, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh, got builtins.object"):
        qr_factor(a, 16, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="rhs rows"):
        qr_factor(a, 16, device="cpu").solve(rhs[:5])
    wide_tiled = qr_factor(_rand((4, 6), 6, np.float64), 2, variant="tiled",
                           device="cpu")
    with pytest.raises(ValueError, match="m >= n"):
        wide_tiled.solve(np.ones((4, 1)))
    with pytest.raises(ValueError, match="square"):
        wide_tiled.logdet()
    with pytest.raises(ValueError, match="larft: tau"):
        panel_qr.larft(torch.ones(4, 3, dtype=torch.float64),
                       torch.ones(2, dtype=torch.float64))
    unsafe = dataclasses.replace(qr.QR_OPS, la_unsafe="reads trailing data")
    with pytest.raises(ValueError, match="reads trailing data"):
        pipeline.factorize(unsafe, a, 16, variant="la", device="cpu")
    ops.reset_launches()
    qr_factor(a, 16, device="cpu")
    assert ops.launches() == dict.fromkeys(ops.KERNELS, 0)  # CPU: no launch
