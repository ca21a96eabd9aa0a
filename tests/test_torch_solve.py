"""The whole slice on the CPU: the port's ``gesv`` against the reference's.

The same NumPy inputs go through ``repro.solve`` (JAX on the CPU, backend
``"jnp"``; one case per dtype on ``"pallas"`` in interpret mode) and
``repro_torch.solve`` (``device="cpu"``, backends ``"cuda"`` — the kernels'
plain versions — and ``"torch"``), over mtb/rtm/la/la2/la3 × f32/f64 ×
four shape classes.  Pivots must be equal in f64; the packed LU and the
solution must agree within the reference's 200·max(m,n,8)·eps; and the
reference's own LU contract check runs on the port's output.  The
reference runs every variant on the square float64 class; elsewhere it
runs ``mtb`` only, since its variants are bitwise equal to one another
(its own ``tests/test_pipeline.py``).  Its factor and solve run under one
``jax.jit`` per case (its ``LUFactors`` is a pytree), with its panel
routine jitted through its own ``Backend.panel_fns`` hook: one compile per
case instead of one per eager op, and the same bits as the eager call.

Also here: carrying a factored system across the two packages in both
directions, transposed solves and ``logdet``.
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
from repro.core.backend import JNP_BACKEND
from repro.core.lu import lu_unblocked as ref_lu_unblocked
from repro.solve.factors import LUFactors as RefLUFactors
from repro_torch.solve import LUFactors, gesv, lu_factor

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
VARIANTS = ("mtb", "rtm", "la", "la2", "la3")
#: shape class -> (n, block): one, small (n < b), ragged (n % b != 0), square
SHAPES = {"one": (1, 16), "small": (7, 16), "ragged": (24, 16),
          "square": (48, 16)}
NRHS = 3
#: The reference's jnp backend with its own GETF2 panel jitted.
REF_BACKEND = dataclasses.replace(
    JNP_BACKEND, panel_fns={"lu": jax.jit(ref_lu_unblocked)})


def _inputs(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(dtype),
            rng.standard_normal((n, NRHS)).astype(dtype))


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


@functools.lru_cache(maxsize=None)
def _reference(variant, dtype, shape):
    """The reference's factors and solution, once per case."""
    n, b = SHAPES[shape]
    a, rhs = _inputs(n, dtype)

    @jax.jit
    def factor_and_solve(a, rhs):
        fac = ref_solve.lu_factor(a, b, variant=variant, backend=REF_BACKEND)
        return fac, fac.solve(rhs)

    fac, x = factor_and_solve(jnp.asarray(a), jnp.asarray(rhs))
    return fac, np.asarray(x)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_gesv_matches_reference(variant, dtype, shape, backend):
    n, b = SHAPES[shape]
    a, rhs = _inputs(n, dtype)
    every_variant = shape == "square" and dtype == "float64"
    ref, ref_x = _reference(variant if every_variant else "mtb", dtype, shape)
    fac = lu_factor(a, b, variant=variant, backend=backend, device="cpu")
    x = gesv(a, rhs, b, variant=variant, backend=backend, device="cpu")
    assert torch.equal(x, fac.solve(rhs))
    if dtype == "float64":
        np.testing.assert_array_equal(fac.ipiv.numpy(), np.asarray(ref.ipiv))
    tol = _tol(n, dtype)
    assert _rel(fac.lu, ref.lu) < tol
    assert _rel(x, ref_x) < tol
    if backend == "cuda":   # the reference's contract check, on the kernel path
        conformance._check_lu(jnp.asarray(a), (jnp.asarray(fac.lu.numpy()),
                                              jnp.asarray(fac.ipiv.numpy())),
                              tol, b, None)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gesv_matches_reference_pallas_backend(dtype):
    # the Pallas kernels compute in f32: tolerance at eps(f32)
    n, b = 16, 8
    assert n <= conformance.PALLAS_MAX_N
    a, rhs = _inputs(n, dtype, seed=1)
    ref_x = ref_solve.gesv(jnp.asarray(a), jnp.asarray(rhs), b,
                           variant="la", backend="pallas")
    x = gesv(a, rhs, b, variant="la", device="cpu")
    assert _rel(x, ref_x) < _tol(n, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_factors_solve_in_the_port(dtype):
    n, b = SHAPES["square"]
    a, rhs = _inputs(n, dtype)
    ref, ref_x = _reference("mtb", dtype, "square")   # cached above
    port = LUFactors.from_numpy(np.asarray(ref.lu), np.asarray(ref.ipiv),
                                block=b, device="cpu")
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    assert _rel(port.solve(rhs), ref_x) < _tol(n, dtype)
    assert _rel(a.T @ port.solve(rhs, trans=True).numpy(), rhs) \
        < _tol(n, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_factors_solve_in_the_reference(dtype):
    n, b = 40, 16
    a, rhs = _inputs(n, dtype, seed=3)
    port = lu_factor(a, b, device="cpu")
    lu, ipiv, perm = port.to_numpy()
    ref = RefLUFactors.from_packed(jnp.asarray(lu), jnp.asarray(ipiv),
                                   block=b, backend=REF_BACKEND)
    np.testing.assert_array_equal(np.asarray(ref.perm), perm)
    assert _rel(ref.solve(jnp.asarray(rhs)), port.solve(rhs)) < _tol(n, dtype)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_transposed_solve_vector_rhs_and_logdet(backend):
    n, b = 30, 8
    a, rhs = _inputs(n, "float64", seed=4)
    fac = lu_factor(a, b, variant="la2", backend=backend, device="cpu")
    xt = fac.solve(rhs, trans=True)
    assert _rel(a.T @ xt.numpy(), rhs) < _tol(n, "float64")
    xv = fac.solve(rhs[:, 0])
    assert xv.shape == (n,)
    assert _rel(a @ xv.numpy(), rhs[:, 0]) < _tol(n, "float64")
    sign, logabs = fac.logdet()
    ref_sign, ref_logabs = np.linalg.slogdet(a)
    assert float(sign) == ref_sign
    assert abs(float(logabs) - ref_logabs) < 1e-10 * max(1.0, abs(ref_logabs))


def test_inputs_are_copied_and_never_modified():
    a, rhs = _inputs(20, "float64", seed=5)
    a0, rhs0 = a.copy(), rhs.copy()
    ta, trhs = torch.from_numpy(a), torch.from_numpy(rhs)
    gesv(a, rhs, 8, device="cpu")
    gesv(ta, trhs, 8, device="cpu")
    np.testing.assert_array_equal(a, a0)
    np.testing.assert_array_equal(rhs, rhs0)
    with pytest.raises(ValueError, match="rhs rows"):
        lu_factor(a, 8, device="cpu").solve(rhs[:5])
