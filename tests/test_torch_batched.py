"""The port's batched drivers on the CPU, against its unbatched drivers and
against the reference's batched drivers.

``repro_torch.solve.batched`` runs the systems one after another through
the port's unbatched drivers, so every slot must be bitwise that driver's
answer, with ``variant``/``depth`` and block schedules forwarded (the
reference's ``test_batched_wrappers_forward_depth_and_schedule``).
Batched factor objects (``stack_factors``/``factors_at``) carry a batch
across the two packages: a batch the reference factored (``lu (B,n,n)``,
``ipiv (B,n)``; ``l (B,n,n)``) is solved by the port's ``solve_batched``,
and the port's batch goes back through ``to_numpy`` to the reference's
``solve_batched``, both within the reference's 200·max(m,n,8)·eps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solve import batched as ref_batched
from repro.solve.factors import CholeskyFactors as RefCholeskyFactors
from repro.solve.factors import LUFactors as RefLUFactors
from repro_torch.solve import (CholeskyFactors, LUFactors, QRFactors,
                               batched, cholesky_factor, drivers, factors_at,
                               lu_factor, qr_factor, solve_batched,
                               stack_factors)

jax.config.update("jax_enable_x64", True)

CPU = dict(device="cpu")


def _stack(b, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n)).astype(dtype)
    spd = np.einsum("bij,bkj->bik", a, a) + n * np.eye(n, dtype=dtype)
    return a, spd.astype(dtype), rng.standard_normal((b, n, k)).astype(dtype)


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_wrappers_forward_depth_and_schedule(dtype, depth):
    """Every slot bitwise the unbatched driver, a BlockSpec schedule and
    ``depth`` forwarded."""
    a, spd, b = _stack(3, 64, 2, dtype)
    sched = (16, 16, 32)
    got = batched.gesv_batched(a, b, sched, depth=depth, **CPU)
    gotp = batched.posv_batched(spd, b, 32, depth=depth, **CPU)
    assert got.shape == (3, 64, 2) and got.device.type == "cpu"
    for i in range(3):
        assert torch.equal(got[i], drivers.gesv(a[i], b[i], sched,
                                                depth=depth, **CPU))
        assert torch.equal(gotp[i], drivers.posv(spd[i], b[i], 32,
                                                 depth=depth, **CPU))
    fb = batched.lu_factor_batched(a, sched, depth=depth, **CPU)
    cb = batched.cholesky_factor_batched(spd, 32, depth=depth, **CPU)
    assert fb.lu.shape == (3, 64, 64) and fb.ipiv.shape == (3, 64)
    assert fb.perm.shape == (3, 64) and cb.l.shape == (3, 64, 64)
    for i in range(3):
        f0 = drivers.lu_factor(a[i], sched, depth=depth, **CPU)
        assert torch.equal(fb.lu[i], f0.lu)
        assert torch.equal(fb.ipiv[i], f0.ipiv)
        assert torch.equal(fb.perm[i], f0.perm)
        c0 = drivers.cholesky_factor(spd[i], 32, depth=depth, **CPU)
        assert torch.equal(cb.l[i], c0.l)


@pytest.mark.parametrize("variant", ["mtb", "rtm", "la_mb"])
def test_batched_wrappers_forward_variant(variant):
    a, spd, b = _stack(2, 40, 3, "float64", seed=1)
    got = batched.gesv_batched(a, b, 16, variant=variant, **CPU)
    gotp = batched.posv_batched(spd, b[:, :, 0], 16, variant=variant, **CPU)
    assert gotp.shape == (2, 40)                       # vector RHS
    for i in range(2):
        assert torch.equal(got[i], drivers.gesv(a[i], b[i], 16,
                                                variant=variant, **CPU))
        assert torch.equal(gotp[i], drivers.posv(spd[i], b[i, :, 0], 16,
                                                 variant=variant, **CPU))


def test_solve_batched_is_the_per_system_solve():
    a, spd, b = _stack(4, 48, 2, "float64", seed=2)
    _, _, b2 = _stack(4, 48, 3, "float64", seed=3)
    fb = batched.lu_factor_batched(a, 32, **CPU)
    cb = batched.cholesky_factor_batched(spd, 32, **CPU)
    for rhs in (b, b2):
        xs = solve_batched(fb, torch.from_numpy(rhs))
        xc = solve_batched(cb, torch.from_numpy(rhs))
        for i in range(4):
            assert torch.equal(xs[i], factors_at(fb, i).solve(rhs[i]))
            assert torch.equal(xs[i], drivers.gesv(a[i], rhs[i], 32, **CPU))
            assert torch.equal(xc[i], drivers.posv(spd[i], rhs[i], 32,
                                                   **CPU))
            assert _rel(a[i] @ xs[i].numpy(), rhs[i]) < _tol(48, np.float64)


def test_stack_and_take_factors():
    a, _, b = _stack(3, 24, 1, "float64", seed=4)
    fs = [lu_factor(a[i], 8, **CPU) for i in range(3)]
    st = stack_factors(fs)
    assert isinstance(st, LUFactors) and st.block == 8 and st.n == 24
    assert st.backend is fs[0].backend
    for i in range(3):
        one = factors_at(st, i)
        for name in ("lu", "ipiv", "perm"):
            assert torch.equal(getattr(one, name), getattr(fs[i], name))
    # QR factors batch the same way
    qs = stack_factors([qr_factor(a[i], 8, **CPU) for i in range(2)])
    assert isinstance(qs, QRFactors) and qs.packed.shape == (2, 24, 24)
    with pytest.raises(ValueError, match="solve_batched"):
        st.solve(b[0])
    with pytest.raises(ValueError, match="share"):
        stack_factors([fs[0], cholesky_factor(a[0] @ a[0].T + 24 * np.eye(24),
                                              8, **CPU)])
    with pytest.raises(ValueError, match="share"):
        stack_factors([fs[0], lu_factor(a[1], 16, **CPU)])
    with pytest.raises(ValueError):
        stack_factors([])
    with pytest.raises(ValueError, match="one system"):
        solve_batched(fs[0], b)
    with pytest.raises(ValueError, match="do not match"):
        solve_batched(st, b[:2])


def test_mesh_raises_naming_item_17():
    """The mesh path (ROADMAP item 17) takes a DeviceMesh: anything else is
    a TypeError naming the type it expects, from every batched entry (the
    mesh loop itself runs in ``tests/test_torch_distributed.py``)."""
    a, spd, b = _stack(1, 8, 1, "float64")
    for fn, args in ((batched.gesv_batched, (a, b)),
                     (batched.posv_batched, (spd, b)),
                     (batched.lu_factor_batched, (a,)),
                     (batched.cholesky_factor_batched, (spd,))):
        with pytest.raises(TypeError, match="expects a torch.distributed"):
            fn(*args, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="batch"):
        batched.gesv_batched(a[0], b[0], **CPU)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lu_batch_carried_across_both_ways(dtype):
    """A batch the reference factored is solved by the port, and the
    port's batch by the reference."""
    a, _, b = _stack(3, 32, 2, dtype, seed=5)
    tol = _tol(32, dtype)
    ref_fb = ref_batched.lu_factor_batched(jnp.asarray(a), 16)
    ref_x = np.asarray(ref_batched.solve_batched(ref_fb, jnp.asarray(b)))
    port_fb = LUFactors.from_numpy(np.asarray(ref_fb.lu),
                                   np.asarray(ref_fb.ipiv), block=16, **CPU)
    assert port_fb.perm.shape == (3, 32)
    np.testing.assert_array_equal(port_fb.perm.numpy(),
                                  np.asarray(ref_fb.perm))
    x = solve_batched(port_fb, torch.from_numpy(b))
    assert _rel(x, ref_x) < tol
    for i in range(3):
        one = LUFactors.from_numpy(np.asarray(ref_fb.lu[i]),
                                   np.asarray(ref_fb.ipiv[i]), block=16,
                                   **CPU)
        assert torch.equal(x[i], one.solve(b[i]))
    # and back: the port's batch, as NumPy, into the reference's factors
    lu, ipiv, perm = batched.lu_factor_batched(a, 16, **CPU).to_numpy()
    assert lu.shape == (3, 32, 32) and ipiv.shape == perm.shape == (3, 32)
    back = RefLUFactors(lu=jnp.asarray(lu), ipiv=jnp.asarray(ipiv),
                        perm=jnp.asarray(perm), block=16)
    assert _rel(ref_batched.solve_batched(back, jnp.asarray(b)), ref_x) < tol


def test_cholesky_batch_carried_across_both_ways():
    _, spd, b = _stack(3, 32, 2, "float64", seed=6)
    tol = _tol(32, np.float64)
    ref_cb = ref_batched.cholesky_factor_batched(jnp.asarray(spd), 16)
    ref_x = np.asarray(ref_batched.solve_batched(ref_cb, jnp.asarray(b)))
    port_cb = CholeskyFactors.from_numpy(np.asarray(ref_cb.l), block=16,
                                         **CPU)
    assert _rel(solve_batched(port_cb, torch.from_numpy(b)), ref_x) < tol
    l = batched.cholesky_factor_batched(spd, 16, **CPU).to_numpy()
    assert l.shape == (3, 32, 32)
    back = RefCholeskyFactors(l=jnp.asarray(l), block=16)
    assert _rel(ref_batched.solve_batched(back, jnp.asarray(b)), ref_x) < tol
