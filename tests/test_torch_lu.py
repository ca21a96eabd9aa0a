"""The port's LU engine against the reference, on the CPU.

* Within the port, every schedule of the ``"cuda"`` backend (its plain
  kernel versions on the CPU) gives **bitwise** the same factors:
  la ≡ la2 ≡ la3 ≡ mtb ≡ rtm, as the reference promises for its own engine.
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
from repro.obs import tracer as ref_tracer
from repro_torch.core import lookahead, lu, pipeline
from repro_torch.obs import tracer

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
    for variant in ("rtm", "la", "la2", "la3"):
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


@pytest.mark.parametrize("variant", ["mtb", "la2"])
def test_engine_issues_hooks_in_reference_order(variant):
    a = _rand((20, 20), 6, np.float64)
    with ref_tracer.trace(fence=False) as ref_tr:
        # the reference's own panel, jitted through its panel_fns hook
        ref_get_variant("lu", variant)(jnp.asarray(a), [8, 4],
                                       backend=REF_BACKEND)
    with tracer.trace(fence=False) as tr:
        lookahead.get_variant("lu", variant)(a, [8, 4], device="cpu")
    assert _span_keys(tr.spans) == _span_keys(ref_tr.spans)
    assert tr.by_cat("PF") and tr.total() >= 0.0


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
    assert lookahead.list_variants("lu") == ("mtb", "rtm", "la", "la2")
    assert lookahead.parse_variant("la3") == ("la", 3)
    assert lookahead.parse_variant("mtb") == ("mtb", 1)
    assert lookahead.deepen("la", 2) == "la2"
    assert lookahead.deepen("la", 1) == "la"
    with pytest.raises(ValueError):
        lookahead.deepen("mtb", 2)
    with pytest.raises(KeyError, match="Queue 2 item 5"):
        lookahead.get_variant("lu", "la_mb")
    with pytest.raises(KeyError, match="Queue 1 item 13"):
        lookahead.get_variant("lu", "tuned")
    with pytest.raises(KeyError):
        lookahead.get_variant("cholesky", "la")
    with pytest.raises(KeyError):
        lookahead.get_variant("lu", "rtm2")
    with pytest.raises(ValueError, match="pins depth=2"):
        lookahead.get_variant("lu", "la2")(np.eye(4), 2, depth=3,
                                           device="cpu")


def test_engine_rejects_what_it_does_not_run():
    a = np.eye(4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        pipeline.factorize(lu.LU_OPS, a, 2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="square"):
        lu.lu_blocked(np.ones((4, 3)), 2, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        lu.lu_lookahead(a, 2, depth=0, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        lu.lu_blocked(a, 2, backend="jnp", device="cpu")
