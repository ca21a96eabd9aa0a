"""The port's optimizers, compression, schedules and data sources against
the reference, on the CPU.

A small param tree (two 2-D leaves that DMF-Shampoo preconditions, a 1-D
leaf, a stacked 3-D leaf and a 2-D leaf with a dim under 8, all of which
take Adam) and seeded NumPy gradients go through both packages.  The
updates start from a state in the middle of training: the reference runs
some steps, its state is carried across, and then both run the same
steps.  Both compute in float32 with the same formulas; they differ by
summation order in the products (and the roots' 12 Newton iterations).
Tolerances: params within 1e-6 of each leaf's largest entry (measured
under 2e-7), moments and statistics within 1e-5 (measured 2e-7), roots
within 1e-3 (measured 7e-5: the (96, 96) statistic of an (8, 96) leaf
has rank at most 72 after 9 steps, so its damped inverse 4th root
amplifies rounding).  The schedules agree to 5e-7 relative (a few float32
ulps), the bf16 and the nearest-rounding int8 compression bitwise, the
data sources bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import pipeline as ref_pipeline
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_sched
from repro.optim import shampoo as ref_shampoo
from repro_torch import tree
from repro_torch.data import pipeline
from repro_torch.optim import adamw, schedule, shampoo
from repro_torch.optim.compression import GradCompression

SHAPES = {"a": (64, 32), "b": {"c": (16,), "d": (3, 16, 8)}, "e": (8, 96),
          "f": (5, 40)}


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree_np):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree_np)


def _jax(tree_np):
    return jax.tree.map(jnp.asarray, tree_np)


def _close(got_tree, want_tree, tol):
    got = tree.leaves(got_tree)
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        if w.size:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * max(np.abs(w).max(), 1e-30))


def _run(make, steps_ref, steps_both):
    """The reference optimizer ``steps_ref`` steps, its state carried
    across, then both ``steps_both`` more on the same gradients; yields
    (step, port params, port state, ref params, ref state) after each."""
    ref_opt, opt, state_cls = make()
    params_r = _jax(_np_tree(0, 0.1))
    state_r = ref_opt.init(params_r)
    update_r = jax.jit(ref_opt.update)
    for i in range(steps_ref):
        upd, state_r = update_r(_jax(_np_tree(100 + i)), state_r, params_r)
        params_r = ref_adamw.apply_updates(params_r, upd)
    params = _torch(jax.tree.map(np.asarray, params_r))
    state = state_cls(*(_torch(jax.tree.map(np.asarray, x)) for x in state_r))
    for i in range(steps_ref, steps_ref + steps_both):
        grads = _np_tree(100 + i)
        upd, state_r = update_r(_jax(grads), state_r, params_r)
        params_r = ref_adamw.apply_updates(params_r, upd)
        upd, state = opt.update(_torch(grads), state, params)
        params = adamw.apply_updates(params, upd)
        yield i + 1, params, state, params_r, state_r


def _adamw():
    return (ref_adamw.AdamW(learning_rate=ref_sched.warmup_cosine(1e-2, 3, 30),
                            weight_decay=0.05),
            adamw.AdamW(learning_rate=schedule.warmup_cosine(1e-2, 3, 30),
                        weight_decay=0.05),
            adamw.AdamWState)


def _shampoo():
    kw = dict(weight_decay=0.01, refresh_every=3)
    return (ref_shampoo.DMFShampoo(
                learning_rate=ref_sched.warmup_cosine(1e-2, 3, 30), **kw),
            shampoo.DMFShampoo(
                learning_rate=schedule.warmup_cosine(1e-2, 3, 30), **kw),
            shampoo.ShampooState)


@pytest.mark.parametrize("steps_ref", [0, 5])
def test_adamw_updates(steps_ref):
    """From a fresh state and from step 5: three updates each."""
    for step, params, state, params_r, state_r in _run(_adamw, steps_ref, 3):
        assert int(state.step) == step == int(state_r.step)
        _close(params, params_r, 1e-6)
        _close(state.m, state_r.m, 1e-5)
        _close(state.v, state_r.v, 1e-5)


def test_adamw_update_dtype():
    """Moments float32, updates in the param's dtype (bfloat16 here)."""
    opt = adamw.AdamW(learning_rate=1e-3)
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.float32
    upd, state = opt.update({"w": torch.ones(4, 4, dtype=torch.bfloat16)},
                            state, params)
    assert upd["w"].dtype == torch.bfloat16 and int(state.step) == 1


def test_shampoo_updates_refresh_and_not():
    """From step 6 (roots refreshed at steps 3 and 6, not the identity),
    three steps: step 7 and 8 refresh no 2-D leaf of the first residue
    class, step 9 refreshes leaves 0 and 3 (``a`` and ``e``: 9 % 3 == 0),
    each side's roots and statistics held to the other's."""
    opt = _shampoo()[1]
    kron = [opt._is_kron(p) for p in tree.leaves(_torch(_np_tree(0)))]
    assert kron == [True, False, False, True, False]
    for step, params, state, params_r, state_r in _run(_shampoo, 6, 3):
        _close(params, params_r, 1e-6)
        for name in ("l_stats", "r_stats", "adam_m", "adam_v"):
            _close(getattr(state, name), getattr(state_r, name), 1e-5)
        for name in ("l_root", "r_root"):
            _close(getattr(state, name), getattr(state_r, name), 1e-3)
        roots = [r for r in tree.leaves(state.l_root) if r.numel()]
        assert not any(torch.equal(r, torch.eye(r.shape[0])) for r in roots)
        assert [opt.refreshes(step, i) for i in (0, 3)] == [step % 3 == 0] * 2


def test_shampoo_init_shapes():
    """Stats and roots (d, d) for the preconditioned leaves, (0, 0) for the
    others (a segment's stacked 3-D weights among them)."""
    opt = shampoo.DMFShampoo()
    st = opt.init(_torch(_np_tree(0)))
    assert st.l_stats["a"].shape == (64, 64)
    assert st.r_root["e"].shape == (96, 96)
    assert torch.equal(st.r_root["e"], torch.eye(96))
    assert st.l_stats["b"]["d"].shape == (0, 0)
    assert st.l_root["f"].shape == (0, 0)


def _spd(n, seed):
    g = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    return g @ g.T + n * np.eye(n, dtype=np.float32)


def test_inv_fourth_root():
    """Against the reference's (1e-5 of the largest entry) and accurate:
    ‖X⁴·A − I‖_F / n < 5e-2 at 16 iterations, as the reference's test."""
    a = _spd(32, 4)
    for iters in (12, 16):
        x = shampoo.inv_fourth_root(torch.from_numpy(a), iters=iters)
        want = np.asarray(ref_shampoo.inv_fourth_root(jnp.asarray(a),
                                                      iters=iters))
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    x4 = x @ x @ x @ x
    err = torch.linalg.norm(x4 @ torch.from_numpy(a) - torch.eye(32)) / 32
    assert float(err) < 5e-2


@pytest.mark.parametrize("n", [32, 64, 40])
def test_cholesky_norm_seed(n):
    """The seed against the reference's (1e-5 relative; n 40 falls back to
    one block) and its bracket of ‖A‖₂: seed ≤ 1.001·‖A‖₂ ≤ 1.001·n·seed."""
    a = _spd(n, n)
    seed = float(shampoo.cholesky_norm_seed(torch.from_numpy(a)))
    want = float(ref_shampoo.cholesky_norm_seed(jnp.asarray(a)))
    assert abs(seed - want) <= 1e-5 * want
    true = float(np.linalg.norm(a.astype(np.float64), 2))
    assert seed <= true * 1.001 and true <= n * seed


def test_compression_matches_reference():
    """bf16 and nearest-rounding int8, with and without error feedback,
    bitwise the reference's over three rounds."""
    grads = {"w": _np_tree(7)["a"], "v": _np_tree(8)["b"]["c"]}
    for mode in ("bf16", "int8"):
        for feedback in (True, False):
            ref = ref_comp.GradCompression(mode=mode, error_feedback=feedback)
            comp = GradCompression(mode=mode, error_feedback=feedback)
            res_r, res = ref.init(_jax(grads)), comp.init(_torch(grads))
            for _ in range(3):
                q_r, res_r = ref.compress(_jax(grads), res_r)
                q, res = comp.compress(_torch(grads), res)
                for a, b in zip(tree.leaves(q), jax.tree.leaves(q_r)):
                    assert np.array_equal(a.numpy(), np.asarray(b))
                assert (res is None) == (res_r is None)
                if res is not None:
                    for a, b in zip(tree.leaves(res), jax.tree.leaves(res_r)):
                        assert np.array_equal(a.numpy(), np.asarray(b))
    g = {"w": torch.ones(3)}
    assert GradCompression().compress(g, None) == (g, None)


@pytest.mark.parametrize("stochastic", [False, True])
def test_compression_error_feedback_bound(stochastic):
    """The reference's error-feedback test: eight rounds of compressed
    gradients sum to eight true ones within 0.02 (bf16) and 0.2 (int8);
    stochastic int8 rounding draws from the generator given, the same
    draws for the same seed."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    for mode in ("bf16", "int8"):
        comp = GradCompression(mode=mode)
        residual = comp.init({"w": w})
        gen = torch.Generator().manual_seed(5) if stochastic else None
        total = torch.zeros_like(w)
        for _ in range(8):
            q, residual = comp.compress({"w": w}, residual, generator=gen)
            total += q["w"]
        err = float((total - 8 * w).abs().max())
        assert err < (0.02 if mode == "bf16" else 0.2), (mode, err)
    if stochastic:
        comp = GradCompression(mode="int8", error_feedback=False)
        draws = [comp.compress({"w": w}, None, torch.Generator().manual_seed(
            9))[0]["w"] for _ in range(2)]
        assert torch.equal(*draws)
        assert not torch.equal(draws[0], comp.compress({"w": w}, None)[0]["w"])


def test_schedules():
    for ref, port in ((ref_sched.warmup_cosine(3e-4, 5, 40),
                       schedule.warmup_cosine(3e-4, 5, 40)),
                      (ref_sched.warmup_cosine(1e-3, 0, 10, floor=0.0),
                       schedule.warmup_cosine(1e-3, 0, 10, floor=0.0)),
                      (ref_sched.constant(2e-3), schedule.constant(2e-3))):
        for step in range(0, 45):
            want = float(ref(jnp.asarray(step, jnp.int32)))
            got = port(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - want) <= 5e-7 * max(abs(want), 1e-12)


def test_data_sources_bitwise(tmp_path):
    """``SyntheticTask`` (with and without noise) and ``TokenFileSource``
    batches bitwise the reference's, over steps and shards."""
    for kw in (dict(vocab_size=512, seq_len=32), dict(
            vocab_size=100352, seq_len=64, noise=0.0, seed=3)):
        ref, port = ref_pipeline.SyntheticTask(**kw), \
            pipeline.SyntheticTask(**kw)
        for step, shard in ((0, 0), (7, 1)):
            a, b = ref.batch(step, shard, 2, 4), port.batch(step, shard, 2, 4)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
    path = tmp_path / "corpus.bin"
    np.random.default_rng(2).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(path=str(path), vocab_size=512, seq_len=48, seed=1)
    ref = ref_pipeline.make_source("file", **kw)
    port = pipeline.make_source("file", **kw)
    for step in (0, 3):
        a, b = ref.batch(step, 0, 1, 6), port.batch(step, 0, 1, 6)
        for k in a:
            assert np.array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        pipeline.make_source("nope")
