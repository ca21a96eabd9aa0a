"""The port's RWKV6 serving path against the reference, on the CPU.

Reduced rwkv6-7b (``reduced_config``: 2 layers, d 128, 4 heads of 32,
d_ff 256, vocab 512, chunk 16, float32) with the reference's seeded
weights carried across by ``params_from_numpy``: the full forward,
``prefill`` of a ragged prompt (40 tokens = 2 chunks + 8) with its cache
(``s``, ``x_tm``, ``x_cm``), and 3 ``decode_step``s with the cache after
them, each against the reference's.  Both sides compute in float32 and
differ by summation order only, so logits are held to 1e-5 of the largest
|logit| (measured: under 1e-6 of it) and each cache tensor to 1e-5 of its
largest entry.  The engine's greedy tokens, the bfloat16 weight carry
(float32 decay params stay float32), the param tree and the launcher are
checked beside them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import api as ref_api
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import wkv6
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, convert
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCH = "rwkv6-7b"
B, PROMPT, TOTAL, STEPS = 2, 40, 48, 3
F32_LEAVES = ("w0", "wa", "wb", "u")


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def _ref_params(cfg_r, seed):
    """The reference's seeded weights as NumPy.  Its ``init_params`` under
    one jit: the same values as the eager call in about a third of the
    time."""
    params_r = jax.jit(lambda key: ref_api.init_params(cfg_r, key)[0])(
        jax.random.PRNGKey(seed))
    return params_r, jax.tree.map(np.asarray, params_r)


@pytest.fixture(scope="module")
def cfgs():
    return ref_reduced_config(ref_get_config(ARCH)), \
        reduced_config(get_config(ARCH))


@pytest.fixture(scope="module")
def run(cfgs):
    """The reference's and the port's outputs on one token sequence."""
    cfg_r, cfg = cfgs
    params_r, params_np = _ref_params(cfg_r, 0)
    params = convert.params_from_numpy(cfg, params_np, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, TOTAL)).astype(np.int32)
    out = {"params": params, "tokens": tokens}
    out["full_r"] = np.asarray(ref_api.apply_train(
        cfg_r, params_r, {"tokens": jnp.asarray(tokens)}))
    out["full"] = api.apply(cfg, params, {"tokens": tokens})
    lg_r, c_r = ref_api.prefill(cfg_r, params_r,
                                {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                                max_len=TOTAL)
    lg, c = api.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]},
                        max_len=TOTAL)
    out["prefill_r"] = (np.asarray(lg_r), jax.tree.map(np.asarray, c_r))
    out["prefill"] = (lg, {k: t.clone() for k, t in c["seg0"]["c0"].items()})
    out["decode_r"], out["decode"] = [], []
    for i in range(STEPS):
        tok = tokens[:, PROMPT + i:PROMPT + i + 1]
        lg_r, c_r = ref_api.decode_step(cfg_r, params_r, c_r,
                                        jnp.asarray(tok),
                                        jnp.int32(PROMPT + i))
        lg, c = api.decode_step(cfg, params, c, tok, PROMPT + i)
        out["decode_r"].append(np.asarray(lg_r))
        out["decode"].append(lg)
    out["cache_r"], out["cache"] = jax.tree.map(np.asarray, c_r), c
    return out


def test_full_forward_matches_reference(run):
    assert run["full"].dtype == torch.float32
    assert run["full"].shape == run["full_r"].shape == (B, TOTAL, 512)
    _close(run["full"], run["full_r"])


def test_prefill_of_a_ragged_prompt_and_its_cache_match_reference(run):
    (lg_r, c_r), (lg, c) = run["prefill_r"], run["prefill"]
    assert lg.shape == lg_r.shape == (B, 1, 512)
    _close(lg, lg_r)
    ref_c = c_r["seg0"]["c0"]
    assert set(c) == set(ref_c) == {"s", "x_tm", "x_cm"}
    for name in c:
        assert c[name].shape == ref_c[name].shape
        _close(c[name], ref_c[name])


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_steps_match_reference(run, step):
    _close(run["decode"][step], run["decode_r"][step])
    # teacher-forced: the full forward's row at the same position (the
    # clip cannot engage at chunk 16 with these decays)
    _close(run["decode"][step][:, 0], run["full_r"][:, PROMPT + step])


def test_decode_cache_matches_reference(run):
    c, c_r = run["cache"]["seg0"]["c0"], run["cache_r"]["seg0"]["c0"]
    for name in ("s", "x_tm", "x_cm"):
        _close(c[name], c_r[name])


def test_engine_greedy_tokens_are_the_argmax_of_its_logits(run, cfgs):
    cfg, params = cfgs[1], run["params"]
    prompts = run["tokens"][:, :PROMPT]
    sc = ServeConfig(batch_size=B, max_len=PROMPT + 8)
    tokens, _ = ServeEngine(cfg, params, sc).generate(prompts, 5)
    assert tokens.shape == (B, 5)
    lg, cache = api.prefill(cfg, params, {"tokens": prompts},
                            max_len=sc.max_len)
    want = [lg[:, -1].argmax(-1).numpy()]
    for i in range(4):
        lg, cache = api.decode_step(cfg, params, cache, want[-1][:, None],
                                    PROMPT + i)
        want.append(lg[:, -1].argmax(-1).numpy())
    np.testing.assert_array_equal(tokens, np.stack(want, axis=1))


def test_bfloat16_carry_keeps_the_decay_params_float32(cfgs):
    cfg_r, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfgs)
    _, params_np = _ref_params(cfg_r, 1)
    params = convert.params_from_numpy(cfg, params_np, device="cpu")
    blk, blk_np = params["seg0"]["p0"]["rwkv"], params_np["seg0"]["p0"]["rwkv"]
    for name, leaf in blk.items():
        if isinstance(leaf, dict):
            continue
        want = torch.float32 if name in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, name
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      blk_np[name].astype(np.float32))
    back = convert.params_to_numpy(params)["seg0"]["p0"]["rwkv"]
    assert all(back[n].dtype == np.float32 for n in F32_LEAVES)
    np.testing.assert_array_equal(back["wa"], blk_np["wa"])
    # a bfloat16 forward runs and keeps the state in float32
    _, cache = api.prefill(cfg, params, {"tokens": np.zeros((1, 20),
                                                            np.int32)}, 24)
    c = cache["seg0"]["c0"]
    assert c["s"].dtype == torch.float32 and c["x_tm"].dtype == torch.bfloat16


def test_init_params_follows_the_reference_tree_dtypes_and_constants(cfgs):
    cfg_r, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfgs)
    params = api.init_params(cfg, 3, device="cpu")
    ref = jax.eval_shape(
        lambda: ref_api.init_params(cfg_r, jax.random.PRNGKey(0))[0])
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).replace("torch.", "")), params)
    blk = params["seg0"]["p0"]["rwkv"]
    assert torch.all(blk["w0"] == -0.6) and torch.all(blk["mu"] == 0.5) \
        and torch.all(blk["mu_c"] == 0.5) and torch.all(blk["ln_x"] == 1)
    # N(0, 1) truncated to [-2, 2] has standard deviation 0.8796
    assert abs(float(blk["u"].std()) / 0.5 - 0.8796) < 0.05


def test_launch_serve_smoke_on_the_cpu(capsys):
    before = wkv6.wkv6_fused.launches
    tokens, stats = launch_serve.main(["--arch", ARCH, "--smoke", "--device",
                                       "cpu", "--batch", "2", "--prompt-len",
                                       "20", "--new-tokens", "3",
                                       "--max-len", "32"])
    assert tokens.shape == (2, 3) and stats["prefill_s"] > 0
    assert "rwkv6-7b-smoke on cpu" in capsys.readouterr().out
    assert wkv6.wkv6_fused.launches == before      # CPU: the plain version
