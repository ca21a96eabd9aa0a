"""The port's serving path against the reference, on the CPU.

Reduced phi3-medium-14b (``reduced_config``: 2 layers, d 128, 4 query heads
over 1 KV head, head dim 32, attention chunks of 64, float32), with the
reference's seeded weights carried across by ``params_from_numpy``: the
full forward, ``prefill`` (prompt 128, so the chunk loops run twice) with
its cache, and 3 ``decode_step``s, each against the reference's.  Both
sides compute in float32 and differ by summation order only, so logits are
held to 1e-5 of the largest |logit| (measured: under 1e-6 of it) and the
cache to 1e-5 of its largest entry.  The engine, the registry, the copied
configs and metrics, and the weight carrier are checked beside them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.models import api as ref_api
from repro.obs import metrics as ref_metrics
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels import attention as attn
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, convert
from repro_torch.obs import metrics
from repro_torch.serve.engine import ServeConfig, ServeEngine

ARCH = "phi3-medium-14b"
B, PROMPT, TOTAL, STEPS = 2, 128, 192, 3


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def cfgs():
    return ref_reduced_config(ref_get_config(ARCH)), \
        reduced_config(get_config(ARCH))


@pytest.fixture(scope="module")
def run(cfgs):
    """The reference's and the port's outputs on one token sequence."""
    cfg_r, cfg = cfgs
    params_r, _ = ref_api.init_params(cfg_r, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params_r)
    params = convert.params_from_numpy(cfg, params_np, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, TOTAL)).astype(np.int32)
    out = {"params_np": params_np, "params": params, "tokens": tokens}
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


def test_configs_equal_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(ref_get_config(ARCH))
    assert dataclasses.asdict(reduced_config(get_config(ARCH))) == \
        dataclasses.asdict(ref_reduced_config(ref_get_config(ARCH)))


@pytest.mark.parametrize("arch", [a for a in REF_ARCH_IDS if a != ARCH])
def test_registry_refuses_archs_not_ported(arch):
    assert arch not in ARCH_IDS
    with pytest.raises(KeyError, match="Queue 1 item 18"):
        get_config(arch)


def test_full_forward_matches_reference(run):
    assert run["full"].dtype == torch.float32
    assert run["full"].shape == run["full_r"].shape
    _close(run["full"], run["full_r"])


def test_prefill_logits_and_cache_match_reference(run):
    (lg_r, c_r), (lg, c) = run["prefill_r"], run["prefill"]
    assert lg.shape == lg_r.shape == (B, 1, 512)
    _close(lg, lg_r)
    ref_c = c_r["seg0"]["c0"]
    for name in ("k", "v"):
        _close(c[name], ref_c[name])
    np.testing.assert_array_equal(c["pos"].numpy(), ref_c["pos"])


@pytest.mark.parametrize("step", range(STEPS))
def test_decode_steps_match_reference(run, step):
    _close(run["decode"][step], run["decode_r"][step])
    # teacher-forced: the full forward's row at the same position
    _close(run["decode"][step][:, 0], run["full_r"][:, PROMPT + step])


def test_decode_cache_matches_reference(run):
    c, c_r = run["cache"]["seg0"]["c0"], run["cache_r"]["seg0"]["c0"]
    for name in ("k", "v"):
        _close(c[name], c_r[name])
    np.testing.assert_array_equal(c["pos"].numpy(), c_r["pos"])


def test_weight_carrier_round_trips_and_checks_shapes(run, cfgs):
    back = convert.params_to_numpy(run["params"])
    flat = jax.tree_util.tree_leaves_with_path(run["params_np"])
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    bad = jax.tree.map(lambda a: a, run["params_np"])
    bad["seg0"]["p0"]["attn"]["wq"] = bad["seg0"]["p0"]["attn"]["wq"][:, 1:]
    with pytest.raises(ValueError, match="attn/wq: shape"):
        convert.params_from_numpy(cfgs[1], bad, device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(cfgs[1], bad, device="cpu")


def test_weight_carrier_takes_bfloat16_bits(cfgs):
    # the reference's default dtype: NumPy bfloat16 leaves keep their bits
    cfg_r, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfgs)
    params_r, _ = ref_api.init_params(cfg_r, jax.random.PRNGKey(1))
    params_np = jax.tree.map(np.asarray, params_r)
    params = convert.params_from_numpy(cfg, params_np, device="cpu")
    wq = params["seg0"]["p0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        params_np["seg0"]["p0"]["attn"]["wq"].astype(np.float32))
    back = convert.params_to_numpy(params)
    assert back["embed"]["tok"].dtype == np.float32


def test_init_params_follows_the_reference_tree_and_scales(cfgs):
    cfg_r, cfg = cfgs
    params = api.init_params(cfg, 3, device="cpu")
    ref_shapes = jax.tree.map(
        lambda a: a.shape, jax.eval_shape(
            lambda: ref_api.init_params(cfg_r, jax.random.PRNGKey(0))[0]))
    ours = jax.tree.map(lambda t: tuple(t.shape), params)
    assert ours == ref_shapes
    wq = params["seg0"]["p0"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 * cfg.d_model ** -0.5
    # N(0, 1) truncated to [-2, 2] has standard deviation 0.8796
    assert abs(float(wq.std()) / cfg.d_model ** -0.5 - 0.8796) < 0.02
    again = api.init_params(cfg, 3, device="cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])


def test_engine_greedy_tokens_are_the_argmax_of_its_logits(run, cfgs):
    cfg, params = cfgs[1], run["params"]
    prompts = run["tokens"][:, :PROMPT]
    sc = ServeConfig(batch_size=B, max_len=PROMPT + 8)
    tokens, stats = ServeEngine(cfg, params, sc).generate(prompts, 5)
    assert tokens.shape == (B, 5)
    for key in metrics.SUMMARY_KEYS + ("prefill_s", "decode_s",
                                       "decode_tok_per_s"):
        assert key in stats
    lg, cache = api.prefill(cfg, params, {"tokens": prompts},
                            max_len=sc.max_len)
    want = [lg[:, -1].argmax(-1).numpy()]
    for i in range(4):
        lg, cache = api.decode_step(cfg, params, cache, want[-1][:, None],
                                    PROMPT + i)
        want.append(lg[:, -1].argmax(-1).numpy())
    np.testing.assert_array_equal(tokens, np.stack(want, axis=1))


def test_engine_temperature_sampling_is_seeded(run, cfgs):
    cfg, params = cfgs[1], run["params"]
    prompts = run["tokens"][:, :64]
    sc = ServeConfig(batch_size=B, max_len=80, temperature=1.0, seed=5)
    a, _ = ServeEngine(cfg, params, sc).generate(prompts, 6)
    b, _ = ServeEngine(cfg, params, sc).generate(prompts, 6)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_engine_and_api_refuse_what_the_cache_cannot_hold(run, cfgs):
    cfg, params = cfgs[1], run["params"]
    prompts = run["tokens"][:, :64]
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(cfg, params, ServeConfig(batch_size=B, max_len=66)) \
            .generate(prompts, 4)
    with pytest.raises(ValueError, match="batch"):
        ServeEngine(cfg, params, ServeConfig(batch_size=3, max_len=80)) \
            .generate(prompts, 4)
    _, cache = api.prefill(cfg, params, {"tokens": prompts}, max_len=64)
    with pytest.raises(ValueError, match="outside the cache"):
        api.decode_step(cfg, params, cache, prompts[:, :1], 64)
    with pytest.raises(ValueError, match="exceeds the cache"):
        api.prefill(cfg, params, {"tokens": prompts}, max_len=32)


@pytest.mark.parametrize("change", [
    {"pattern": ("rwkv",)}, {"pattern": ("local",), "local_window": 32},
    {"pattern": ("rg",)}, {"encoder_layers": 2}])
def test_unported_blocks_raise_naming_their_item(cfgs, change):
    cfg = dataclasses.replace(cfgs[1], **change)
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        params = api.init_params(cfg, 0, device="cpu")
        api.prefill(cfg, params, {"tokens": np.zeros((1, 8), np.int32)}, 8)


def test_launch_serve_smoke_on_the_cpu(capsys):
    before = attn.flash_attention.launches
    tokens, stats = launch_serve.main(["--smoke", "--device", "cpu",
                                       "--batch", "2", "--prompt-len", "16",
                                       "--new-tokens", "3", "--max-len",
                                       "32"])
    assert tokens.shape == (2, 3) and stats["prefill_s"] > 0
    assert "phi3-medium-14b-smoke on cpu" in capsys.readouterr().out
    assert attn.flash_attention.launches == before


def test_metrics_copy_matches_reference():
    lat = [0.004, 0.001, 0.003, 0.010, 0.002]
    assert metrics.throughput_summary(2.0, 10, latency=lat) == \
        ref_metrics.throughput_summary(2.0, 10, latency=lat)
    assert metrics.SUMMARY_KEYS == ref_metrics.SUMMARY_KEYS
    ours, theirs = metrics.Metrics(), ref_metrics.Metrics()
    for m in (ours, theirs):
        m.counter("a").inc(3)
        m.gauge("b").set(2)
        for v in lat:
            m.histogram("c").record(v)
    assert ours.snapshot() == theirs.snapshot()
