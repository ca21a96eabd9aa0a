"""The port's trainer, checkpoints and fault-tolerance pieces, on the CPU.

One trainer step against the reference's ``Trainer``: reduced
phi3-medium-14b (float32), both started from one state in the middle of
training (the reference's after 4 AdamW steps, or after 10 DMF-Shampoo
steps of a one-layer model whose unstacked 2-D weights Shampoo
preconditions, its roots no longer the identity), carried across by
``convert.train_state_from_numpy``; then two steps each on the same
batches, with 1 and 2 microbatches.  Both compute in float32 and differ by
summation order: loss and gradient norm within 1e-6 relative, every param
leaf within 1e-6 of its largest entry (measured under 2e-7).  From a
fresh state the first Adam steps turn gradients at rounding level into
full ±lr steps, so the comparison starts mid-training.

Then the port of the reference's convergence-and-resume test, the
checkpoints (atomic saves, cleanup, bfloat16 bits, dtypes restored), the
straggler watchdog on a fake clock, preemption by SIGTERM and the
launcher.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTask as RefSyntheticTask
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import tree
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticTask
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.shampoo import ShampooState
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerWatchdog,
                                               elastic_reshard)
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "phi3-medium-14b"


def _cfgs(layers):
    return (dataclasses.replace(ref_reduced_config(ref_get_config(ARCH)),
                                num_layers=layers),
            dataclasses.replace(reduced_config(get_config(ARCH)),
                                num_layers=layers))


@pytest.mark.parametrize("optimizer, layers, before, micro", [
    ("adamw", 2, 4, (1, 2)), ("shampoo", 1, 10, (1,))])
def test_trainer_step_matches_reference(optimizer, layers, before, micro):
    cfg_r, cfg = _cfgs(layers)
    kw = dict(steps=20, per_device_batch=4, optimizer=optimizer,
              peak_lr=2e-3, warmup_steps=2, log_every=1000)
    src_r = RefSyntheticTask(vocab_size=cfg.vocab_size, seq_len=32)
    src = SyntheticTask(vocab_size=cfg.vocab_size, seq_len=32)
    ref = RefTrainer(cfg_r, RefTrainerConfig(**kw), src_r)
    for i in range(before):
        ref.state, _ = ref._step_fn(ref.state, ref._host_batch(i))
    start = jax.tree.map(np.asarray, ref.state)
    if optimizer == "shampoo":
        roots = [r for r in jax.tree.leaves(start.opt_state.l_root) if r.size]
        assert roots and not all(np.array_equal(r, np.eye(len(r)))
                                 for r in roots)
    for n_micro in micro:
        tc = TrainerConfig(microbatches=n_micro, **kw)
        if n_micro > 1:          # else the trainer above, at ``start``
            ref = RefTrainer(cfg_r, RefTrainerConfig(microbatches=n_micro,
                                                     **kw), src_r)
            ref.state = jax.tree.map(jax.numpy.asarray, start)
        port = Trainer(cfg, tc, src, device="cpu")
        port.state = convert.train_state_from_numpy(cfg, start, "cpu")
        assert isinstance(port.state.opt_state,
                          AdamWState if optimizer == "adamw" else ShampooState)
        for i in range(before, before + 2):
            ref.state, m_r = ref._step_fn(ref.state, ref._host_batch(i))
            port.state, m = port.train_step(port.state, port._host_batch(i))
            for key in ("loss", "grad_norm"):
                want = float(m_r[key])
                assert abs(float(m[key]) - want) <= 1e-6 * want, key
            assert int(port.state.step) == i + 1
            for got, want in zip(tree.leaves(port.state.params),
                                 jax.tree.leaves(ref.state.params)):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-6 * np.abs(want).max())


def test_train_state_round_trip():
    """``train_state_to_numpy`` then ``train_state_from_numpy`` gives the
    same state, bitwise (bfloat16 params through float32)."""
    cfg = dataclasses.replace(reduced_config(get_config("rwkv6-7b")),
                              dtype="bfloat16")
    tr = Trainer(cfg, TrainerConfig(optimizer="shampoo", compression="bf16"),
                 SyntheticTask(vocab_size=cfg.vocab_size, seq_len=8),
                 device="cpu")
    back = convert.train_state_from_numpy(
        cfg, convert.train_state_to_numpy(tr.state), "cpu")
    for a, b in zip(tree.leaves(tr.state), tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        convert.train_state_from_numpy(cfg, convert.train_state_to_numpy(
            tr.state)._replace(opt_state=(1, 2)), "cpu")


def test_trainer_converges_and_resumes(tmp_path):
    """The reference's test: 24 AdamW steps on the noiseless synthetic task
    take the loss below 0.7 of the first; a new trainer resumes from the
    step-24 checkpoint and runs the two steps to 26."""
    cfg = reduced_config(get_config(ARCH))
    src = SyntheticTask(vocab_size=cfg.vocab_size, seq_len=32, noise=0.0)
    tc = TrainerConfig(steps=24, per_device_batch=8, optimizer="adamw",
                       peak_lr=2e-3, warmup_steps=4, ckpt_dir=str(tmp_path),
                       ckpt_every=8, log_every=100)
    hist = Trainer(cfg, tc, src, device="cpu").run()
    assert hist[-1] < hist[0] * 0.7, hist[:2] + hist[-2:]
    # every 8 steps, and at a step the watchdog flags (a loaded machine)
    assert ckpt.list_checkpoints(str(tmp_path))[-1] == 24
    tr2 = Trainer(cfg, tc, src, device="cpu")
    assert len(tr2.run(steps=26)) == 2
    assert int(tr2.state.step) == 26


def test_checkpoint_atomic_and_cleanup(tmp_path):
    state = {"a": torch.arange(8.0), "nested": {"b": torch.ones(3, 3)}}
    d = str(tmp_path)
    os.makedirs(os.path.join(d, ".tmp_99"))          # an interrupted save
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(d, step, state, keep=2)
    assert ckpt.list_checkpoints(d) == [4, 5]
    assert ckpt.latest_checkpoint(d).endswith("step_00000005")
    restored, manifest = ckpt.restore_checkpoint(ckpt.latest_checkpoint(d),
                                                 state)
    assert manifest["step"] == 5
    assert torch.equal(restored["a"], state["a"])
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    assert ckpt.list_checkpoints(os.path.join(d, "none")) == []
    assert ckpt.latest_checkpoint(os.path.join(d, "none")) is None
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(d),
                                {"a": state["a"], "c": state["a"]})


def test_checkpoint_bf16_round_trip(tmp_path):
    """A train state with bfloat16 params, float32 moments and an int32
    step: every leaf restored bitwise in its dtype; the npz holds the
    bfloat16 bits as uint16 and the manifest each leaf's dtype."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              dtype="bfloat16")
    tr = Trainer(cfg, TrainerConfig(), SyntheticTask(
        vocab_size=cfg.vocab_size, seq_len=8), device="cpu")
    state = tr.state._replace(opt_state=tr.state.opt_state._replace(
        m=tree.tree_map(lambda t: torch.randn_like(t), tr.state.opt_state.m)))
    path = ckpt.save_checkpoint(str(tmp_path), 3, state, extra={"loss": 1.5})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["params/embed/tok"].dtype == np.uint16
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"]["params/embed/tok"] == "bfloat16"
    assert manifest["dtypes"]["step"] == "int32"
    fresh = Trainer(cfg, TrainerConfig(), SyntheticTask(
        vocab_size=cfg.vocab_size, seq_len=8), device="cpu").state
    restored, manifest = ckpt.restore_checkpoint(path, fresh)
    assert manifest["extra"] == {"loss": 1.5} and manifest["step"] == 3
    assert type(restored) is type(state)
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_watchdog_on_a_fake_clock():
    """Steps of 10 ms, then one of 60 ms: flagged after the warm-up only,
    against 5x the median of the steps before it."""
    now = [0.0]
    wd = StragglerWatchdog(factor=5.0, warmup=2, clock=lambda: now[0])
    flagged = []
    for i, dt in enumerate([0.010] * 6 + [0.060, 0.010, 0.049]):
        wd.step_start()
        now[0] += dt
        flagged.append(wd.step_end())
    assert flagged == [False] * 6 + [True, False, False]
    assert wd.flags == 1 and wd.median == pytest.approx(0.010)
    short = StragglerWatchdog(factor=2.0, warmup=1, window=3,
                              clock=lambda: now[0])
    for dt in (1.0, 1.0, 1.0, 5.0):
        short.step_start()
        now[0] += dt
    assert len(short.times) <= 3


def test_preemption_checkpoints_and_stops(tmp_path):
    """SIGTERM sets the flag; the trainer checkpoints at the next step
    boundary and stops."""
    old = signal.getsignal(signal.SIGTERM)
    try:
        ph = PreemptionHandler()
        ph.install()
        ph.install()
        assert not ph.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert ph.should_stop()
        cfg = reduced_config(get_config(ARCH))
        tr = Trainer(cfg, TrainerConfig(steps=10, ckpt_dir=str(tmp_path),
                                        per_device_batch=2),
                     SyntheticTask(vocab_size=cfg.vocab_size, seq_len=16),
                     device="cpu")
        tr.preemption = ph
        assert len(tr.run()) == 1
        assert ckpt.list_checkpoints(str(tmp_path)) == [1]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_unported_paths_raise():
    cfg = reduced_config(get_config(ARCH))
    src = SyntheticTask(vocab_size=cfg.vocab_size, seq_len=8)
    with pytest.raises(NotImplementedError, match="item 18"):
        Trainer(cfg, TrainerConfig(), src, rules=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        elastic_reshard("x", None, None)
    with pytest.raises(ValueError):
        Trainer(cfg, TrainerConfig(optimizer="sgd"), src, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        launch_train.main(["--smoke", "--device", "cpu",
                           "--model-parallel", "2"])


@pytest.mark.parametrize("arch, optimizer", [
    ("phi3-medium-14b", "adamw"), ("rwkv6-7b", "shampoo")])
def test_launcher_smoke(arch, optimizer, capsys):
    hist = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "3", "--seq-len", "16",
                              "--per-device-batch", "2", "--optimizer",
                              optimizer, "--compression", "int8"])
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert "training" in capsys.readouterr().out
