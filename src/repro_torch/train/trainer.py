"""Trainer: the train step, gradient accumulation, compression, the
optimizer, checkpoint/resume and the fault-tolerance hooks.

The port of :mod:`repro.train.trainer` on one device (``device=None``
means the GPU).  One step takes the loss and its gradients over the params'
leaves (``torch.autograd.grad``; the params require a gradient only inside
the step), accumulates microbatches with float32 gradients (the
reference's scan), compresses the gradients, runs the optimizer's update
and ``apply_updates``, and reports the float32 gradient norm.  The step
runs eagerly: on the card, every layer's attention or WKV forward is a
kernel launch, twice with remat (the forward and its recompute), and the
backward recomputes the reference formulation in plain PyTorch ops.
Sharding rules (FSDP over a mesh) wait for the mesh trainer: ``rules=``
other than ``None`` raises (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import adamw as _adamw
from repro_torch.optim import schedule as _sched
from repro_torch.optim import shampoo as _shampoo
from repro_torch.optim.compression import GradCompression
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerWatchdog)
from repro_torch.tree import leaves, unflatten

__all__ = ["TrainState", "TrainerConfig", "make_optimizer", "Trainer"]


class TrainState(NamedTuple):
    step: torch.Tensor             # int32 scalar
    params: Any
    opt_state: Any
    residual: Any                  # grad-compression error feedback


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    per_device_batch: int = 4
    microbatches: int = 1
    optimizer: str = "adamw"       # adamw | shampoo
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    compression: str = "none"      # none | bf16 | int8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0


def make_optimizer(tc: TrainerConfig):
    lr = _sched.warmup_cosine(tc.peak_lr, tc.warmup_steps, tc.steps)
    if tc.optimizer == "adamw":
        return _adamw.AdamW(learning_rate=lr, weight_decay=tc.weight_decay)
    if tc.optimizer == "shampoo":
        return _shampoo.DMFShampoo(learning_rate=lr,
                                   weight_decay=tc.weight_decay)
    raise ValueError(tc.optimizer)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig, source,
                 rules=None, device=None):
        if rules is not None:
            raise NotImplementedError(
                "sharding rules (FSDP over a mesh) are not ported yet: "
                "ROADMAP Queue 1 item 18; the trainer runs on one device")
        self.cfg, self.tc, self.source = cfg, tc, source
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(tc)
        self.compressor = GradCompression(mode=tc.compression)
        self.watchdog = StragglerWatchdog()
        self.preemption = PreemptionHandler()
        params = api.init_params(cfg, tc.seed, self.device)
        self.state = TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            params=params, opt_state=self.optimizer.init(params),
            residual=self.compressor.init(params))

    # ------------------------------------------------------------------
    def value_and_grad(self, params, batch):
        """(loss, gradients) of ``batch``: its mean over
        ``tc.microbatches`` equal slices of the batch, the gradients then
        accumulated in float32 (in the params' dtypes for one slice)."""
        ps = leaves(params)
        n_micro = self.tc.microbatches
        for p in ps:
            p.requires_grad_(True)
        try:
            if n_micro == 1:
                loss = api.loss_fn(self.cfg, params, batch)
                grads = torch.autograd.grad(loss, ps)
                return loss.detach(), unflatten(params, grads)
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss = api.loss_fn(self.cfg, params, mb)
                for a, g in zip(acc, torch.autograd.grad(loss, ps)):
                    a.add_(g)
                total += loss.detach()
            return total / n_micro, unflatten(
                params, [a / n_micro for a in acc])
        finally:
            for p in ps:
                p.requires_grad_(False)

    def train_step(self, state: TrainState, batch):
        """One step from ``state``; returns (new state, metrics)."""
        loss, grads = self.value_and_grad(state.params, batch)
        with torch.no_grad():
            grads, residual = self.compressor.compress(grads, state.residual)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, state.params)
            params = _adamw.apply_updates(state.params, updates)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in leaves(grads)))
        metrics = {"loss": loss, "grad_norm": gnorm}
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, residual=residual), metrics

    # ------------------------------------------------------------------
    def _host_batch(self, step: int):
        raw = self.source.batch(step, 0, 1, self.tc.per_device_batch)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in raw.items()}

    def run(self, steps: Optional[int] = None, resume: bool = True):
        tc = self.tc
        steps = steps or tc.steps
        self.preemption.install()
        start = int(self.state.step)
        if resume and tc.ckpt_dir:
            path = ckpt.latest_checkpoint(tc.ckpt_dir)
            if path:
                self.state, manifest = ckpt.restore_checkpoint(
                    path, self.state)
                start = manifest["step"]
        history = []
        for step in range(start, steps):
            self.watchdog.step_start()
            batch = self._host_batch(step)
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])
            straggle = self.watchdog.step_end()
            history.append(loss)
            if step % tc.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"t/step {self.watchdog.median*1e3:.0f}ms")
            save_now = tc.ckpt_dir and (
                (step + 1) % tc.ckpt_every == 0
                or straggle
                or self.preemption.should_stop())
            if save_now:
                ckpt.save_checkpoint(tc.ckpt_dir, step + 1, self.state,
                                     extra={"loss": loss},
                                     keep=tc.keep_checkpoints)
            if self.preemption.should_stop():
                print(f"preemption requested — checkpointed at step {step+1}")
                break
        return history
