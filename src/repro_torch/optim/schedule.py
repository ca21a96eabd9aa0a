"""LR schedules: plain functions of the step (an int or a tensor) that
return a float32 scalar tensor on the step's device.  The port of
:mod:`repro.optim.schedule`."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine
    decay to ``floor · peak`` at ``total_steps``."""
    def lr(step):
        step = _step(step)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
