"""AdamW (decoupled weight decay), an optax-style minimal transform.

The port of :mod:`repro.optim.adamw`: params, gradients and moments are
trees of tensors (:mod:`repro_torch.tree`); the moments are float32 and the
updates come back in each param's dtype.  ``update`` is functional: it
returns new moments and leaves the given state as it was.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWState", "AdamW", "apply_updates", "learning_rate",
           "bias_corrections"]


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    m: object
    v: object


def learning_rate(lr, step: torch.Tensor) -> torch.Tensor:
    """The rate at ``step``: a schedule's value or a constant, float32."""
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def bias_corrections(b1: float, b2: float, step: torch.Tensor):
    """``1 − b1^step`` and ``1 − b2^step`` in float32."""
    s = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    return one - torch.pow(one * b1, s), one - torch.pow(one * b2, s)


def moments(b1: float, b2: float, m, v, grads):
    """The new first and second moments (float32) of ``grads``."""
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), m, grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                 v, grads)
    return m, v


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        ps = leaves(params)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=ps[0].device if ps
                                           else None),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        m, v = moments(self.b1, self.b2, state.m, state.v, grads)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        lr = learning_rate(self.learning_rate, step)

        def upd(p, m, v):
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (-lr * delta).to(p.dtype)

        updates = tree_map(upd, params, m, v)
        return updates, AdamWState(step=step, m=m, v=v)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each param's dtype."""
    return tree_map(lambda p, u: p + u, params, updates)
