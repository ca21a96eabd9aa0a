"""DMF-Shampoo: Kronecker-factored preconditioning built on the paper's
factorizations.

The port of :mod:`repro.optim.shampoo`.  For each 2-D param ``W (d1, d2)``
it keeps the Gram statistics ``L ← β·L + (1 − β)·G·Gᵀ`` and
``R ← β·R + (1 − β)·Gᵀ·G`` and preconditions ``P = L^{-1/4}·M̂·R^{-1/4}``
(M̂ Adam's bias-corrected first moment), grafted onto Adam's per-tensor
scale.  The inverse 4th roots come from matmul-only coupled Newton
iterations (:func:`inv_fourth_root`, float32 library products at full
precision, as the reference's ``_matmul`` stays outside its Pallas
kernels); :func:`cholesky_norm_seed` estimates ``‖A‖₂`` from the port's
look-ahead Cholesky (``core.cholesky.cholesky_lookahead``: on the card the
Cholesky panel kernel, the fused Cholesky panel update and the GEMM).

Static look-ahead across steps: leaf ``i`` (in the reference's leaf order,
:mod:`repro_torch.tree`) refreshes its roots at the steps where
``step % refresh_every == i % refresh_every``; every other step it keeps
the roots it has, so the sequential root work is spread round-robin over
the steps instead of stalling one.  A param is preconditioned when it is
2-D with both dims at most ``max_dim`` and at least 8 (``_is_kron``);
every other param, a segment's stacked (L, d1, d2) weights included, takes
Adam.  ``update`` is functional, as AdamW's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.backend import no_tf32
from repro_torch.core.cholesky import cholesky_lookahead
from repro_torch.optim.adamw import bias_corrections, learning_rate, moments
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["inv_fourth_root", "cholesky_norm_seed", "ShampooState",
           "DMFShampoo"]


def _matmul(a, b):
    return torch.matmul(a, b)


def inv_fourth_root(a: torch.Tensor, *, iters: int = 12,
                    damping: float = 1e-6) -> torch.Tensor:
    """A^{-1/4} of a symmetric positive (semi-)definite ``a`` by the
    coupled Newton iteration (Iannazzo 2006), float32:
    ``X ← X·T``, ``M ← T⁴·M`` with ``T = ((p + 1)·I − M)/p``, p = 4, from
    ``M = z·A``, ``X = z^{1/4}·I``, ``z = 1/‖A‖_F``, after damping A by
    ``damping · trace(A)/n``."""
    no_tf32()
    n = a.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    a = a.float()
    a = a + damping * torch.trace(a) / n * eye
    z = 1.0 / torch.linalg.norm(a)
    m = z * a
    x = eye * (z ** 0.25)
    p = 4.0
    for _ in range(iters):
        t = ((p + 1.0) * eye - m) / p
        x = _matmul(x, t)
        t2 = _matmul(t, t)
        m = _matmul(_matmul(t2, t2), m)
    return x


def cholesky_norm_seed(a: torch.Tensor, block: int = 32) -> torch.Tensor:
    """A scale estimate of SPD ``a`` from its look-ahead Cholesky factor:
    ``max(diag(L))²``, with ``max(diag(L))² ≤ ‖A‖₂ ≤ n·max(diag(L))²``.
    Blocks of ``block`` (all of ``a`` when ``n`` is not a multiple)."""
    n = a.shape[0]
    b = min(block, n)
    if n % b:
        b = n
    l = cholesky_lookahead(a.float(), b, device=a.device)
    return torch.max(torch.abs(torch.diagonal(l))) ** 2


class ShampooState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    l_stats: object              # per 2-D param: (d1, d1); else (0, 0)
    r_stats: object              # per 2-D param: (d2, d2)
    l_root: object
    r_root: object
    adam_m: object
    adam_v: object


@dataclasses.dataclass(frozen=True)
class DMFShampoo:
    """Shampoo with staggered (look-ahead) root refresh + Adam grafting."""

    learning_rate: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    stat_decay: float = 0.95
    refresh_every: int = 10        # each leaf refreshes once per N steps
    max_dim: int = 4096            # larger dims fall back to Adam
    root_iters: int = 12

    def _is_kron(self, p) -> bool:
        return (p.dim() == 2 and p.shape[0] <= self.max_dim
                and p.shape[1] <= self.max_dim and min(p.shape) >= 8)

    def init(self, params) -> ShampooState:
        def square(p, side, fill):
            f32 = torch.float32
            if not self._is_kron(p):
                return torch.zeros((0, 0), dtype=f32, device=p.device)
            d = p.shape[side]
            return fill(d, dtype=f32, device=p.device)

        zeros = lambda d, **kw: torch.zeros((d, d), **kw)
        zeros32 = lambda p: torch.zeros_like(p, dtype=torch.float32)
        ps = leaves(params)
        return ShampooState(
            step=torch.zeros((), dtype=torch.int32,
                             device=ps[0].device if ps else None),
            l_stats=tree_map(lambda p: square(p, 0, zeros), params),
            r_stats=tree_map(lambda p: square(p, 1, zeros), params),
            l_root=tree_map(lambda p: square(p, 0, torch.eye), params),
            r_root=tree_map(lambda p: square(p, 1, torch.eye), params),
            adam_m=tree_map(zeros32, params),
            adam_v=tree_map(zeros32, params))

    def refreshes(self, step: int, index: int) -> bool:
        """Whether leaf ``index`` refreshes its roots at (new) ``step``."""
        return step % self.refresh_every == index % self.refresh_every

    @torch.no_grad()
    def update(self, grads, state: ShampooState, params):
        no_tf32()
        step = state.step + 1
        at = int(step)
        sd = self.stat_decay
        m, v = moments(self.b1, self.b2, state.adam_m, state.adam_v, grads)
        c1, c2 = bias_corrections(self.b1, self.b2, step)
        lr = learning_rate(self.learning_rate, step)

        new_ls, new_rs, new_lr, new_rr, updates = [], [], [], [], []
        for i, (g, p, ls, rs, lroot, rroot, mi, vi) in enumerate(zip(
                leaves(grads), leaves(params), leaves(state.l_stats),
                leaves(state.r_stats), leaves(state.l_root),
                leaves(state.r_root), leaves(m), leaves(v))):
            mhat = mi / c1
            adam_dir = mhat / (torch.sqrt(vi / c2) + self.eps)
            if self._is_kron(p):
                gf = g.float()
                ls = sd * ls + (1 - sd) * _matmul(gf, gf.T)
                rs = sd * rs + (1 - sd) * _matmul(gf.T, gf)
                if self.refreshes(at, i):
                    lroot = inv_fourth_root(ls, iters=self.root_iters)
                    rroot = inv_fourth_root(rs, iters=self.root_iters)
                precond = _matmul(_matmul(lroot, mhat), rroot)
                # Adam grafting: keep the Adam per-tensor scale
                pn = torch.linalg.norm(precond) + 1e-16
                an = torch.linalg.norm(adam_dir)
                direction = precond * (an / pn)
            else:
                direction = adam_dir
            delta = direction + self.weight_decay * p.float()
            updates.append((-lr * delta).to(p.dtype))
            new_ls.append(ls)
            new_rs.append(rs)
            new_lr.append(lroot)
            new_rr.append(rroot)

        new_state = ShampooState(
            step=step, l_stats=unflatten(state.l_stats, new_ls),
            r_stats=unflatten(state.r_stats, new_rs),
            l_root=unflatten(state.l_root, new_lr),
            r_root=unflatten(state.r_root, new_rr), adam_m=m, adam_v=v)
        return unflatten(grads, updates), new_state
