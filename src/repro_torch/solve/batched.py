"""Batched drivers — the many-small-systems serving scenario.

The port of :mod:`repro.solve.batched`: ``gesv_batched``, ``posv_batched``,
``lu_factor_batched``, ``cholesky_factor_batched`` and ``solve_batched``,
with the reference's defaults (``block=32``, ``variant="la"``,
``depth=1``) and the drivers' ``backend=`` (``"cuda"``, the hand-written
kernels, by default) and ``device=`` (None = the GPU).

The reference lowers a batch to one ``vmap``-compiled computation.  There
is no ``vmap`` over hand-written kernels, so here the systems run one after
another, in slot order, through the port's own unbatched drivers — what the
reference's mesh path already does (an eager per-system loop).  Each answer
so is bitwise the unbatched driver's on that system, and a batch launches
each kernel once a system and panel.  ``mesh=`` (and ``layout=``) runs the
same loop with every system factored over the whole mesh in turn, the
reference's own mesh path: the large-system regime a mesh is for.  Every
rank of the mesh calls the batched entry with the same batch, and each
answer is bitwise the single-device driver's.

Inputs are ``(B, n, n)`` stacks (tensors or NumPy arrays) and ``(B, n, k)``
or ``(B, n)`` right-hand sides; outputs stack the drivers' answers, and
the factor steps return one factor object whose tensors carry the batch
axis (:func:`repro_torch.solve.factors.stack_factors`).
"""
from __future__ import annotations

import torch

from repro_torch.core.blocking import BlockSpec, normalize_block
from repro_torch.solve import drivers
from repro_torch.solve.factors import batch_size, factors_at, \
    stack_factors

__all__ = [
    "gesv_batched", "posv_batched",
    "lu_factor_batched", "cholesky_factor_batched", "solve_batched",
]


def _systems(a, b=None) -> int:
    """The batch size of ``a`` (and ``b``), checked."""
    if len(a.shape) != 3:
        raise ValueError(f"a batch of systems is (B, n, n), got shape "
                         f"{tuple(a.shape)}")
    if b is not None and (len(b.shape) not in (2, 3)
                          or b.shape[0] != a.shape[0]):
        raise ValueError(f"right-hand sides {tuple(b.shape)} do not match "
                         f"the batch {tuple(a.shape)}")
    return a.shape[0]


def gesv_batched(a, b, block: BlockSpec = 32, *, variant: str = "la",
                 depth: int = 1, backend="cuda", device=None,
                 mesh=None, layout=None) -> torch.Tensor:
    """Solve ``A[i]·X[i] = B[i]`` for a stack of general square systems."""
    block = normalize_block(block)
    return torch.stack([
        drivers.gesv(a[i], b[i], block, variant=variant, depth=depth,
                     backend=backend, device=device, mesh=mesh,
                     layout=layout)
        for i in range(_systems(a, b))])


def posv_batched(a, b, block: BlockSpec = 32, *, variant: str = "la",
                 depth: int = 1, backend="cuda", device=None,
                 mesh=None, layout=None) -> torch.Tensor:
    """Solve a stack of SPD systems by Cholesky."""
    block = normalize_block(block)
    return torch.stack([
        drivers.posv(a[i], b[i], block, variant=variant, depth=depth,
                     backend=backend, device=device, mesh=mesh,
                     layout=layout)
        for i in range(_systems(a, b))])


def lu_factor_batched(a, block: BlockSpec = 32, *, variant: str = "la",
                      depth: int = 1, backend="cuda", device=None,
                      mesh=None, layout=None):
    """Factor a stack of systems once; returns batched :class:`LUFactors`."""
    block = normalize_block(block)
    return stack_factors([
        drivers.lu_factor(a[i], block, variant=variant, depth=depth,
                          backend=backend, device=device, mesh=mesh,
                          layout=layout)
        for i in range(_systems(a))])


def cholesky_factor_batched(a, block: BlockSpec = 32, *,
                            variant: str = "la", depth: int = 1,
                            backend="cuda", device=None, mesh=None,
                            layout=None):
    """Factor a stack of SPD systems; returns batched
    :class:`CholeskyFactors`."""
    block = normalize_block(block)
    return stack_factors([
        drivers.cholesky_factor(a[i], block, variant=variant, depth=depth,
                                backend=backend, device=device, mesh=mesh,
                          layout=layout)
        for i in range(_systems(a))])


def solve_batched(factors, b) -> torch.Tensor:
    """Solve a fresh batch of right-hand sides against batched factors
    (as the ``*_factor_batched`` steps return them, or
    :func:`~repro_torch.solve.factors.stack_factors` builds them): system
    ``i`` takes ``b[i]``."""
    if b.shape[0] != batch_size(factors):
        raise ValueError(f"right-hand sides {tuple(b.shape)} do not match "
                         f"a batch of {batch_size(factors)} systems")
    return torch.stack([factors_at(factors, i).solve(b[i])
                        for i in range(b.shape[0])])
