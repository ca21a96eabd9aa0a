"""Block-schedule construction — the paper's §5 early-termination analogue.

The port of :mod:`repro.tune.schedule`.  The paper's look-ahead with
malleable BLAS shrinks the block size during the factorization once the
trailing update is too small to hide the panel.  With a schedule fixed in
advance the same effect is a **decreasing-``b`` tail**: uniform ``b``
while the trailing matrix is large, halving as the remaining width drops
below a couple of panels.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.blocking import expand_schedule

__all__ = ["is_uniform", "tail_schedule", "uniform_schedule"]


def is_uniform(schedule: Tuple[int, ...]) -> bool:
    """True for a constant-width schedule (the last panel may be clipped)."""
    return len(set(schedule[:-1])) <= 1


def uniform_schedule(n: int, b: int) -> Tuple[int, ...]:
    """The scalar-``b`` traversal as an explicit schedule (last panel
    clipped)."""
    return expand_schedule(n, b)


def tail_schedule(n: int, b: int, *, min_b: int = 16,
                  shrink: int = 2) -> Tuple[int, ...]:
    """Uniform ``b`` with a decreasing tail.

    The width shrinks (by ``shrink``) whenever the remaining traversal is
    at most two panels wide, down to ``min_b``; the last entry is the
    exact remainder, so the schedule tiles ``n`` exactly.  (Band reduction
    refuses these: its width is the output bandwidth.)

    >>> tail_schedule(1024, 128)
    (128, 128, 128, 128, 128, 128, 64, 64, 32, 32, 16, 16, 16, 16)
    """
    if b <= 0 or min_b <= 0 or shrink < 2:
        raise ValueError(f"bad tail_schedule args b={b} min_b={min_b} "
                         f"shrink={shrink}")
    widths = []
    k, cur = 0, b
    while k < n:
        rem = n - k
        while cur > min_b and rem <= 2 * cur:
            cur = max(min_b, cur // shrink)
        widths.append(min(cur, rem))
        k += widths[-1]
    return tuple(widths)
