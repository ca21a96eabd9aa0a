"""Blocking / partitioning helpers — the FLAME ``FLA_Part_2x2`` analogues.

A copy of :mod:`repro.core.blocking` (pure Python), kept so that the port
imports nothing of the reference package: ``repro.core``'s ``__init__``
imports JAX and the whole variant registry.

The paper's general framework (Listing 2/3) walks a matrix in steps of ``b``
columns per iteration.  The port realises that traversal as a Python loop
with static slice bounds (``k`` is a Python int), so every iteration works
on fixed views of one working copy of the matrix.

Block schedules (paper §5, early termination).  Everywhere a driver accepts
a block size ``b`` it may instead receive a sequence ``[b_0, b_1, ...]`` of
panel widths, consumed one per iteration (the last entry repeats if the
schedule is shorter than the traversal; every width is clipped to the
remaining columns).  A scalar ``b`` is exactly the uniform schedule
``[b, b, ...]`` — :func:`expand_schedule` makes the equivalence explicit.
"""
from __future__ import annotations

import operator
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

#: A block size: a scalar ``b`` or a per-iteration schedule ``[b_0, b_1, ...]``.
BlockSpec = Union[int, Sequence[int]]


def _as_index(b) -> Optional[int]:
    """Integer value of a scalar block size (accepts numpy ints), else None."""
    try:
        return operator.index(b)
    except TypeError:
        return None


class PanelStep(NamedTuple):
    """One iteration of the DMF skeleton (paper Listing 3).

    Attributes:
      k:      start column/row of the current panel (``A11`` origin).
      bk:     width of the current panel (== b except possibly the last step).
      k_next: start of the *next* panel (== k + bk).
      b_next: width of the next panel (0 on the last step).
      last:   True on the final iteration.
    """

    k: int
    bk: int
    k_next: int
    b_next: int
    last: bool


def _validate_widths(widths: Sequence[int]) -> Tuple[int, ...]:
    widths = tuple(operator.index(w) for w in widths)
    if not widths:
        raise ValueError("block schedule must be non-empty")
    for w in widths:
        if w <= 0:
            raise ValueError(f"block widths must be positive, got {widths}")
    return widths


def expand_schedule(n: int, b: BlockSpec) -> Tuple[int, ...]:
    """Per-iteration panel widths covering ``[0, n)`` exactly.

    A scalar ``b`` expands to the uniform schedule (last panel clipped);
    a sequence is consumed in order, its last entry repeating if the
    traversal is longer than the schedule, every entry clipped to the
    remaining width.  ``sum(expand_schedule(n, b)) == n`` always.
    """
    bi = _as_index(b)
    if bi is not None:
        if bi <= 0:
            raise ValueError(f"block size must be positive, got {bi}")
        widths = (bi,)
    else:
        widths = _validate_widths(b)
    out = []
    k, i = 0, 0
    while k < n:
        w = min(widths[i], n - k)
        out.append(w)
        k += w
        if i < len(widths) - 1:
            i += 1
    return tuple(out)


def normalize_block(b: BlockSpec) -> Union[int, Tuple[int, ...]]:
    """Canonical hashable form of a ``BlockSpec``: an ``int`` or a
    validated tuple."""
    bi = _as_index(b)
    return bi if bi is not None else _validate_widths(b)


def max_width(b: BlockSpec) -> int:
    """Largest panel width a ``BlockSpec`` can produce (scalar for gates)."""
    b = normalize_block(b)
    return b if isinstance(b, int) else max(b)


def panel_steps(n: int, b: BlockSpec) -> Iterator[PanelStep]:
    """Iterate the panel schedule for an ``n``-wide traversal.

    ``b`` is a scalar block size or a per-iteration schedule (module doc).
    """
    widths = expand_schedule(n, b)
    k = 0
    for i, bk in enumerate(widths):
        k_next = k + bk
        b_next = widths[i + 1] if i + 1 < len(widths) else 0
        yield PanelStep(k, bk, k_next, b_next, i == len(widths) - 1)
        k = k_next


def split_trailing(k_next: int, b_next: int, n: int) -> tuple[slice, slice]:
    """Split the trailing columns ``[k_next, n)`` into (TU^L, TU^R).

    TU^L covers exactly the columns of the next panel — the static look-ahead
    split of paper §4: ``TU_k -> (TU_k^L | TU_k^R)``.
    """
    return slice(k_next, k_next + b_next), slice(k_next + b_next, n)
