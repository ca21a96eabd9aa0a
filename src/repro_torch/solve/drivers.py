"""LAPACK-style drivers built on the DMF layer: ``lu_factor``, ``gesv``,
``cholesky_factor`` and ``posv``.

The port of :mod:`repro.solve.drivers` for LU and Cholesky.  All take
``variant=`` (``mtb``/``rtm``/``la``/``la<d>``/``la_mb``, resolved by
:func:`repro_torch.core.lookahead.get_variant`), ``depth=``, ``backend=``
(``"cuda"`` — the hand-written kernels, the default — or ``"torch"`` — the
library ops, or a :class:`~repro_torch.core.backend.Backend`) and
``device=`` (``None`` means the GPU; raises ``RuntimeError`` without one).
``block`` may be a scalar or a per-iteration schedule.  NumPy inputs are
accepted; the caller's arrays are copied once and never modified.
"""
from __future__ import annotations

import functools

from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, normalize_block
from repro_torch.core.lookahead import deepen, get_variant
from repro_torch.obs import tracer as _obs
from repro_torch.solve.factors import CholeskyFactors, LUFactors

__all__ = ["lu_factor", "gesv", "cholesky_factor", "posv"]


def _traced(fn):
    """Driver-level span: with a tracer installed the whole call becomes
    one ``drive`` span (the engine's PF/TU spans nest inside it); with none
    the wrapper is a single predicate check."""

    @functools.wraps(fn)
    def wrapper(a, *args, **kw):
        tr = _obs.active()
        if tr is None:
            return fn(a, *args, **kw)
        shape = "x".join(str(d) for d in getattr(a, "shape", ()))
        return tr.wrap("drive", f"{fn.__name__}[{shape}]",
                       lambda: fn(a, *args, **kw), driver=fn.__name__,
                       variant=str(kw.get("variant", "la")))
    return wrapper


def _deepen(variant: str, depth: int) -> str:
    """Fold ``depth=`` into the variant name (``("la", 2)`` → ``"la2"``)."""
    return variant if depth == 1 else deepen(variant, depth)


@_traced
def lu_factor(a, block: BlockSpec = 128, *, variant: str = "la",
              depth: int = 1, backend="cuda", device=None) -> LUFactors:
    """Factor ``P·A = L·U`` (LU with partial pivoting)."""
    be = resolve_backend(backend)
    lu, ipiv = get_variant("lu", _deepen(variant, depth))(
        a, block, backend=be, device=device)
    return LUFactors.from_packed(lu, ipiv, block=normalize_block(block),
                                 backend=be)


@_traced
def gesv(a, b, block: BlockSpec = 128, *, variant: str = "la",
         depth: int = 1, backend="cuda", device=None):
    """Solve ``A·X = B`` for general square A (LU with partial pivoting)."""
    return lu_factor(a, block, variant=variant, depth=depth, backend=backend,
                     device=device).solve(b)


@_traced
def cholesky_factor(a, block: BlockSpec = 128, *, variant: str = "la",
                    depth: int = 1, backend="cuda",
                    device=None) -> CholeskyFactors:
    """Factor ``A = L·Lᵀ`` for symmetric positive-definite A (Cholesky)."""
    be = resolve_backend(backend)
    l = get_variant("cholesky", _deepen(variant, depth))(
        a, block, backend=be, device=device)
    return CholeskyFactors(l=l, block=normalize_block(block), backend=be)


@_traced
def posv(a, b, block: BlockSpec = 128, *, variant: str = "la",
         depth: int = 1, backend="cuda", device=None):
    """Solve ``A·X = B`` for symmetric positive-definite A (Cholesky)."""
    return cholesky_factor(a, block, variant=variant, depth=depth,
                           backend=backend, device=device).solve(b)
