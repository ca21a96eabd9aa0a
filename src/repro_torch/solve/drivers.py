"""LAPACK-style drivers built on the DMF layer: ``lu_factor``, ``gesv``,
``cholesky_factor``, ``posv``, ``ldlt_factor``, ``qr_factor``, ``geqp3``,
``gels``, ``gehrd``, ``getri`` and ``gecon``.

The port of :mod:`repro.solve.drivers`.  All take
``variant=`` (``mtb``/``rtm``/``la``/``la<d>``/``la_mb``, the tile-DAG
``tiled`` for Cholesky and QR, and ``tuned``, the autotuner's cached
winner; resolved by :func:`repro_torch.core.lookahead.get_variant`),
``depth=``, ``backend=``
(``"cuda"`` — the hand-written kernels, the default — or ``"torch"`` — the
library ops, or a :class:`~repro_torch.core.backend.Backend`) and
``device=`` (``None`` means the GPU; raises ``RuntimeError`` without one).
``block`` may be a scalar or a per-iteration schedule.  NumPy inputs are
accepted; the caller's arrays are copied once and never modified.

``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh``; LU, Cholesky
and QR with ``mtb``/``la``/``la<d>``) factors over block-cyclic shards,
one rank a shard, bitwise the single-device factors, pivots included
(:mod:`repro_torch.core.distributed`); every rank calls the driver with
the same input and solves on the gathered factors.  ``layout=`` picks the
mesh dimension.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, normalize_block
from repro_torch.core.lookahead import deepen, get_variant
from repro_torch.obs import tracer as _obs
from repro_torch.core.tiles import TileQR
from repro_torch.solve.factors import (CholeskyFactors, HessenbergFactors,
                                       LDLTFactors, LUFactors, QRCPFactors,
                                       QRFactors, TiledQRFactors)

__all__ = ["lu_factor", "gesv", "cholesky_factor", "posv", "ldlt_factor",
           "qr_factor", "geqp3", "gels", "gehrd", "getri", "gecon"]



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


def _mesh_kw(mesh, layout) -> dict:
    """The variant driver's mesh arguments: none without a mesh, so the
    single-device call is unchanged; with one, only the ``mtb``/``la``
    family resolves (the others refuse it)."""
    if mesh is None:
        return {} if layout is None else {"layout": layout}
    return {"mesh": mesh, "layout": layout}


@_traced
def lu_factor(a, block: BlockSpec = 128, *, variant: str = "la",
              depth: int = 1, backend="cuda", device=None, mesh=None,
              layout=None) -> LUFactors:
    """Factor ``P·A = L·U`` (LU with partial pivoting)."""
    be = resolve_backend(backend)
    lu, ipiv = get_variant("lu", _deepen(variant, depth))(
        a, block, backend=be, device=device, **_mesh_kw(mesh, layout))
    return LUFactors.from_packed(lu, ipiv, block=normalize_block(block),
                                 backend=be)


@_traced
def gesv(a, b, block: BlockSpec = 128, *, variant: str = "la",
         depth: int = 1, backend="cuda", device=None, mesh=None,
         layout=None):
    """Solve ``A·X = B`` for general square A (LU with partial pivoting)."""
    return lu_factor(a, block, variant=variant, depth=depth, backend=backend,
                     device=device, mesh=mesh, layout=layout).solve(b)


@_traced
def cholesky_factor(a, block: BlockSpec = 128, *, variant: str = "la",
                    depth: int = 1, backend="cuda", device=None,
                    mesh=None, layout=None) -> CholeskyFactors:
    """Factor ``A = L·Lᵀ`` for symmetric positive-definite A (Cholesky)."""
    be = resolve_backend(backend)
    l = get_variant("cholesky", _deepen(variant, depth))(
        a, block, backend=be, device=device, **_mesh_kw(mesh, layout))
    return CholeskyFactors(l=l, block=normalize_block(block), backend=be)


@_traced
def posv(a, b, block: BlockSpec = 128, *, variant: str = "la",
         depth: int = 1, backend="cuda", device=None, mesh=None,
         layout=None):
    """Solve ``A·X = B`` for symmetric positive-definite A (Cholesky)."""
    return cholesky_factor(a, block, variant=variant, depth=depth,
                           backend=backend, device=device, mesh=mesh,
                           layout=layout).solve(b)


@_traced
def ldlt_factor(a, block: BlockSpec = 128, *, variant: str = "la",
                depth: int = 1, backend="cuda", device=None) -> LDLTFactors:
    """Factor ``A = L·D·Lᵀ`` for symmetric A without pivoting
    (quasi-definite or diagonally dominant inputs)."""
    be = resolve_backend(backend)
    packed = get_variant("ldlt", _deepen(variant, depth))(
        a, block, backend=be, device=device)
    return LDLTFactors(packed=packed, block=normalize_block(block),
                       backend=be)


@_traced
def qr_factor(a, block: BlockSpec = 128, *, variant: str = "la",
              depth: int = 1, backend="cuda", device=None,
              mesh=None, layout=None) -> QRFactors | TiledQRFactors:
    """Householder QR (GEQRF); any m, n (wide inputs stop once the rows
    are exhausted; a mesh takes m >= n only).  ``variant="tiled"``, or a
    ``"tuned"`` winner that is ``tiled``, returns :class:`TiledQRFactors`."""
    be = resolve_backend(backend)
    out = get_variant("qr", _deepen(variant, depth))(
        a, block, backend=be, device=device, **_mesh_kw(mesh, layout))
    if isinstance(out, TileQR):
        return TiledQRFactors(tqr=out, block=normalize_block(block),
                              backend=be)
    packed, taus = out
    return QRFactors(packed=packed, taus=taus, block=normalize_block(block),
                     backend=be)


@_traced
def geqp3(a, block: BlockSpec = 128, *, variant=None, local: bool = False,
          depth: int = 1, backend="cuda", device=None) -> QRCPFactors:
    """Column-pivoted QR (GEQP3).

    ``local=False`` (default): global pivoting, rank-revealing, with no
    look-ahead variant (its panel reads the whole trailing block), so
    ``mtb`` (the default) or ``rtm``, and ``depth`` must stay 1.
    ``local=True``: windowed pivoting (``qrcp_local``), whose default
    variant is ``la`` and whose ``depth=`` keeps d panels in flight.
    """
    be = resolve_backend(backend)
    if local:
        dmf, variant = "qrcp_local", _deepen(variant or "la", depth)
    else:
        if depth != 1:
            raise ValueError(
                "depth > 1 requires local=True: global QRCP has no "
                "look-ahead window to deepen (DESIGN.md §11)")
        dmf, variant = "qrcp", variant or "mtb"
    packed, taus, jpvt = get_variant(dmf, variant)(a, block, backend=be,
                                                   device=device)
    return QRCPFactors(packed=packed, taus=taus, jpvt=jpvt,
                       block=normalize_block(block), backend=be)


@_traced
def gels(a, b, block: BlockSpec = 128, *, variant: str = "la",
         depth: int = 1, backend="cuda", pivot: bool = False,
         local: bool = False, rcond=None, device=None, mesh=None,
         layout=None):
    """Least squares ``argmin‖A·X − B‖₂`` for m ≥ n via Householder QR.

    ``pivot=True`` goes through :func:`geqp3` and returns the
    rank-truncated basic solution (``rcond`` sets the cutoff).  Global
    pivoting has no look-ahead variant, so the default ``variant="la"``
    becomes ``"mtb"`` there; an explicit variant passes through.
    ``local=True`` (with ``pivot=True``) selects windowed pivoting, where
    the ``variant``/``depth`` defaults pass through as for the others.
    ``mesh=`` factors by unpivoted QR over the mesh; column-pivoted QR has
    no mesh lowering, so ``pivot=True`` with a mesh is a ValueError.
    """
    if pivot:
        if mesh is not None:
            raise ValueError("pivot=True has no mesh path: column-pivoted "
                             "QR is mesh-excluded (DESIGN.md §17)")
        if local:
            fac = geqp3(a, block, variant=variant, local=True, depth=depth,
                        backend=backend, device=device)
        else:
            qv = "mtb" if (variant, depth) == ("la", 1) \
                else _deepen(variant, depth)
            fac = geqp3(a, block, variant=qv, backend=backend, device=device)
        return fac.solve(b, rcond=rcond)
    if local:
        raise ValueError("local=True selects windowed *pivoting* and "
                         "requires pivot=True")
    if rcond is not None:
        raise ValueError("rcond requires pivot=True (rank truncation needs "
                         "the column-pivoted factorization)")
    return qr_factor(a, block, variant=variant, depth=depth, backend=backend,
                     device=device, mesh=mesh, layout=layout).solve(b)


@_traced
def gehrd(a, block: BlockSpec = 128, *, variant: str = "mtb",
          backend="cuda", device=None) -> HessenbergFactors:
    """Hessenberg reduction (GEHRD): ``A = Q·H·Qᵀ``.

    ``variant`` is ``mtb`` (the default) or ``rtm``: the panel reads the
    whole trailing matrix, so no look-ahead variant exists (DESIGN.md §11).
    """
    be = resolve_backend(backend)
    packed, taus = get_variant("hessenberg", variant)(a, block, backend=be,
                                                      device=device)
    return HessenbergFactors(packed=packed, taus=taus,
                             block=normalize_block(block), backend=be)


@_traced
def getri(a, block: BlockSpec = 128, *, variant: str = "la", depth: int = 1,
          backend="cuda", method: str = "lu", device=None):
    """Matrix inverse.

    ``method="lu"`` (the default) factors with partial pivoting, then
    solves for the n columns of I (GETRF + GETRI semantics).
    ``method="gj"``: one sweep of blocked Gauss–Jordan inversion, unpivoted,
    for SPD and diagonally dominant inputs.
    """
    if method == "lu":
        return lu_factor(a, block, variant=variant, depth=depth,
                         backend=backend, device=device).inverse()
    if method == "gj":
        return get_variant("gauss_jordan", _deepen(variant, depth))(
            a, block, backend=resolve_backend(backend), device=device)
    raise ValueError(f"method must be 'lu' or 'gj', got {method!r}")


@_traced
def gecon(a, block: BlockSpec = 128, *, variant: str = "la", depth: int = 1,
          backend="cuda", iters: int = 5, device=None):
    """Reciprocal 1-norm condition estimate ``1 / (‖A‖₁·est(‖A⁻¹‖₁))``.

    Hager–Higham power iteration on the 1-norm (LAPACK's LACON): each step
    solves once with A and once with Aᵀ on the same LU factors.  The
    estimate stays on the device as a 0-d tensor; nothing is read back to
    the host.
    """
    facs = lu_factor(a, block, variant=variant, depth=depth, backend=backend,
                     device=device)
    n = facs.n
    lu = facs.lu
    anorm = torch.as_tensor(a).to(device=lu.device, dtype=lu.dtype) \
        .abs().sum(0).max()
    x = torch.full((n,), 1.0 / n, dtype=lu.dtype, device=lu.device)
    est = torch.zeros((), dtype=lu.dtype, device=lu.device)
    for it in range(iters):
        y = facs.solve(x)
        est = y.abs().sum()
        if it == iters - 1:
            break   # est is final; the direction update would be dead work
        z = facs.solve(torch.sign(y), trans=True)
        x = torch.zeros_like(x)
        x[torch.argmax(z.abs())] = 1.0
    return 1.0 / (anorm * est)
