"""Variant registry: scheduling variants by name.

The port of :mod:`repro.core.lookahead`, for all nine DMFs of the
reference (LU, Cholesky, QR, LDLᵀ, Gauss–Jordan inversion, band
reduction, global QRCP, windowed ``qrcp_local`` and Hessenberg):

    fn = get_variant("lu", "la")          # -> lu_lookahead
    fn = get_variant("lu", "la2")         # -> lu_lookahead with depth=2
    fn = get_variant("cholesky", "la_mb") # -> cholesky_lookahead, fused PU

``"la<d>"`` / ``"la_mb<d>"`` resolve the look-ahead driver with ``depth=d``
(d panels in flight); ``"la"`` ≡ ``"la1"``.  ``la_mb`` plugs the fused
panel-update kernel into the look-ahead driver; a DMF without one (QR,
LDLᵀ, Gauss–Jordan, band reduction, ``qrcp_local``) gets its ``la``
driver.  Band reduction keeps its own two-panel loop and stays depth-1:
``"la2"`` and deeper raise ``KeyError`` for it.  Global QRCP and
Hessenberg have no look-ahead variant by policy
(:data:`LOOKAHEAD_EXCLUDED`):
``"la"``/``"la<d>"``/``"la_mb"`` raise ``KeyError`` with the reason, and
so does ``"tiled"``: a panel that reads the whole trailing block has no
tile decomposition either.

``"tiled"`` (Cholesky and QR) is the tile-DAG backend
(:mod:`repro_torch.core.tiles`).  ``"tuned"`` (every DMF of
:data:`TUNABLE`) runs the (variant, schedule) that
:func:`repro_torch.tune.search` cached for the input's shape and dtype,
the caller's backend and the device it runs on; with a cold cache it runs
``la`` (``mtb`` where there is none) at the caller's block.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

from repro_torch.core import (band_reduction, cholesky, gauss_jordan,
                              hessenberg, ldlt, lu, qr, qrcp, tiles)
from repro_torch.core.backend import resolve_backend
from repro_torch.core.pipeline import supports_depth
from repro_torch.device import resolve_device

_REGISTRY: Dict[str, Dict[str, Callable]] = {
    "lu": {
        "mtb": lu.lu_blocked,
        "rtm": lu.lu_tiled,
        "la": lu.lu_lookahead,
    },
    "cholesky": {
        "mtb": cholesky.cholesky_blocked,
        "rtm": cholesky.cholesky_tiled,
        "tiled": tiles.cholesky_tiles,
        "la": cholesky.cholesky_lookahead,
    },
    "qr": {
        "mtb": qr.qr_blocked,
        "rtm": qr.qr_tiled,
        "tiled": tiles.qr_tiles,
        "la": qr.qr_lookahead,
    },
    "ldlt": {
        "mtb": ldlt.ldlt_blocked,
        "la": ldlt.ldlt_lookahead,
    },
    "gauss_jordan": {
        "mtb": gauss_jordan.gj_inverse_blocked,
        "la": gauss_jordan.gj_inverse_lookahead,
    },
    "band_reduction": {
        "mtb": band_reduction.band_reduction_blocked,
        "la": band_reduction.band_reduction_lookahead,
    },
    # no "la" row by policy (LOOKAHEAD_EXCLUDED), not by omission
    "qrcp": {
        "mtb": qrcp.qrcp_blocked,
        "rtm": qrcp.qrcp_tiled,
    },
    "qrcp_local": {
        "mtb": qrcp.qrcp_local_blocked,
        "rtm": qrcp.qrcp_local_tiled,
        "la": qrcp.qrcp_local_lookahead,
    },
    # no "la" row by policy (LOOKAHEAD_EXCLUDED), not by omission
    "hessenberg": {
        "mtb": hessenberg.hessenberg_blocked,
        "rtm": hessenberg.hessenberg_tiled,
    },
}

#: Why a DMF has no look-ahead variant: its panel reads trailing data beyond
#: the panel columns (:attr:`StepOps.la_unsafe`).
LOOKAHEAD_EXCLUDED: Dict[str, str] = {
    "qrcp": qrcp.QRCP_OPS.la_unsafe,
    "hessenberg": hessenberg.HESSENBERG_OPS.la_unsafe,
}

VARIANTS = ("mtb", "rtm", "tiled", "la", "la_mb")
FACTORIZATIONS = tuple(_REGISTRY)

#: Variants resolved by composition rather than a registry row: ``la_mb``
#: (``la`` with the fused panel update), the depth-suffixed names and
#: ``tuned``.
DERIVED_VARIANTS = ("la_mb", "tuned")

#: ``tuned`` replaces the caller's block schedule with the cached one, which
#: is right only where the block is a pure performance knob.  Band
#: reduction's ``w`` is the output bandwidth, so it is not tunable.
TUNABLE = tuple(d for d in _REGISTRY if d != "band_reduction")

_DEPTH_RE = re.compile(r"^(la(?:_mb)?)([1-9]\d*)$")


def parse_variant(variant: str) -> Tuple[str, int]:
    """Split a variant name into (base, look-ahead depth).

    ``"la3"`` → ``("la", 3)``; names without a depth suffix → depth 1.
    """
    m = _DEPTH_RE.match(variant)
    if m:
        return m.group(1), int(m.group(2))
    return variant, 1


def deepen(variant: str, depth: int) -> str:
    """Canonical name of ``variant`` at ``depth`` (``("la", 2)`` → ``"la2"``);
    the inverse of :func:`parse_variant`."""
    base, d0 = parse_variant(variant)
    if d0 != 1:
        raise ValueError(f"variant {variant!r} already carries a depth")
    if depth < 1:
        raise ValueError(f"look-ahead depth must be >= 1, got {depth}")
    if depth == 1:
        return base
    if base not in ("la", "la_mb"):
        raise ValueError(
            f"variant {base!r} has no look-ahead window; depth={depth} "
            f"applies to 'la'/'la_mb' only")
    return f"{base}{depth}"


def list_variants(dmf: str) -> tuple[str, ...]:
    """Variants that resolve through :func:`get_variant` for ``dmf``
    (depth-d look-ahead advertised by its ``"la2"`` representative)."""
    if dmf not in _REGISTRY:
        raise KeyError(f"unknown DMF {dmf!r}; expected one of {FACTORIZATIONS}")
    out = [v for v in VARIANTS if v in _REGISTRY[dmf]]
    if "la" in _REGISTRY[dmf]:
        if supports_depth(_REGISTRY[dmf]["la"]):
            out.insert(out.index("la") + 1, "la2")
        out.append("la_mb")
    if dmf in TUNABLE:
        out.append("tuned")
    return tuple(out)


def _with_depth(dmf: str, fn: Callable, depth: int) -> Callable:
    if depth == 1:
        return fn
    if not supports_depth(fn):
        raise KeyError(
            f"depth-{depth} look-ahead not available for {dmf!r}: its "
            f"driver is not pipeline-backed (band reduction interleaves two "
            f"coupled panels; DESIGN.md §10); have {list_variants(dmf)}")

    def deepened(a, b=128, **kw):
        # an explicit depth= that disagrees with the name would run another
        # schedule than the label claims
        if kw.setdefault("depth", depth) != depth:
            raise ValueError(
                f"variant name pins depth={depth} but depth={kw['depth']} "
                f"was passed; drop one of them")
        return fn(a, b, **kw)

    deepened.__name__ = f"{fn.__name__}_d{depth}"
    deepened.__doc__ = f"{fn.__name__} with look-ahead depth {depth}."
    deepened.supports_depth = True
    return deepened


def _make_la_mb(dmf: str, la: Callable) -> Callable:
    from repro_torch.kernels import ops as kops

    if dmf not in kops.FUSED_PU:
        return la                 # no fused panel update: la_mb is la

    def la_mb(a, b=128, **kw):
        # an explicit fused_pu= wins, then the backend's own registry
        # (Backend.fused_pu), then the CUDA kernels' — so backend="torch"
        # still runs the fused kernel, as the reference's jnp backend still
        # calls its Pallas kernel
        if "fused_pu" not in kw:
            default = kops.FUSED_PU.get(dmf)
            reg = resolve_backend(kw.get("backend", "cuda")).fused_pu
            kw["fused_pu"] = default if reg is None else reg.get(dmf, default)
        return la(a, b, **kw)

    la_mb.__name__ = f"{la.__name__}_mb"
    return la_mb


def _make_tuned(dmf: str, table: Dict[str, Callable]) -> Callable:
    def tuned(a, b=None, **kw):
        """Dispatch through the :mod:`repro_torch.tune` cache.

        A hit runs the cached (variant, depth, schedule) on the caller's
        backend and device; a cold cache runs ``la`` (``mtb`` where there
        is none) at the caller's block (or 128), so ``"tuned"`` always
        runs.  The key names the backend and the device type, so a winner
        measured on the CPU never serves a call on the GPU.  With
        ``mesh=`` the winner runs on the caller's mesh; a mesh winner
        (``mesh_shape``) whose cycle has another size than the caller's
        mesh is refused, and without a mesh it runs on one device.
        """
        from repro_torch import tune

        cfg = tune.tuned(dmf, tuple(a.shape), dtype=a.dtype,
                         backend=resolve_backend(kw.get("backend", "cuda"))
                         .name, device=resolve_device(kw.get("device")))
        if cfg is None:
            fallback = table.get("la", table["mtb"])
            return fallback(a, b if b is not None else 128, **kw)
        if cfg.kernel_blocks is not None:
            raise ValueError(
                f"tuned {dmf!r} entry carries kernel_blocks="
                f"{cfg.kernel_blocks}: the port's GEMM has no kernel-blocking "
                f"axis (it picks its tile from compiled instances), so the "
                f"winner cannot be reproduced; re-run repro_torch.tune.search")
        if cfg.mesh_shape is not None and kw.get("mesh") is not None:
            from repro_torch.core import distributed as _dist

            mesh = kw["mesh"]
            _dist.check_mesh(mesh)
            nd = _dist.axis_size(mesh, _dist.resolve_axis(
                mesh, kw.get("layout")))
            if tuple(cfg.mesh_shape) != (nd,):
                raise ValueError(
                    f"tuned {dmf!r} entry was measured on a mesh of shape "
                    f"{tuple(cfg.mesh_shape)}, the caller's cycle has {nd} "
                    f"ranks; re-run repro_torch.tune.search on this mesh")
        # the block is positional: band reduction names it w, not b
        return get_variant(dmf, cfg.variant)(a, cfg.schedule, **kw)

    tuned.__name__ = f"{dmf}_tuned"
    return tuned


def get_variant(dmf: str, variant: str) -> Callable:
    """Resolve (factorization, scheduling variant) to a driver
    ``fn(a, b=128, *, backend="cuda", device=None, ...)``."""
    if dmf not in _REGISTRY:
        raise KeyError(f"unknown DMF {dmf!r}; expected one of {FACTORIZATIONS}")
    table = _REGISTRY[dmf]
    base, depth = parse_variant(variant)
    if base in ("la", "la_mb", "tiled") and dmf in LOOKAHEAD_EXCLUDED:
        raise KeyError(
            f"variant {variant!r} not available for {dmf!r}: look-ahead "
            f"(and tile-DAG) scheduling is excluded by policy — "
            f"{LOOKAHEAD_EXCLUDED[dmf]}; have {list_variants(dmf)}")
    if base == "la_mb" and "la" in table:
        return _make_la_mb(dmf, _with_depth(dmf, table["la"], depth))
    if base == "tuned":
        if dmf not in TUNABLE:
            raise KeyError(
                f"variant 'tuned' not available for {dmf!r}: its block size "
                f"defines the output, not just the schedule; "
                f"have {list_variants(dmf)}")
        return _make_tuned(dmf, table)
    if base not in table:
        raise KeyError(f"variant {variant!r} not available for {dmf!r}; "
                       f"have {list_variants(dmf)}")
    return _with_depth(dmf, table[base], depth)
