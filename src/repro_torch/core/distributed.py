"""Distributed DMFs over a device mesh: the engine's ``mesh=`` axis.

The port of :mod:`repro.core.distributed`.  The panel factorization is the
serial resource; on an ``nd``-way mesh the per-rank trailing update
shrinks ``nd`` times while the panel (and its broadcast) does not, so
hiding PF and the collective behind the bulk update is worth more than on
one device.

Layout: 1-D **column block-cyclic** over one mesh dimension (ScaLAPACK
style).  Column block ``j`` (width b) lives on rank ``j % nd`` of that
dimension, local slot ``j // nd``.  Every rank owns full columns, so LU's
partial pivoting stays inside the panel and the pivot sequence is the
single-device GETRF's.  The 2-D helpers (:func:`to_block_cyclic_2d`) serve
the layout layer only: the engine keeps the 1-D cycle because full-column
ownership is what keeps pivoting local.

SPMD, not single-controller.  The reference drives one ``shard_map`` step
a hook from one process.  Here, as PyTorch programs are written, every
rank of a ``torch.distributed`` world runs the same engine loop on its own
column blocks:

* the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
  named dimensions, the counterpart of ``jax.sharding.Mesh``; ranks that
  differ only in another dimension (``data`` of a ``(data, model)`` mesh)
  each run the same cycle, as a replicated shard_map operand would;
* every rank passes the same global input, as the reference's caller
  passes one global array, and keeps its own blocks of it;
* every rank gets the global result back through a final ``all_gather``
  over the cycle's dimension.

Engine integration.  :func:`factorize_mesh` lowers the same ``mtb`` and
depth-d ``la`` schedules that :mod:`repro_torch.core.pipeline` emits,
through the per-DMF :class:`DistOps` of :data:`DIST_REGISTRY`, resolved by
``ops.name`` as ``Backend.panel_fns`` is:

* **BCAST** — the owner's updated, unfactored panel block is sent to every
  rank with ``dist.broadcast``: a pure move, so the replicated copy keeps
  every bit (a masked sum would turn ``-0.0`` into ``+0.0``).
* **PF** — every rank factors the panel itself with the backend's
  ``panel_fns`` (on the card: the GETF2 kernel, the Cholesky panel kernel,
  the QR panel kernel and its ``larft``), a small redundant O(m·b²) in
  place of a second collective; the owner writes the result back.
* **SWAP / PU / TU** — the backend's TRSM and GEMM kernels on the rank's
  own blocks.  The blocks a bulk update touches are a contiguous run of
  local slots, so each is one call over those columns.  The kernels are
  bitwise column-decomposable (``gemm(A, B)[:, j0:j1] == gemm(A, B[:,
  j0:j1])``, a TRSM solves each right-hand side in its own chain; pinned by
  ``tests/test_torch_distributed.py`` and, for the kernels, on the card),
  so the local updates reproduce the wide single-device update bit for
  bit.

Together these make every mesh variant bitwise the single-device engine at
the same schedule, pivots included.  LU's pivots reach the host once a
panel on every rank, from its own replicated panel, as on one device.

Look-ahead at depth d issues ``BCAST(k+1)`` and the replicated ``PF(k+1)``
before the bulk ``TU_k^R``: the collective and the redundant panel are
data-independent of the bulk local GEMMs.  In this port every rank issues
its work on one stream in order, so nothing overlaps on the device yet;
``repro_torch.obs`` spans tag each broadcast with its owner shard and
payload bytes, and ``report.overlap`` folds them into a broadcast-hidden
fraction (structural, as in the reference).

Transports (:func:`transport`).  The collective's transport follows from
the world's layout, fixed when the world starts
(:func:`repro_torch.launch.mesh.world_backend`), never from catching an
error: NCCL where each rank has its own GPU, gloo on CPU tensors, and gloo
on CUDA tensors where ranks share a GPU (NCCL refuses two ranks on one
device).  The last stages every collective through a host tensor,
explicitly and always (``"gloo+host"``), whatever gloo's own CUDA support
covers; the factorization's kernels still run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, normalize_block, panel_steps
from repro_torch.core.pipeline import _call
from repro_torch.device import resolve_device, working_copy
from repro_torch.obs import tracer as _obs

__all__ = [
    "Layout",
    "Transport",
    "DistOps",
    "DIST_REGISTRY",
    "resolve_axis",
    "axis_size",
    "transport",
    "broadcast_object",
    "check_mesh",
    "factorize_mesh",
    "to_block_cyclic",
    "from_block_cyclic",
    "to_block_cyclic_2d",
    "from_block_cyclic_2d",
    "lu_block_cyclic",
    "cholesky_block_cyclic",
    "qr_block_cyclic",
]


# ---------------------------------------------------------------------------
# Layout descriptor, mesh checks and mesh-axis resolution.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Layout:
    """Block-cyclic layout selector for the engine's ``mesh=`` path.

    ``axis`` names the mesh dimension carrying the 1-D column cycle;
    ``None`` defers to the active :class:`repro_torch.parallel.sharding.
    Rules` table (logical axis ``"panels"``) and then to ``"model"``.
    ``row_axis`` is reserved for a 2-D process grid: the layout helpers
    support it (:func:`to_block_cyclic_2d`), the engine does not.
    """

    axis: Optional[str] = None
    row_axis: Optional[str] = None


def check_mesh(mesh) -> None:
    """A TypeError unless ``mesh`` is a ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= expects a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__module__}.{type(mesh).__qualname__}")


def _dim_names(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions "
                         "(init_device_mesh(..., mesh_dim_names=...))")
    return tuple(names)


def resolve_axis(mesh, layout: Optional[Layout] = None) -> str:
    """The mesh dimension carrying the column cycle (layout > Rules >
    "model" > the first)."""
    names = _dim_names(mesh)
    if layout is not None and layout.axis is not None:
        if layout.axis not in names:
            raise ValueError(f"layout axis {layout.axis!r} is not a mesh "
                             f"axis (have {names})")
        return layout.axis
    from repro_torch.parallel.sharding import active_rules

    rules = active_rules()
    if rules is not None:
        ax = rules.table.get("panels")
        if isinstance(ax, str) and ax in names:
            return ax
    if "model" in names:
        return "model"
    return names[0]


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dimension ``axis``."""
    return int(mesh.size(_dim_names(mesh).index(axis)))


# ---------------------------------------------------------------------------
# Layout conversion: ragged-capable 1-D column block-cyclic, plus the 2-D
# generalization for the layout layer.  Tensors and NumPy arrays alike.
# ---------------------------------------------------------------------------
def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _padded_len(n: int, nd: int, b: int) -> int:
    """Columns after zero-padding ``n`` up to whole per-rank block rows."""
    return _ceil_div(_ceil_div(n, b), nd) * nd * b


def _cyclic_perm(n: int, nd: int, b: int) -> np.ndarray:
    nblocks = n // b
    perm = []
    for p in range(nd):
        for lj in range(nblocks // nd):
            g = lj * nd + p
            perm.extend(range(g * b, (g + 1) * b))
    return np.asarray(perm, dtype=np.int64)


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _pad(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if (rows, cols) == tuple(a.shape):
        return a
    out = a.new_zeros((rows, cols))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def to_block_cyclic(a, nd: int, b: int) -> torch.Tensor:
    """(m, n) → (nd, m, L): rank-major column block-cyclic layout.

    Shapes with ``n`` not divisible by ``nd·b`` are zero-padded on the right
    up to whole per-rank block rows (``L = ceil(ceil(n/b)/nd)·b``);
    :func:`from_block_cyclic` with ``n=`` recovers the original columns.
    """
    a = _as_tensor(a)
    m, n = a.shape
    lp = _padded_len(n, nd, b)
    a = _pad(a, m, lp)
    perm = torch.from_numpy(_cyclic_perm(lp, nd, b)).to(a.device)
    return a[:, perm].reshape(m, nd, lp // nd).permute(1, 0, 2)


def from_block_cyclic(a_cyc, b: int, n: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`to_block_cyclic`; ``n`` drops the ragged padding."""
    a_cyc = _as_tensor(a_cyc)
    nd, m, l = a_cyc.shape
    lp = nd * l
    flat = a_cyc.permute(1, 0, 2).reshape(m, lp)
    inv = torch.from_numpy(np.argsort(_cyclic_perm(lp, nd, b))).to(
        flat.device)
    out = flat[:, inv]
    return out if n is None else out[:, :n]


def to_block_cyclic_2d(a, grid: Tuple[int, int], br: int,
                       bc: int) -> torch.Tensor:
    """(m, n) → (pr, pc, mloc, nloc): 2-D block-cyclic over a process grid.

    Row block ``i`` lives on process row ``i % pr``, column block ``j`` on
    process column ``j % pc`` (ScaLAPACK's general layout).  Ragged shapes
    are zero-padded as in the 1-D case.  Layout layer only.
    """
    a = _as_tensor(a)
    pr, pc = grid
    m, n = a.shape
    mp, np_ = _padded_len(m, pr, br), _padded_len(n, pc, bc)
    a = _pad(a, mp, np_)
    rp = torch.from_numpy(_cyclic_perm(mp, pr, br)).to(a.device)
    cp = torch.from_numpy(_cyclic_perm(np_, pc, bc)).to(a.device)
    arr = a[rp][:, cp]
    return arr.reshape(pr, mp // pr, pc, np_ // pc).permute(0, 2, 1, 3)


def from_block_cyclic_2d(a_cyc, br: int, bc: int,
                         shape: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """Inverse of :func:`to_block_cyclic_2d`; ``shape`` drops the padding."""
    a_cyc = _as_tensor(a_cyc)
    pr, pc, mloc, nloc = a_cyc.shape
    mp, np_ = pr * mloc, pc * nloc
    flat = a_cyc.permute(0, 2, 1, 3).reshape(mp, np_)
    rinv = torch.from_numpy(np.argsort(_cyclic_perm(mp, pr, br))).to(
        flat.device)
    cinv = torch.from_numpy(np.argsort(_cyclic_perm(np_, pc, bc))).to(
        flat.device)
    out = flat[rinv][:, cinv]
    if shape is not None:
        out = out[: shape[0], : shape[1]]
    return out


# ---------------------------------------------------------------------------
# Transports: the collectives of one mesh dimension.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Transport:
    """The broadcast and all-gather of one mesh dimension.

    ``name`` is ``"nccl"``, ``"gloo"`` (CPU tensors) or ``"gloo+host"``
    (CUDA tensors over gloo, every collective staged through a host
    tensor); ``ranks`` are the dimension's global ranks in its order.
    """

    name: str
    group: Any
    ranks: Tuple[int, ...]

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` (an index along the dimension) on every
        rank, in place; returns ``t``."""
        import torch.distributed as dist

        if self.name != "gloo+host":
            dist.broadcast(t, src=self.ranks[src], group=self.group)
            return t
        # the owner stages its block; the others only receive into a host
        # buffer (pinned, so the copy back is a plain DMA)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if dist.get_rank() == self.ranks[src]:
            host.copy_(t)
        dist.broadcast(host, src=self.ranks[src], group=self.group)
        return t.copy_(host)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape), in the dimension's order."""
        import torch.distributed as dist

        src = t.cpu() if self.name == "gloo+host" else t.contiguous()
        out = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(out, src, group=self.group)
        return [x.to(t.device) for x in out]


def broadcast_object(mesh, obj):
    """``obj`` of the mesh's first rank (coordinate 0 on every dimension)
    on every rank of the mesh: one ``broadcast_object_list`` a dimension,
    from coordinate 0 along it, over the mesh's own groups, so ranks
    outside the mesh take no part.  Every rank of the mesh calls it."""
    import torch.distributed as dist

    ranks, coord = mesh.mesh, list(mesh.get_coordinate())
    box = [obj]
    for d in range(ranks.dim()):
        root = tuple(coord[:d]) + (0,) + tuple(coord[d + 1:])
        dist.broadcast_object_list(box, src=int(ranks[root]),
                                   group=mesh.get_group(d))
    return box[0]


def transport(mesh, axis: str, device: torch.device) -> Transport:
    """The transport of ``mesh``'s dimension ``axis`` for tensors on
    ``device``: from the group's backend and the device alone."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    backend = str(dist.get_backend(group)).lower()
    if device.type == "cuda":
        name = "nccl" if "nccl" in backend else "gloo+host"
    else:
        name = "gloo"
    ranks = tuple(dist.get_process_group_ranks(group))
    return Transport(name=name, group=group, ranks=ranks)


# ---------------------------------------------------------------------------
# The geometry of one mesh factorization.
# ---------------------------------------------------------------------------
class _Geom(NamedTuple):
    """Static geometry of one mesh factorization on one rank."""

    axis: str
    nd: int
    me: int            # this rank's index along the axis
    b: int
    m: int
    n: int
    lb: int            # local column blocks a rank (padding included)
    nloc: int          # this rank's local blocks that hold real columns
    tp: Transport

    @property
    def bcast_bytes(self) -> int:
        """Elements a panel broadcast moves off the owner."""
        return (self.nd - 1) * self.m * self.b

    def after(self, t: int) -> int:
        """The first local slot whose global block is > t."""
        return max(0, (t - self.me) // self.nd + 1)

    def cols(self, mode: str, t: int) -> Optional[slice]:
        """The local columns of the blocks a guarded update touches:
        ``"eq"`` block t (on its owner), ``"gt"`` every block > t; None
        where this rank holds none of them."""
        if mode == "eq":
            if t % self.nd != self.me or t // self.nd >= self.nloc:
                return None
            lo, hi = t // self.nd, t // self.nd + 1
        else:
            lo, hi = self.after(t), self.nloc
        if lo >= hi:
            return None
        return slice(lo * self.b, hi * self.b)

    def global_cols(self, cols: slice, device) -> torch.Tensor:
        """Global column indices of the local columns ``cols``."""
        j = torch.arange(cols.start, cols.stop, device=device)
        return (j // self.b * self.nd + self.me) * self.b + j % self.b


# ---------------------------------------------------------------------------
# Per-DMF lowering declarations, resolved by ``ops.name`` like
# ``Backend.panel_fns``.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistOps:
    """One DMF's mesh lowering: replicated PF + update of local blocks.

    * ``validate(a)`` — shape preconditions of the mesh path.
    * ``init_aux(a)`` — replicated side output (``ipiv``/``taus``/None).
    * ``pf(blk, aux, st, backend, panel_fn, geom)`` → ``(ctx, piv)`` —
      factor the broadcast block ``blk`` (m × b) in place on every rank,
      writing ``aux``; ``ctx`` is what the updates read, ``piv`` the swap
      payload (LU) or None.
    * ``update(al, ctx, st, cols, c0, geom, backend)`` — apply panel
      ``st`` to the local columns ``cols`` of ``al``, rows from ``c0``
      where the DMF's update is row-ranged (Cholesky).
    * ``finalize(a, aux)`` — the StepOps ``finalize`` packing.
    """

    name: str
    validate: Callable[[torch.Tensor], None]
    init_aux: Callable[[torch.Tensor], Any]
    pf: Callable[..., Tuple[Any, Any]]
    update: Callable[..., None]
    finalize: Callable[[torch.Tensor, Any], Any]


def _require_square(what: str):
    def check(a):
        if a.dim() != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"mesh {what} requires a square matrix, "
                             f"got {tuple(a.shape)}")
    return check


def _qr_validate(a):
    if a.dim() != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(
            f"mesh QR requires m >= n (got {tuple(a.shape)}): on wide inputs "
            f"the traversal stops mid-matrix (StepOps.stop), which the "
            f"block-cyclic loop does not model — use the single-device "
            f"engine")


def _lu_pf(blk, ipiv, st, backend, panel_fn, geom):
    from repro_torch.core.lu import lu_unblocked

    k, bk = st.k, st.bk
    piv = (panel_fn or lu_unblocked)(blk[k:, :bk])
    ipiv[k : k + bk] = piv + k
    return blk, piv


def _lu_update(al, ctx, st, cols, c0, geom, backend):
    k, bk, k_next = st.k, st.bk, st.k_next
    u12 = al[k : k + bk, cols]
    backend.trsm(ctx[k : k + bk, :bk], u12, side="left", lower=True,
                 unit_diagonal=True, out=u12)
    backend.update(al[k_next:, cols], ctx[k_next:, :bk], u12)


def _chol_pf(blk, aux, st, backend, panel_fn, geom):
    from repro_torch.core.cholesky import cholesky_panel

    k, bk = st.k, st.bk
    (panel_fn or cholesky_panel)(blk[k:, :bk], bk, backend)
    # the factored block's rows, zero past m, so that a pad column's row
    # of L is zero (the reference pads the panel the same way)
    pad = geom.nd * geom.lb * geom.b - geom.m
    ctx = torch.cat([blk, blk.new_zeros((pad, blk.shape[1]))]) if pad \
        else blk
    return ctx, None


def _chol_update(al, ctx, st, cols, c0, geom, backend):
    # A[c0:, cols] -= L[c0:, k] · L[gcols, k]ᵀ, the rows of L for the
    # local columns' global indices
    bk = st.bk
    lrow_t = ctx[geom.global_cols(cols, ctx.device), :bk].mT.contiguous()
    backend.update(al[c0:, cols], ctx[c0 : geom.m, :bk], lrow_t)


def _qr_pf(blk, taus, st, backend, panel_fn, geom):
    from repro_torch.core.qr import _hooked_factor_panel

    k, bk = st.k, st.bk
    tau, pnl = _hooked_factor_panel(blk[k:, :bk], panel_fn)
    taus[k : k + bk] = tau[:bk]              # m >= n: all bk reflectors
    return pnl, None


def _qr_update(al, ctx, st, cols, c0, geom, backend):
    from repro_torch.core.qr import apply_qt_blocked

    apply_qt_blocked(ctx, al[st.k :, cols], backend)


DIST_REGISTRY = {
    "lu": DistOps(
        name="lu",
        validate=_require_square("LU"),
        init_aux=lambda a: torch.zeros((min(a.shape),), dtype=torch.int32,
                                       device=a.device),
        pf=_lu_pf,
        update=_lu_update,
        finalize=lambda a, aux: (a, aux),
    ),
    "cholesky": DistOps(
        name="cholesky",
        validate=_require_square("Cholesky"),
        init_aux=lambda a: None,
        pf=_chol_pf,
        update=_chol_update,
        finalize=lambda a, aux: a.tril_(),
    ),
    "qr": DistOps(
        name="qr",
        validate=_qr_validate,
        init_aux=lambda a: torch.zeros((min(a.shape),), dtype=a.dtype,
                                       device=a.device),
        pf=_qr_pf,
        update=_qr_update,
        finalize=lambda a, aux: (a, aux),
    ),
}


# ---------------------------------------------------------------------------
# The mesh engine: mtb / la(depth-d) emitted over the local blocks.
# ---------------------------------------------------------------------------
def factorize_mesh(
    ops,
    a,
    b: BlockSpec = 128,
    *,
    variant: str = "la",
    depth: int = 1,
    backend="cuda",
    panel_fn: Optional[Callable] = None,
    fused_pu: Optional[Callable] = None,
    mesh=None,
    layout: Optional[Layout] = None,
    device=None,
):
    """Run one mesh-scheduled variant of ``ops`` over block-cyclic shards.

    The distributed twin of :func:`repro_torch.core.pipeline.factorize`,
    called by it when ``mesh=`` is passed.  Every rank of the mesh calls it
    with the same ``a``; each returns the whole result, bitwise the
    single-device engine's at the same schedule (module docstring).
    """
    check_mesh(mesh)
    dist_ops = DIST_REGISTRY.get(ops.name)
    if dist_ops is None:
        reason = f": {ops.la_unsafe}" if ops.la_unsafe else ""
        raise ValueError(
            f"{ops.name!r} has no mesh lowering (supported: "
            f"{', '.join(sorted(DIST_REGISTRY))}){reason}")
    if variant not in ("mtb", "la"):
        raise ValueError(
            f"mesh scheduling supports variants 'mtb' and 'la', "
            f"got {variant!r}")
    if variant == "la" and depth < 1:
        raise ValueError(f"look-ahead depth must be >= 1, got {depth}")
    if fused_pu is not None:
        raise ValueError("fused_pu (la_mb) has no mesh lowering — the fused "
                         "kernel is a single-device residency play")
    bi = normalize_block(b)
    work = working_copy(a, resolve_device(device))
    if not isinstance(bi, int):
        # a uniform schedule (what the tuner emits for scalar-b winners) is
        # its leading width; a non-uniform one cannot align with a
        # fixed-width block-cyclic layout
        widths = tuple(st.bk for st in panel_steps(work.shape[1], bi[0]))
        if tuple(bi) == widths:
            bi = int(bi[0])
        else:
            raise ValueError(
                f"mesh scheduling requires a uniform block size (panel "
                f"blocks must align with the block-cyclic layout), got "
                f"schedule {bi}")
    dist_ops.validate(work)
    be = resolve_backend(backend)
    if panel_fn is None and be.panel_fns is not None:
        panel_fn = be.panel_fns.get(ops.name)

    axis = resolve_axis(mesh, layout)
    nd = axis_size(mesh, axis)
    me = int(mesh.get_local_rank(axis))
    m, n = work.shape
    steps = list(panel_steps(n, bi))
    nblocks = _ceil_div(n, bi)
    geom = _Geom(axis=axis, nd=nd, me=me, b=bi, m=m, n=n,
                 lb=_padded_len(n, nd, bi) // (nd * bi),
                 nloc=max(0, _ceil_div(nblocks - me, nd)),
                 tp=transport(mesh, axis, work.device))
    # this rank's slice of to_block_cyclic(work, nd, b), taken directly:
    # its blocks' columns in slot order, zero past n
    al = work.new_zeros((m, geom.lb * bi))
    gcols = geom.global_cols(slice(0, geom.lb * bi), work.device)
    real = min(geom.nloc * bi, int((gcols < n).sum()))
    al[:, :real] = work[:, gcols[:real]]
    aux = dist_ops.init_aux(work)
    del work

    tr = _obs.active()
    run = _run_mesh_mtb if variant == "mtb" else _run_mesh_la
    al, aux = run(dist_ops, steps, al, aux, geom, be, panel_fn, depth, tr)
    full = from_block_cyclic(torch.stack(geom.tp.all_gather(al)), bi, n=n)
    return dist_ops.finalize(full.contiguous(), aux)


def _bcast(al, geom: _Geom, i: int) -> torch.Tensor:
    """BCAST(i): panel block i, from its owner to every rank (a copy)."""
    owner, slot = i % geom.nd, i // geom.nd
    b = geom.b
    if owner == geom.me:
        blk = al[:, slot * b : (slot + 1) * b].contiguous()
    else:
        blk = al.new_empty((geom.m, b))
    return geom.tp.broadcast(blk, owner)


def _store(al, blk, geom: _Geom, i: int) -> None:
    """The owner writes the factored panel block back into its slot."""
    if i % geom.nd == geom.me:
        slot = i // geom.nd
        al[:, slot * geom.b : (slot + 1) * geom.b] = blk


def _swap(al, piv, geom: _Geom, i: int, k: int):
    """Panel i's row interchanges on every local block but the panel's
    own (its rows were pivoted inside PF): exact copies, so the per-block
    application equals the wide ``laswp``."""
    from repro_torch.core.lu import _moved_rows

    rows = _moved_rows(piv, k, al.device)
    if rows is None:
        return al
    dst, src = rows
    b, hi = geom.b, geom.nloc * geom.b
    skip = (i // geom.nd) * b if i % geom.nd == geom.me else None
    ranges = [(0, hi)] if skip is None else [(0, skip), (skip + b, hi)]
    for c0, c1 in ranges:
        if c0 < c1:
            block = al[:, c0:c1]
            block[dst] = block[src]
    return al


def _update(dist_ops, al, ctx, st, mode, t, c0, geom, backend):
    cols = geom.cols(mode, t)
    if cols is not None:
        dist_ops.update(al, ctx, st, cols, c0, geom, backend)
    return al


def _run_mesh_mtb(dist_ops, steps, al, aux, geom, backend, panel_fn, depth,
                  tr):
    """BCAST(k) ; replicated PF(k) ; store ; SWAP ; bulk TU — Listing 3 on
    the local blocks (span tags as ``pipeline._run_blocked``'s)."""
    nbytes = geom.bcast_bytes * al.element_size()
    n = geom.n
    for i, st in enumerate(steps):
        owner = i % geom.nd
        blk = _call(tr, "BCAST", f"BCAST({i})", lambda: _bcast(al, geom, i),
                    step=i, it=i, shard=owner, bytes=nbytes)
        ctx, piv = _call(
            tr, "PF", f"PF({i})",
            lambda: dist_ops.pf(blk, aux, st, backend, panel_fn, geom),
            step=i, it=i, shard=owner)
        _store(al, blk, geom, i)
        if piv is not None:
            _call(tr, "SWAP", f"SWAP({i})",
                  lambda: _swap(al, piv, geom, i, st.k), step=i, it=i)
        if st.k_next < n:
            _call(tr, "TU", f"TU({i})",
                  lambda: _update(dist_ops, al, ctx, st, "gt", i,
                                  st.k_next, geom, backend),
                  step=i, it=i, cols=(st.k_next, n))
    return al, aux


def _run_mesh_la(dist_ops, steps, al, aux, geom, backend, panel_fn, depth,
                 tr):
    """Depth-d look-ahead on the local blocks (span tags as
    ``pipeline._run_la``'s).

    Iteration i: deferred SWAP(i) → narrow PU(i→i+1) → BCAST(i+1) +
    replicated PF(i+1) (both data-independent of the bulk) → narrow
    PU(i→i+j), j ≥ 2 → bulk TU_right(i).
    """
    nbytes = geom.bcast_bytes * al.element_size()
    n, nd = geom.n, geom.nd
    nsteps = len(steps)

    # prologue: broadcast and factor panel 0 ahead of the loop (it = -1)
    blk = _call(tr, "BCAST", "BCAST(0)", lambda: _bcast(al, geom, 0),
                step=0, it=-1, depth=1, shard=0, bytes=nbytes)
    ctx, piv = _call(
        tr, "PF", "PF(0)",
        lambda: dist_ops.pf(blk, aux, steps[0], backend, panel_fn, geom),
        step=0, it=-1, depth=1, shard=0)
    _store(al, blk, geom, 0)

    for i, st in enumerate(steps):
        if piv is not None:
            _call(tr, "SWAP", f"SWAP({i})",
                  lambda: _swap(al, piv, geom, i, st.k), step=i, it=i)
        if st.k_next >= n:
            break
        dd = min(depth, nsteps - 1 - i)
        nctx = npiv = None
        for j in range(1, dd + 1):
            stj = steps[i + j]
            tb = i + j
            _call(tr, "PU", f"PU({i}->{tb})",
                  lambda: _update(dist_ops, al, ctx, st, "eq", tb, stj.k,
                                  geom, backend),
                  step=i, it=i, depth=j, cols=(stj.k, stj.k_next),
                  shard=tb % nd)
            if j == 1:
                owner = tb % nd
                blkj = _call(tr, "BCAST", f"BCAST({tb})",
                             lambda: _bcast(al, geom, tb), step=tb, it=i,
                             depth=1, shard=owner, bytes=nbytes)
                nctx, npiv = _call(
                    tr, "PF", f"PF({tb})",
                    lambda: dist_ops.pf(blkj, aux, stj, backend, panel_fn,
                                        geom),
                    step=tb, it=i, depth=1, shard=owner)
                _store(al, blkj, geom, tb)
        r0 = steps[i + dd].k_next if dd >= 1 else st.k_next
        if r0 < n:
            _call(tr, "TU", f"TU({i})",
                  lambda: _update(dist_ops, al, ctx, st, "gt", i + dd, r0,
                                  geom, backend),
                  step=i, it=i, cols=(r0, n), inflight=dd)
        if nctx is not None:
            ctx, piv = nctx, npiv
    return al, aux


# ---------------------------------------------------------------------------
# The reference's standalone drivers, emitted by the engine.
# ---------------------------------------------------------------------------
def lu_block_cyclic(a, b: int, mesh, *, axis: str = "model",
                    lookahead: bool = True, backend="cuda", device=None):
    """Distributed LUpp.  Returns (packed LU (n, n), ipiv (n,))."""
    from repro_torch.core.lu import LU_OPS

    return factorize_mesh(LU_OPS, a, b, variant="la" if lookahead else "mtb",
                          backend=backend, mesh=mesh,
                          layout=Layout(axis=axis), device=device)


def cholesky_block_cyclic(a, b: int, mesh, *, axis: str = "model",
                          lookahead: bool = True, backend="cuda",
                          device=None):
    """Distributed Cholesky (lower).  Returns L (n, n)."""
    from repro_torch.core.cholesky import CHOLESKY_OPS

    return factorize_mesh(CHOLESKY_OPS, a, b,
                          variant="la" if lookahead else "mtb",
                          backend=backend, mesh=mesh,
                          layout=Layout(axis=axis), device=device)


def qr_block_cyclic(a, b: int, mesh, *, axis: str = "model",
                    lookahead: bool = True, backend="cuda", device=None):
    """Distributed GEQRF.  Returns (packed (m, n), tau (n,))."""
    from repro_torch.core.qr import QR_OPS

    return factorize_mesh(QR_OPS, a, b, variant="la" if lookahead else "mtb",
                          backend=backend, mesh=mesh,
                          layout=Layout(axis=axis), device=device)
