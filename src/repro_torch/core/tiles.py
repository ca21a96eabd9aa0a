"""Tile-DAG scheduling backend (``variant="tiled"``).

The port of :mod:`repro.core.tiles`.  The paper sets its static look-ahead
against runtime task-DAG schedulers; this module is that alternative, as
the tiled-QR papers describe it (Buttari, Langou, Kurzak, Dongarra;
PAPERS.md): cut the matrix into b × b tiles, emit one task per tile
operation, derive the dependency DAG from the data each task reads and
writes, and run the DAG in topological **wavefronts** instead of the
panel + update pipeline.

Lowering from :class:`~repro_torch.core.pipeline.StepOps`:

* ``factor`` → the diagonal task kinds: ``GEQRT`` (GEQR2 + LARFT of a
  tile through :func:`repro_torch.core.qr._hooked_factor_panel`, so the
  backend's QR panel kernel carries over) and ``POTRF`` (the backend's
  Cholesky panel, else :func:`repro_torch.core.cholesky.cholesky_panel`).
* ``update``/``tiles`` → the off-diagonal kinds: ``UNMQR``/``TSMQR``
  (block-reflector applies, :func:`repro_torch.core.qr.apply_qt_blocked`)
  and ``TRSM``/``SYRK``/``GEMM`` (``backend.trsm`` / ``backend.update``,
  the per-tile ops the ``rtm`` variant issues).  The task bodies take
  their kernels only from the backend, so ``backend="torch"`` runs
  library ops alone.
* :func:`make_tiled` refuses declarations with ``la_unsafe`` and
  declarations without a ``tiles`` hook, as the reference does.

In place.  Tiles are views of the driver's one working copy and the task
bodies update them in place, as the rest of the port does.  Where the
reference concatenates two tiles (TSQRT's ``[R_kk; A_ik]``, TSMQR's
``[C_kj; C_ij]``), the port works on one contiguous stacked copy and
writes it back; "annihilated exactly" is ``zero_()``.

Determinism.  Task keys are canonical ``(k, i, j)`` triples; wavefront w
holds every task of dependency depth w, sorted by key, and the executor
runs waves in order and tasks within a wave in key order on one stream.
So the reduction order (the flat TSQRT chain down a tile column included)
is fixed and two runs are bitwise equal.

Numerics.  ``POTRF``/``TRSM``/``SYRK``/``GEMM`` are the Cholesky
variants' ops on tile operands, and the GEMM and TRSM kernels are row- and
column-decomposable, so tiled Cholesky is bitwise the ``rtm``/``mtb``
factor at the same block.  Tile QR is *incremental* QR, another reflector
set than GEQRF, so it is checked by reconstruction and orthogonality; a
single tile covering the matrix is GEQRF and is bitwise.  ``TSQRT`` is
GEQR2 on the stacked pair (the unstructured spelling: it reuses the panel
kernel and forgoes the triangle's flop savings).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import qr as _qr
from repro_torch.core.backend import resolve_backend
from repro_torch.core.blocking import BlockSpec, expand_schedule
from repro_torch.core.cholesky import CHOLESKY_OPS, cholesky_panel
from repro_torch.core.pipeline import StepOps
from repro_torch.core.qr import QR_OPS, Panel
from repro_torch.device import resolve_device, working_copy
from repro_torch.obs import tracer as _obs

__all__ = [
    "TileTask",
    "TileDag",
    "build_dag",
    "run_dag",
    "tile_grid",
    "TileReflector",
    "TileQR",
    "qr_apply_qt",
    "qr_form_q",
    "qr_tiles",
    "cholesky_tiles",
    "make_tiled",
    "TILE_PROGRAMS",
    "TILE_TASK_KINDS",
]

#: Every task kind a tile program may emit (the cost model and the trace
#: report key off these names).
TILE_TASK_KINDS = ("GEQRT", "TSQRT", "UNMQR", "TSMQR",
                   "POTRF", "TRSM", "SYRK", "GEMM")


# ---------------------------------------------------------------------------
# Task graph: tasks, dependencies, wavefronts.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TileTask:
    """One tile operation.

    ``key`` is the canonical ``(k, i, j)`` identity.  ``reads``/``writes``
    name symbolic resources: ``("A", i, j)`` for tile values and
    ``("V", k, i)`` for reflector contexts.  Keeping V apart from A lets
    ``UNMQR(k, j)`` read only ``("V", k, k)``, so it does not serialize
    against the ``TSQRT`` chain that rewrites tile ``(k, k)``.
    """

    kind: str
    key: Tuple[int, int, int]
    reads: Tuple[Tuple, ...]
    writes: Tuple[Tuple, ...]
    run: Callable[[Dict[str, Any]], Any]


@dataclasses.dataclass(frozen=True)
class TileDag:
    """Tasks, dependency edges and the wavefront schedule."""

    tasks: Tuple[TileTask, ...]
    deps: Dict[Tuple[int, int, int], frozenset]
    wave: Dict[Tuple[int, int, int], int]
    waves: Tuple[Tuple[TileTask, ...], ...]

    @property
    def depth(self) -> int:
        """Critical-path length in tasks (the number of wavefronts)."""
        return len(self.waves)


def build_dag(tasks: List[TileTask]) -> TileDag:
    """RAW/WAR/WAW dependencies by dataflow over the symbolic resources.

    ``tasks`` come in a valid sequential (program) order; the builder
    tracks the last writer and the readers since the last write of every
    resource, the analysis an OpenMP ``depend(in/out)`` runtime makes.
    """
    keys = [t.key for t in tasks]
    if len(set(keys)) != len(keys):
        raise ValueError("tile task keys must be unique within a program")
    deps: Dict[Tuple[int, int, int], set] = {t.key: set() for t in tasks}
    last_writer: Dict[Tuple, Tuple[int, int, int]] = {}
    readers: Dict[Tuple, List[Tuple[int, int, int]]] = {}
    for t in tasks:
        d = deps[t.key]
        for res in t.reads + t.writes:          # RAW (and WAW via writes)
            w = last_writer.get(res)
            if w is not None and w != t.key:
                d.add(w)
        for res in t.writes:                    # WAR
            for rd in readers.get(res, ()):
                if rd != t.key:
                    d.add(rd)
        for res in t.reads:
            readers.setdefault(res, []).append(t.key)
        for res in t.writes:
            last_writer[res] = t.key
            readers[res] = []                   # deps now chain via the writer
    wave: Dict[Tuple[int, int, int], int] = {}
    for t in tasks:                             # program order: deps resolved
        d = deps[t.key]
        wave[t.key] = 0 if not d else 1 + max(wave[k] for k in d)
    nwaves = 1 + max(wave.values()) if wave else 0
    buckets: List[List[TileTask]] = [[] for _ in range(nwaves)]
    for t in tasks:
        buckets[wave[t.key]].append(t)
    waves = tuple(tuple(sorted(w, key=lambda t: t.key)) for w in buckets)
    return TileDag(tasks=tuple(tasks),
                   deps={k: frozenset(v) for k, v in deps.items()},
                   wave=wave, waves=waves)


def run_dag(dag: TileDag, st: Dict[str, Any]) -> None:
    """Run the wavefronts in order, tasks within a wave in key order.

    With a tracer installed every task is one ``TILE`` span tagged with
    its kind and its wavefront (``dag_depth``), from which
    :func:`repro_torch.obs.report.tile_dag` rebuilds the critical path.
    """
    tr = _obs.active()
    for w, tasks in enumerate(dag.waves):
        for t in tasks:
            if tr is None:
                t.run(st)
            else:
                tr.wrap("TILE", f"{t.kind}{t.key}", lambda t=t: t.run(st),
                        step=t.key[0], it=w, kind=t.kind, dag_depth=w)


def tile_grid(n: int, b: BlockSpec) -> Tuple[Tuple[int, int], ...]:
    """``(offset, width)`` of each tile along one axis (the widths sum to
    ``n``)."""
    out, k = [], 0
    for w in expand_schedule(n, b):
        out.append((k, w))
        k += w
    return tuple(out)


# ---------------------------------------------------------------------------
# Compact-WY tile QR: GEQRT / TSQRT / UNMQR / TSMQR.
# ---------------------------------------------------------------------------
def _run_geqrt(k: int):
    def run(st):
        tile = st["tiles"][(k, k)]
        _, st["ctx"][(k, k)] = _qr._hooked_factor_panel(tile, st["panel_fn"])
        return tile.triu_()
    return run


def _run_unmqr(k: int, j: int):
    def run(st):
        return _qr.apply_qt_blocked(st["ctx"][(k, k)], st["tiles"][(k, j)],
                                    st["backend"])
    return run


def _run_tsqrt(k: int, i: int):
    def run(st):
        top, bot = st["tiles"][(k, k)], st["tiles"][(i, k)]
        pair = torch.cat([top, bot])
        _, st["ctx"][(k, i)] = _qr._hooked_factor_panel(pair, st["panel_fn"])
        top.copy_(pair[: top.shape[0]].triu_())
        bot.zero_()                              # annihilated exactly
        return top
    return run


def _run_tsmqr(k: int, i: int, j: int):
    def run(st):
        top, bot = st["tiles"][(k, j)], st["tiles"][(i, j)]
        pair = _qr.apply_qt_blocked(st["ctx"][(k, i)], torch.cat([top, bot]),
                                    st["backend"])
        top.copy_(pair[: top.shape[0]])
        bot.copy_(pair[top.shape[0]:])
        return pair
    return run


def _qr_tasks(nrt: int, nct: int) -> List[TileTask]:
    """The tile-QR task program over an ``nrt × nct`` tile grid."""
    tasks: List[TileTask] = []
    for k in range(min(nrt, nct)):
        tasks.append(TileTask("GEQRT", (k, k, k),
                              reads=(("A", k, k),),
                              writes=(("A", k, k), ("V", k, k)),
                              run=_run_geqrt(k)))
        for j in range(k + 1, nct):
            tasks.append(TileTask("UNMQR", (k, k, j),
                                  reads=(("V", k, k), ("A", k, j)),
                                  writes=(("A", k, j),),
                                  run=_run_unmqr(k, j)))
        for i in range(k + 1, nrt):
            tasks.append(TileTask("TSQRT", (k, i, k),
                                  reads=(("A", k, k), ("A", i, k)),
                                  writes=(("A", k, k), ("A", i, k),
                                          ("V", k, i)),
                                  run=_run_tsqrt(k, i)))
            for j in range(k + 1, nct):
                tasks.append(TileTask("TSMQR", (k, i, j),
                                      reads=(("V", k, i), ("A", k, j),
                                             ("A", i, j)),
                                      writes=(("A", k, j), ("A", i, j)),
                                      run=_run_tsmqr(k, i, j)))
    return tasks


# ---------------------------------------------------------------------------
# Tile-QR result: R and the ordered reflector chain (incremental QR has
# another reflector set than GEQRF, so there is no packed form).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TileReflector:
    """One compact-WY block reflector ``I − V·T·Vᵀ`` over a row subset.

    ``panel`` holds V with the contiguous ``Vᵀ`` and ``Tᵀ`` the GEMM kernel
    reads.  ``rows0`` is the (start, stop) row span of the diagonal tile,
    ``rows1`` the span of the annihilated tile of a TSQRT (None for a
    GEQRT).
    """

    panel: Panel
    col: int
    rows0: Tuple[int, int]
    rows1: Optional[Tuple[int, int]]

    @property
    def v(self) -> torch.Tensor:
        return self.panel.v

    @property
    def t(self) -> torch.Tensor:
        return self.panel.tt.mT


@dataclasses.dataclass(frozen=True)
class TileQR:
    """Tiled QR output: the upper-trapezoidal ``r`` (m × n) and the
    reflector chain in factorization order (``Q = H_0·H_1·…``)."""

    r: torch.Tensor
    factors: Tuple[TileReflector, ...]


def _gather_rows(f: TileReflector, c: torch.Tensor) -> torch.Tensor:
    """The rows ``f`` acts on: a view for a GEQRT, a stacked copy for a
    TSQRT."""
    r0, r1 = f.rows0
    if f.rows1 is None:
        return c[r0:r1]
    s0, s1 = f.rows1
    return torch.cat([c[r0:r1], c[s0:s1]])


def _scatter_rows(f: TileReflector, c: torch.Tensor,
                  cr: torch.Tensor) -> None:
    """Write a stacked copy from :func:`_gather_rows` back into ``c``."""
    if f.rows1 is None:
        return                                   # cr is a view of c
    r0, r1 = f.rows0
    s0, s1 = f.rows1
    c[r0:r1].copy_(cr[: r1 - r0])
    c[s0:s1].copy_(cr[r1 - r0:])


def qr_apply_qt(tqr: TileQR, c, *, backend="cuda") -> torch.Tensor:
    """``Qᵀ·C`` from a :class:`TileQR` (ORMQR analogue, forward order);
    returns a new tensor on ``tqr.r``'s device and dtype."""
    be = resolve_backend(backend)
    c = torch.as_tensor(c).to(device=tqr.r.device, dtype=tqr.r.dtype).clone()
    vec = c.dim() == 1
    if vec:
        c = c[:, None]
    for f in tqr.factors:
        cr = _gather_rows(f, c)
        _qr.apply_qt_blocked(f.panel, cr, be)
        _scatter_rows(f, c, cr)
    return c[:, 0] if vec else c


def qr_form_q(tqr: TileQR, *, backend="cuda") -> torch.Tensor:
    """Q (m × m) explicitly from a :class:`TileQR` (ORGQR analogue)."""
    be = resolve_backend(backend)
    m = tqr.r.shape[0]
    q = torch.eye(m, dtype=tqr.r.dtype, device=tqr.r.device)
    for f in reversed(tqr.factors):
        rows = _gather_rows(f, q)
        # rows ← (I − V·T·Vᵀ)·rows
        w = be.gemm(f.t.contiguous(), be.gemm(f.panel.vt, rows))
        be.update(rows, f.v, w)
        _scatter_rows(f, q, rows)
    return q


# ---------------------------------------------------------------------------
# Tiled Cholesky: POTRF / TRSM / SYRK / GEMM (lower tiles only).
# ---------------------------------------------------------------------------
def _run_potrf(k: int):
    def run(st):
        tile = st["tiles"][(k, k)]
        return (st["panel_fn"] or cholesky_panel)(tile, tile.shape[0],
                                                  st["backend"])
    return run


def _run_trsm(k: int, i: int):
    def run(st):
        tile = st["tiles"][(i, k)]
        return st["backend"].trsm(st["tiles"][(k, k)], tile, side="right",
                                  lower=True, trans=True, out=tile)
    return run


def _run_syrk(k: int, j: int):
    def run(st):
        lj = st["tiles"][(j, k)]
        return st["backend"].update(st["tiles"][(j, j)], lj,
                                    lj.mT.contiguous())
    return run


def _run_gemm(k: int, i: int, j: int):
    def run(st):
        return st["backend"].update(st["tiles"][(i, j)], st["tiles"][(i, k)],
                                    st["tiles"][(j, k)].mT.contiguous())
    return run


def _cholesky_tasks(nt: int) -> List[TileTask]:
    """The tile-Cholesky task program over an ``nt × nt`` lower tile grid."""
    tasks: List[TileTask] = []
    for k in range(nt):
        tasks.append(TileTask("POTRF", (k, k, k),
                              reads=(("A", k, k),),
                              writes=(("A", k, k),),
                              run=_run_potrf(k)))
        for i in range(k + 1, nt):
            tasks.append(TileTask("TRSM", (k, i, k),
                                  reads=(("A", k, k), ("A", i, k)),
                                  writes=(("A", i, k),),
                                  run=_run_trsm(k, i)))
        for j in range(k + 1, nt):
            tasks.append(TileTask("SYRK", (k, j, j),
                                  reads=(("A", j, k), ("A", j, j)),
                                  writes=(("A", j, j),),
                                  run=_run_syrk(k, j)))
            for i in range(j + 1, nt):
                tasks.append(TileTask("GEMM", (k, i, j),
                                      reads=(("A", i, k), ("A", j, k),
                                             ("A", i, j)),
                                      writes=(("A", i, j),),
                                      run=_run_gemm(k, i, j)))
    return tasks


# ---------------------------------------------------------------------------
# Drivers.  Each copies ``a`` once to ``device`` (None = the GPU).
# ---------------------------------------------------------------------------
def _state(work, rows, cols, backend, panel_fn, dmf: str, lower: bool):
    be = resolve_backend(backend)
    if panel_fn is None and be.panel_fns is not None:
        panel_fn = be.panel_fns.get(dmf)
    tiles = {(bi, bj): work[ri:ri + mi, cj:cj + nj]
             for bi, (ri, mi) in enumerate(rows)
             for bj, (cj, nj) in enumerate(cols)
             if bi >= bj or not lower}
    return {"tiles": tiles, "ctx": {}, "backend": be, "panel_fn": panel_fn}


def _no_mesh(mesh, layout) -> None:
    """The tile DAG has no mesh lowering: the mesh engine's refusal."""
    if mesh is not None or layout is not None:
        raise ValueError("mesh scheduling supports variants 'mtb' and 'la', "
                         "got 'tiled'")


def _qr_tiles(a, b: BlockSpec = 128, *, backend="cuda",
              panel_fn: Optional[Callable] = None, device=None, mesh=None,
              layout=None) -> TileQR:
    """Tiled compact-WY QR (``variant="tiled"``); returns :class:`TileQR`."""
    _no_mesh(mesh, layout)
    work = working_copy(a, resolve_device(device))
    if work.dim() != 2:
        raise ValueError(f"QR needs a matrix, got shape {tuple(work.shape)}")
    m, n = work.shape
    rows, cols = tile_grid(m, b), tile_grid(n, b)
    st = _state(work, rows, cols, backend, panel_fn, "qr", lower=False)
    run_dag(build_dag(_qr_tasks(len(rows), len(cols))), st)
    factors = []
    for (k, i) in sorted(st["ctx"]):
        r0 = (rows[k][0], rows[k][0] + rows[k][1])
        r1 = None if i == k else (rows[i][0], rows[i][0] + rows[i][1])
        factors.append(TileReflector(panel=st["ctx"][(k, i)], col=k,
                                     rows0=r0, rows1=r1))
    # the annihilated tiles are zero and the diagonal tiles triangular, so
    # this only clears what no task reaches (nothing, on a full grid)
    return TileQR(r=work.triu_(), factors=tuple(factors))


def _cholesky_tiles(a, b: BlockSpec = 128, *, backend="cuda",
                    panel_fn: Optional[Callable] = None, device=None,
                    mesh=None, layout=None) -> torch.Tensor:
    """Tiled Cholesky (``variant="tiled"``); returns the lower factor L."""
    _no_mesh(mesh, layout)
    work = working_copy(a, resolve_device(device))
    if work.dim() != 2 or work.shape[0] != work.shape[1]:
        raise ValueError(
            f"cholesky requires a square matrix, got {tuple(work.shape)}")
    grid = tile_grid(work.shape[0], b)
    st = _state(work, grid, grid, backend, panel_fn, "cholesky", lower=True)
    run_dag(build_dag(_cholesky_tasks(len(grid))), st)
    # tiles below the diagonal are whole, the diagonal ones already lower
    # triangular; the upper tiles were never read
    return work.tril_()


#: StepOps name → (task-program builder, driver).  The builders let the
#: cost model and the tests enumerate the task multiset without running.
TILE_PROGRAMS: Dict[str, Tuple[Callable, Callable]] = {
    "qr": (_qr_tasks, _qr_tiles),
    "cholesky": (_cholesky_tasks, _cholesky_tiles),
}


def make_tiled(ops: StepOps) -> Callable:
    """The tiled driver of a StepOps declaration, policy-checked.

    As for look-ahead: a declaration with ``la_unsafe`` (its panel reads
    the whole trailing block) has no tile decomposition either, and one
    without a ``tiles`` hook never named its per-tile fragmentation.
    """
    if ops.la_unsafe:
        raise ValueError(
            f"cannot emit a tile DAG for {ops.name!r}: {ops.la_unsafe}")
    if ops.tiles is None:
        raise ValueError(
            f"cannot emit a tile DAG for {ops.name!r}: its StepOps "
            f"declaration names no per-tile fragmentation (tiles hook)")
    if ops.name not in TILE_PROGRAMS:
        raise KeyError(
            f"no tile task program registered for {ops.name!r}; "
            f"have {tuple(TILE_PROGRAMS)}")
    return TILE_PROGRAMS[ops.name][1]


qr_tiles = make_tiled(QR_OPS)
cholesky_tiles = make_tiled(CHOLESKY_OPS)
