"""Analytical cost model that seeds and prunes the empirical sweep.

The port of :mod:`repro.tune.model`, with the reference's formulas and the
card's own constants.  A cheap analytical ranking picks the few candidates
worth measuring ("Co-Design of the Dense Linear Algebra Software Stack",
PAPERS.md); only those are timed.  It turns on two facts of the paper's
§5/§6.1 analysis:

* the trailing update runs near the GEMM kernel's rate (``GEMM_EFF``),
  while the panel factorization is latency-bound and runs far below peak
  (``PANEL_EFF``), which is what makes a small ``b`` lose;
* the variants combine the two per iteration differently: ``mtb`` adds
  them, ``la``/``la_mb`` take ``max(PF, TU)`` (paper §4), ``rtm`` pays a
  per-task overhead for its fragmented update, and ``tiled`` sums its
  tasks.

The port runs every op on one CUDA stream, so ``la`` does not overlap PF
and TU on the card (PERF.md §5); the model keeps the reference's overlap
formula all the same.  It only ranks, and the search always measures the
fixed-``b`` baseline, so the gap shows as the model-against-measured rows
of :func:`repro_torch.obs.report.attainment_row`.

One term is the port's own: :data:`PANEL_COLUMN_S`, a fixed time per panel
column.  The reference prices a panel by its flops alone, which grow as
b², so its ranking pushes the block down; the card's panel kernels pay a
fixed time a column (grid barriers and cross-block sums, PERF.md §7), and
measured on the card that ranking never reached the blocks that win
(PERF.md §6, the tuner's entry).  With the term at 0 the model is the
reference's.

Constants.  :data:`MACHINE` is the H100's record (NVIDIA's data sheet,
SXM part, 700 W); the efficiencies and overheads come from the port's own
chip runs, and PERF.md §6 (the tuner's entry) derives each of them.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.blocking import BlockSpec, expand_schedule, panel_steps
from repro_torch.tune.cache import dtype_name

__all__ = ["Machine", "MACHINE", "predict", "rank", "step_costs",
           "STEP_COSTS", "TILE_TASK_COSTS", "GEMM_EFF", "PANEL_EFF",
           "PANEL_COLUMN_S"]


@dataclasses.dataclass(frozen=True)
class Machine:
    """Roofline and memory constants of the target card: one NVIDIA H100
    80GB HBM3 (SXM) at its 700 W power limit, dense rates from NVIDIA's
    data sheet.  A card set below 700 W runs slower under load."""

    name: str = "NVIDIA H100 80GB HBM3"
    power_limit_w: float = 700.0
    #: dense peak FLOP/s by dtype: float64 through the tensor cores (DMMA),
    #: float32 on the CUDA cores (the port's float32 GEMM runs there),
    #: bfloat16 / float16 through the tensor cores
    peak_flops: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"float64": 67e12, "float32": 67e12,
                                 "bfloat16": 989e12, "float16": 989e12})
    hbm_bytes_per_s: float = 3.35e12
    sms: int = 132
    smem_per_sm_bytes: int = 228 * 1024
    l2_bytes: float = 50e6

    def peak(self, dtype) -> float:
        """Dense peak FLOP/s for ``dtype``."""
        return self.peak_flops[dtype_name(dtype)]


MACHINE = Machine()

# The efficiencies and overheads, measured on the H100 above; PERF.md §6
# (the tuner's entry) derives each.
#: Fraction of peak the trailing-update GEMM reaches, per backend: the
#: GEMM-accumulate kernel (``"cuda"``) and ``addmm_`` (``"torch"``) at the
#: TU's 8064 × 128 · 128 × 8064 in float64.
GEMM_EFF = {"cuda": 0.30, "torch": 0.28}
#: Fraction of peak of a panel's flops, beside its fixed time a column:
#: the GETF2 kernel at 8192 × 128 and 8192 × 384 in float64, fitted.
PANEL_EFF = 0.070
#: Fixed seconds per panel column, by DMF: the panel kernels' (GETF2, the
#: Cholesky panel, GEQR2 + LARFT, the windowed xLAQPS) and the PyTorch-op
#: sweeps' (LDLᵀ, Gauss–Jordan).  Global QRCP's and Hessenberg's panel
#: flops already grow as b (their GEMVs over the trailing matrix); 0 there.
PANEL_COLUMN_S = {"lu": 3.3e-6, "cholesky": 0.63e-6, "qr": 4.5e-6,
                  "qrcp_local": 9.9e-6, "ldlt": 83e-6,
                  "gauss_jordan": 188e-6}
#: Per iteration: the host work of a step beside its modeled PF and TU.
STEP_OVERHEAD_S = 0.3e-3
#: Per ``rtm`` tile task: one GEMM wrapper call.
RTM_TASK_OVERHEAD_S = 42e-6
#: Per tile-DAG task (tiled Cholesky at n 8192, b 256).
TILE_TASK_OVERHEAD_S = 85e-6


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name(dtype))
                       ).element_size()


# ---------------------------------------------------------------------------
# Per-step (panel_flops, update_flops, update_bytes); ``k, bk`` from the
# PanelStep, ``n`` the traversal width.  The reference's formulas.
# ---------------------------------------------------------------------------
def _lu(n: int, k: int, bk: int, itemsize: int):
    r = n - k - bk
    pf = 2.0 * bk * bk * (n - k)                     # GETF2 rank-1 sweep
    tu = bk * bk * r + 2.0 * bk * r * r              # TRSM + GEMM
    byts = 3.0 * r * (r + bk) * itemsize             # read/update/write trailing
    return pf, tu, byts


def _cholesky(n: int, k: int, bk: int, itemsize: int):
    r = n - k - bk
    pf = bk * bk * (n - k)
    tu = bk * bk * r + bk * r * r                    # TRSM + half-GEMM (syrk)
    byts = 1.5 * r * (r + bk) * itemsize
    return pf, tu, byts


def _qr(n: int, k: int, bk: int, itemsize: int):
    r = n - k - bk
    m = n - k                                        # panel rows
    pf = 4.0 * bk * bk * m                           # GEQR2 + T build
    tu = 4.0 * bk * m * r                            # two GEMMs of the WY apply
    byts = 3.0 * m * r * itemsize
    return pf, tu, byts


def _gauss_jordan(n: int, k: int, bk: int, itemsize: int):
    pf = 2.0 * bk * bk * n                           # D⁻¹ + M build
    tu = 2.0 * bk * n * (n - bk)                     # update of ALL other cols
    byts = 3.0 * n * n * itemsize
    return pf, tu, byts


def _band_reduction(n: int, k: int, bk: int, itemsize: int):
    r = n - k - bk
    m = n - k
    pf = 8.0 * bk * bk * m                           # left QR + right LQ panels
    tu = 8.0 * bk * m * r                            # both two-sided updates
    byts = 4.0 * m * r * itemsize
    return pf, tu, byts


def _qrcp(n: int, k: int, bk: int, itemsize: int):
    # GEQP3: every reflector's F column is a GEMV over the whole trailing
    # block, so half the flops live in PF
    r = n - k - bk
    m = n - k
    pf = 4.0 * bk * m * (n - k)                      # F GEMVs + pivot rows
    tu = 2.0 * bk * m * r                            # deferred V·Fᵀ GEMM
    byts = 3.0 * m * r * itemsize
    return pf, tu, byts


def _qrcp_local(n: int, k: int, bk: int, itemsize: int):
    # windowed pivoting: the pivot search stays in the panel, so the panel
    # costs GEQR2 plus the pivot bookkeeping, O(m·b²) as for QR
    r = n - k - bk
    m = n - k
    pf = 5.0 * bk * bk * m                           # GEQR2 + F + norm track
    tu = 4.0 * bk * m * r                            # two GEMMs of the WY apply
    byts = 3.0 * m * r * itemsize
    return pf, tu, byts


def _hessenberg(n: int, k: int, bk: int, itemsize: int):
    # GEHRD: the panel's A₀·v GEMVs run over the full matrix; the update
    # is two-sided (the right one over all n rows)
    r = n - k - bk
    pf = 2.0 * bk * n * (n - k)                      # W = A₀·V build
    tu = 6.0 * bk * n * r                            # right + left WY GEMMs
    byts = 4.0 * n * r * itemsize
    return pf, tu, byts


STEP_COSTS: Dict[str, Callable] = {
    "lu": _lu,
    "cholesky": _cholesky,
    "qr": _qr,
    "ldlt": _cholesky,                               # same BLAS-3 shape
    "gauss_jordan": _gauss_jordan,
    "band_reduction": _band_reduction,
    "qrcp": _qrcp,
    "qrcp_local": _qrcp_local,
    "hessenberg": _hessenberg,
}


#: Cost entries of the tile task kinds: tile widths (w_k, w_i, w_j) of a
#: task keyed (k, i, j) and the itemsize → (flops, bytes, class).
#: ``"panel"`` tasks run at PANEL_EFF; ``"gemm"`` tasks at the backend's
#: GEMM efficiency, or their HBM traffic if that takes longer.
TILE_TASK_COSTS: Dict[str, Callable] = {
    # GEQR2 + T on the w_k × w_k diagonal tile
    "GEQRT": lambda wk, wi, wj, it: (4.0 * wk * wk * wk, 0.0, "panel"),
    # GEQR2 + T on the stacked (w_k + w_i) × w_k pair (unstructured TSQRT)
    "TSQRT": lambda wk, wi, wj, it: (4.0 * (wk + wi) * wk * wk, 0.0, "panel"),
    # WY apply (two GEMMs) of w_k reflectors to a w_k × w_j tile
    "UNMQR": lambda wk, wi, wj, it: (4.0 * wk * wk * wj,
                                     3.0 * wk * wj * it, "gemm"),
    # WY apply to the stacked (w_k + w_i) × w_j tile pair
    "TSMQR": lambda wk, wi, wj, it: (4.0 * (wk + wi) * wk * wj,
                                     3.0 * (wk + wi) * wj * it, "gemm"),
    # unblocked Cholesky of the w_k × w_k diagonal tile
    "POTRF": lambda wk, wi, wj, it: (wk * wk * wk / 3.0, 0.0, "panel"),
    # triangular solve against the w_i × w_k tile
    "TRSM": lambda wk, wi, wj, it: (wi * wk * wk,
                                    3.0 * wi * wk * it, "gemm"),
    # symmetric rank-w_k update of the w_j × w_j diagonal tile
    "SYRK": lambda wk, wi, wj, it: (2.0 * wj * wj * wk,
                                    3.0 * wj * wj * it, "gemm"),
    # rank-w_k update of the w_i × w_j tile
    "GEMM": lambda wk, wi, wj, it: (2.0 * wi * wj * wk,
                                    3.0 * wi * wj * it, "gemm"),
}


def _tile_groups(dmf: str, widths: Tuple[int, ...]):
    """``(kind, w_k, w_i, w_j, count)``: the tasks of the program the
    executor runs over the square tile grid of ``widths``
    (``core.tiles._qr_tasks`` / ``_cholesky_tasks``, a task keyed
    ``(k, i, j)`` taking the widths of tiles k, i and j), counted by kind
    and widths rather than built: 256 tiles a side make millions of tasks.
    """
    nt = len(widths)
    after = [Counter() for _ in range(nt + 1)]     # after[i]: widths[i:]
    for i in range(nt - 1, -1, -1):
        after[i] = after[i + 1] + Counter({widths[i]: 1})
    for k, wk in enumerate(widths):
        below = after[k + 1].items()
        if dmf == "qr":
            yield "GEQRT", wk, wk, wk, 1
            for w, c in below:
                yield "UNMQR", wk, wk, w, c
                yield "TSQRT", wk, w, wk, c
            for wi, ci in below:
                for wj, cj in below:
                    yield "TSMQR", wk, wi, wj, ci * cj
        else:
            yield "POTRF", wk, wk, wk, 1
            for w, c in below:
                yield "TRSM", wk, w, wk, c
            for j in range(k + 1, nt):
                yield "SYRK", wk, widths[j], widths[j], 1
                for wi, ci in after[j + 1].items():
                    yield "GEMM", wk, wi, widths[j], ci


def _predict_tiled(dmf: str, n: int, dtype, schedule: BlockSpec,
                   peak: float, gemm_eff: float, machine: Machine) -> float:
    """Modeled seconds of the tile-DAG executor: the sum over its tasks.

    Prices each task of the program the executor runs
    (:data:`repro_torch.core.tiles.TILE_PROGRAMS`) over the square-n tile
    grid by its kind's entry plus the per-task overhead (and a panel
    task's columns at :data:`PANEL_COLUMN_S`).  The executor runs one task
    at a time, so the sum, not the DAG's critical path, is the wall-clock
    model (the critical path is what
    :func:`repro_torch.obs.report.tile_dag` measures).
    """
    from repro_torch.core.tiles import TILE_PROGRAMS

    if dmf not in TILE_PROGRAMS:
        raise KeyError(f"no tiled task program (or cost model) for {dmf!r}")
    itemsize = _itemsize(dtype)
    column_s = PANEL_COLUMN_S.get(dmf, 0.0)
    total = 0.0
    for kind, wk, wi, wj, count in _tile_groups(
            dmf, expand_schedule(n, schedule)):
        fl, byts, cls = TILE_TASK_COSTS[kind](wk, wi, wj, itemsize)
        if cls == "panel":
            task_t = fl / (peak * PANEL_EFF) + wk * column_s
        else:
            task_t = fl / (peak * gemm_eff)
        if byts:
            task_t = max(task_t, byts / machine.hbm_bytes_per_s)
        total += count * (task_t + TILE_TASK_OVERHEAD_S)
    return total


def step_costs(dmf: str, n: int, k: int, bk: int,
               dtype=torch.float32) -> Tuple[float, float, float]:
    """(panel_flops, update_flops, update_bytes) of the iteration at ``k``."""
    if dmf not in STEP_COSTS:
        raise KeyError(f"no cost model for DMF {dmf!r}")
    return STEP_COSTS[dmf](n, k, bk, _itemsize(dtype))


def predict(dmf: str, n: int, dtype, variant: str, schedule: BlockSpec,
            backend: str = "cuda", *,
            machine: Optional[Machine] = None) -> float:
    """Modeled seconds of one factorization under ``schedule``.

    Raises ValueError for a schedule the DMF refuses (band reduction's
    uniform bandwidth, checked by the drivers' own helper), so :func:`rank`
    sorts it last.
    """
    from repro_torch.core.lookahead import parse_variant

    machine = machine or MACHINE
    if dmf == "band_reduction":
        from repro_torch.core.band_reduction import check_uniform_tiling

        check_uniform_tiling(n, schedule)
    base, depth = parse_variant(variant)
    peak = machine.peak(dtype)
    gemm_eff = GEMM_EFF.get(backend, 0.5)
    if base == "tiled":
        return _predict_tiled(dmf, n, dtype, schedule, peak, gemm_eff,
                              machine)
    column_s = PANEL_COLUMN_S.get(dmf, 0.0)
    total = 0.0
    for st in panel_steps(n, schedule):
        pf_fl, tu_fl, tu_by = step_costs(dmf, n, st.k, st.bk, dtype)
        pf_t = pf_fl / (peak * PANEL_EFF) + st.bk * column_s
        tu_t = max(tu_fl / (peak * gemm_eff), tu_by / machine.hbm_bytes_per_s)
        if base in ("la", "la_mb", "tuned"):
            # look-ahead: PF(k+1) hides under TU_right(k); a depth-d window
            # hides up to d panels under one bulk update, with diminishing
            # returns (the narrow updates it adds are not free)
            step_t = max(pf_t / (0.5 * (1 + depth)), tu_t)
            if base == "la_mb":
                # the fused panel update saves the PU's separate pass
                step_t = max(0.8 * pf_t / (0.5 * (1 + depth)), tu_t)
        elif variant == "rtm":
            r = n - st.k_next
            ntasks = max(1, -(-r // st.bk)) ** 2
            step_t = pf_t + tu_t + ntasks * RTM_TASK_OVERHEAD_S
        else:                                        # mtb: PF, then TU
            step_t = pf_t + tu_t
        total += step_t + STEP_OVERHEAD_S
    return total


def rank(dmf: str, n: int, dtype, candidates: Sequence) -> list:
    """Candidates sorted by modeled time (ascending).

    Each candidate has ``.variant``, ``.schedule`` and ``.backend`` (see
    :class:`repro_torch.tune.sweep.Candidate`); one whose schedule
    :func:`predict` refuses sorts last.
    """
    def score(c):
        try:
            return predict(dmf, n, dtype, c.variant, c.schedule, c.backend)
        except (KeyError, ValueError):
            return float("inf")

    return sorted(candidates, key=score)
