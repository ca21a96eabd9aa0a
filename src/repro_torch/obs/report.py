"""Derived trace metrics: overlap efficiency, critical path, attainment.

The port of :mod:`repro.obs.report`, with the same keys and arithmetic.

**Overlap efficiency** — a PF span recorded with in-flight ``depth >= 1``
ran inside iteration *i*'s PU chain, which is data-independent of that
iteration's bulk update TU_i^R, so up to ``min(chain PF time, TU_i^R
time)`` of panel work can hide under the update.  ``overlap_efficiency``
is the hidden fraction of all panel time.  It is structural: the port runs
every op on one CUDA stream and the tracer fences each span, so the wall
clock shows no overlap; the metric reports how much panel time the
schedule made hideable (0 for mtb/rtm by construction).

**Critical path** — per iteration, the PU chain (depth ≥ 1 spans) and the
bulk update (depth-0 TU) are the two concurrent lanes; everything else is
serial.  ``critical_path_s`` sums ``serial + max(lane A, lane B)``;
``ideal_speedup`` is the serialized span total over that.
:func:`tile_dag` is the same accounting for a tile-DAG run, by wavefront.

**Attainment** — the analytical cost model (:mod:`repro_torch.tune.model`)
joined with the measured span times into one row per (dmf, variant, n):
``attainment`` = modeled seconds / measured seconds.  The reference also
joins a flop count parsed from XLA's HLO (``hlo_text``); the port has no
HLO, so its rows carry no ``hlo_*`` keys and :func:`format_attainment`
prints ``-`` in that column.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.obs.tracer import Span

__all__ = ["ENGINE_CATS", "overlap", "tile_dag", "attainment_row",
           "format_attainment"]

#: Categories emitted by the pipeline engine itself (the layer the
#: overlap / critical-path math is defined over; driver spans would
#: double-count the engine spans they enclose).  ``BCAST`` comes only from
#: the mesh engine (:mod:`repro_torch.core.distributed`): one span a panel
#: broadcast on each rank, ``meta["shard"]`` its owner and ``meta["bytes"]``
#: its payload, ``(nd − 1)·m·b·itemsize``.
ENGINE_CATS = ("PF", "TU", "PU", "SWAP", "EPI", "BCAST")


def _engine(spans: Sequence[Span]) -> List[Span]:
    return [s for s in spans if s.cat in ENGINE_CATS]


def overlap(spans: Sequence[Span]) -> Dict[str, float]:
    """Overlap-efficiency and critical-path accounting for one traced run.

    The ``bcast_*`` keys total ``BCAST`` spans (panel broadcasts of a mesh
    run, ``meta["bytes"]`` their payload); a single-device trace has none
    and they are 0.
    """
    eng = _engine(spans)
    panel_s = sum(s.dur for s in eng if s.cat == "PF")
    update_s = sum(s.dur for s in eng if s.cat in ("TU", "PU"))
    bcast_s = sum(s.dur for s in eng if s.cat == "BCAST")
    bcast_bytes = sum(float(s.meta.get("bytes", 0)) for s in eng
                      if s.cat == "BCAST")
    serialized_s = sum(s.dur for s in eng)

    iters = sorted({s.it for s in eng})
    hidden_s = 0.0
    bcast_hidden_s = 0.0
    critical_s = 0.0
    for i in iters:
        mine = [s for s in eng if s.it == i]
        # lane A: the PU chain (depth >= 1); lane B: the bulk update
        chain = sum(s.dur for s in mine if s.depth >= 1)
        bulk = sum(s.dur for s in mine if s.cat == "TU" and s.depth == 0)
        serial = sum(s.dur for s in mine) - chain - bulk
        chain_pf = sum(s.dur for s in mine if s.cat == "PF" and s.depth >= 1)
        chain_bc = sum(s.dur for s in mine
                       if s.cat == "BCAST" and s.depth >= 1)
        if i >= 0:
            hidden_s += min(chain_pf, bulk)
            bcast_hidden_s += min(chain_bc, bulk)
        critical_s += serial + max(chain, bulk)

    wall_s = (max((s.t1 for s in eng), default=0.0)
              - min((s.t0 for s in eng), default=0.0))
    return {
        "overlap_efficiency": hidden_s / panel_s if panel_s > 0 else 0.0,
        "panel_s": panel_s,
        "update_s": update_s,
        "hidden_s": hidden_s,
        "bcast_s": bcast_s,
        "bcast_bytes": bcast_bytes,
        "bcast_hidden_s": bcast_hidden_s,
        "bcast_hidden_frac": bcast_hidden_s / bcast_s if bcast_s > 0 else 0.0,
        "serialized_s": serialized_s,
        "critical_path_s": critical_s,
        "ideal_speedup": serialized_s / critical_s if critical_s > 0 else 1.0,
        "wall_s": wall_s,
        "n_spans": float(len(eng)),
        "n_iters": float(len([i for i in iters if i >= 0])),
        "max_inflight": float(max((s.depth for s in eng), default=0)),
    }


def tile_dag(spans: Sequence[Span]) -> Dict[str, float]:
    """Critical-path accounting for a tile-DAG run.

    :func:`repro_torch.core.tiles.run_dag` tags every task span with its
    wavefront (``meta["dag_depth"]``).  Tasks of one wavefront are
    independent, so a perfectly parallel executor would run each wave in
    its longest task: ``critical_path_s = Σ_w max(dur)``, and
    ``ideal_speedup`` is the serialized total over that.  Spans tagged
    ``traced=True`` are dropped, as in the reference.
    """
    tile = [s for s in spans
            if s.cat == "TILE" and not s.meta.get("traced")]
    serialized_s = sum(s.dur for s in tile)
    waves: Dict[int, List[Span]] = {}
    for s in tile:
        waves.setdefault(int(s.meta.get("dag_depth", 0)), []).append(s)
    critical_s = sum(max(s.dur for s in w) for w in waves.values())
    kinds: Dict[str, float] = {}
    for s in tile:
        k = s.meta.get("kind", "?")
        kinds[k] = kinds.get(k, 0.0) + s.dur
    wall_s = (max((s.t1 for s in tile), default=0.0)
              - min((s.t0 for s in tile), default=0.0))
    return {
        "serialized_s": serialized_s,
        "critical_path_s": critical_s,
        "ideal_speedup": serialized_s / critical_s if critical_s > 0 else 1.0,
        "wall_s": wall_s,
        "n_tasks": float(len(tile)),
        "n_waves": float(len(waves)),
        "max_wave_width": float(max((len(w) for w in waves.values()),
                                    default=0)),
        "kind_s": kinds,
    }


def attainment_row(dmf: str, n: int, variant: str, schedule,
                   spans: Sequence[Span], *, dtype="float32",
                   backend: str = "cuda") -> Dict[str, object]:
    """One model-vs-measured row: the engine spans' seconds beside
    :func:`repro_torch.tune.model.predict` for the same (dmf, n, dtype,
    variant, schedule, backend); ``schedule`` is a block size or a
    per-iteration schedule."""
    from repro_torch.core.blocking import expand_schedule, panel_steps
    from repro_torch.tune import model

    eng = _engine(spans)
    measured_s = sum(s.dur for s in eng)
    sched = expand_schedule(n, schedule)
    row: Dict[str, object] = {
        "dmf": dmf, "n": int(n), "variant": variant, "b": int(sched[0]),
        "measured_s": measured_s,
        "panel_s": sum(s.dur for s in eng if s.cat == "PF"),
        "update_s": sum(s.dur for s in eng if s.cat in ("TU", "PU")),
    }
    try:
        model_s = model.predict(dmf, n, dtype, variant, sched, backend)
        flops = 0.0
        for st in panel_steps(n, sched):
            pf, tu, _ = model.step_costs(dmf, n, st.k, st.bk, dtype)
            flops += pf + tu
    except (KeyError, ValueError):
        model_s, flops = None, None
    row["model_s"] = model_s
    row["model_flops"] = flops
    row["attainment"] = (model_s / measured_s
                         if model_s is not None and measured_s > 0 else None)
    row["gflops"] = (flops / measured_s / 1e9
                     if flops is not None and measured_s > 0 else None)
    return row


def format_attainment(rows: Sequence[Dict[str, object]]) -> str:
    """ASCII attainment table (one line per row; ``-`` for absent joins)."""
    def num(v, scale=1.0, fmt="{:.2f}"):
        return fmt.format(v * scale) if isinstance(v, (int, float)) else "-"

    hdr = (f"{'dmf':<12} {'variant':<6} {'n':>5} {'b':>4} "
           f"{'model_ms':>9} {'meas_ms':>9} {'attain':>7} "
           f"{'GFLOPS':>7} {'hloGF':>7}  warnings")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        warn = r.get("hlo_warnings") or []
        lines.append(
            f"{r['dmf']:<12} {r['variant']:<6} {r['n']:>5} {r['b']:>4} "
            f"{num(r.get('model_s'), 1e3):>9} "
            f"{num(r.get('measured_s'), 1e3):>9} "
            f"{num(r.get('attainment')):>7} "
            f"{num(r.get('gflops')):>7} "
            f"{num(r.get('hlo_gflops')):>7}  "
            f"{'; '.join(warn) if warn else '-'}")
    return "\n".join(lines)
