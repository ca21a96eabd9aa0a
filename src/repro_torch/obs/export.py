"""Trace export: Chrome/Perfetto JSON and a terminal timeline.

The port of :mod:`repro.obs.export`, with the same lanes and glyphs.  The
JSON is the Trace Event Format (``chrome://tracing``'s JSON, which
Perfetto's UI loads): complete events (``"ph": "X"``) with microsecond
``ts``/``dur``, one thread track per span category group, so panel
factorizations land on one track and trailing updates on another.
In-flight depth, panel index and iteration ride in ``args``.
:func:`render_timeline` draws the same tracks in ASCII.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

from repro_torch.obs.tracer import Span

__all__ = ["chrome_trace", "write_chrome_trace", "render_timeline"]

#: Span category -> (tid, track name).  Track 1 is the panel lane, track 0
#: the update lane; the outer layers get their own tracks.  ``TILE`` spans
#: fall on the default lane, as in the reference.
_LANES: Dict[str, tuple] = {
    "PF": (1, "panel (PF)"),
    "panel": (1, "panel (PF)"),
    "TU": (0, "update (TU)"),
    "PU": (0, "update (TU)"),
    "SWAP": (0, "update (TU)"),
    "EPI": (0, "update (TU)"),
    "BCAST": (5, "collective (BCAST)"),
    "drive": (2, "drivers"),
    "sweep": (2, "drivers"),
    "serve": (3, "serve"),
}
_DEFAULT_LANE = (4, "other")

#: A span tagged ``meta["shard"]`` (a mesh run) gets its device's block of
#: thread ids: shard *s*'s copy of track ``t`` is tid ``(s + 1)·stride + t``.
_SHARD_STRIDE = 8

PID = 1


def _lane(span: Span) -> tuple:
    tid, track = _LANES.get(span.cat, _DEFAULT_LANE)
    shard = span.meta.get("shard")
    if shard is not None:
        tid += _SHARD_STRIDE * (int(shard) + 1)
        track = f"{track} @dev{int(shard)}"
    return tid, track


def chrome_trace(spans: Sequence[Span], *, label: str = "repro") -> dict:
    """Trace Event Format dict for ``spans`` (``json.dump``-ready)."""
    t_origin = min((s.t0 for s in spans), default=0.0)
    events: List[dict] = [{
        "ph": "M", "pid": PID, "tid": 0, "name": "process_name",
        "args": {"name": label},
    }]
    seen_tids = set()
    for s in spans:
        tid, track = _lane(s)
        if tid not in seen_tids:
            seen_tids.add(tid)
            events.append({"ph": "M", "pid": PID, "tid": tid,
                           "name": "thread_name", "args": {"name": track}})
    for s in spans:
        tid, _ = _lane(s)
        args = {"step": s.step, "iter": s.it, "depth": s.depth}
        args.update(s.meta)
        events.append({
            "ph": "X", "pid": PID, "tid": tid,
            "name": s.name, "cat": s.cat,
            "ts": (s.t0 - t_origin) * 1e6,
            "dur": s.dur * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Sequence[Span], *,
                       label: str = "repro") -> str:
    """Write ``spans`` as a Chrome/Perfetto JSON file; returns ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, label=label), f)
    return path


_GLYPH = {"PF": "P", "panel": "p", "TU": "U", "PU": "u", "SWAP": "s",
          "EPI": "e", "BCAST": "B", "drive": "d", "sweep": "w", "serve": "S"}


def render_timeline(spans: Iterable[Span], *, width: int = 72) -> str:
    """ASCII timeline: one row per track, a glyph per span category.

    Later spans overwrite earlier glyphs in a cell; a cell covered by any
    part of a span gets its glyph, so spans shorter than a cell still show.
    """
    spans = list(spans)
    if not spans:
        return "(no spans)"
    t0 = min(s.t0 for s in spans)
    t1 = max(s.t1 for s in spans)
    total = max(t1 - t0, 1e-12)
    rows: Dict[int, list] = {}
    names: Dict[int, str] = {}
    for s in sorted(spans, key=lambda s: s.t0):
        tid, track = _lane(s)
        names[tid] = track
        row = rows.setdefault(tid, [" "] * width)
        c0 = int((s.t0 - t0) / total * width)
        c1 = int((s.t1 - t0) / total * width)
        for c in range(max(c0, 0), min(max(c1, c0 + 1), width)):
            row[c] = _GLYPH.get(s.cat, "?")
    label_w = max(len(n) for n in names.values())
    lines = [f"{names[tid]:>{label_w}} |{''.join(rows[tid])}|"
             for tid in sorted(rows)]
    lines.append(f"{'':>{label_w}}  {total * 1e3:.2f} ms total "
                 f"({len(spans)} spans)")
    return "\n".join(lines)
