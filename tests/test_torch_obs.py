"""The port's trace reports and exports against the reference's, on the CPU.

The same synthetic spans (fixed clock values, every category and in-flight
depth the engine and the tile executor emit) go into ``repro.obs`` and
``repro_torch.obs``: ``overlap``, ``tile_dag``, ``attainment_row`` (the
port's model under the reference's constants, as in
``test_torch_tune.py``), ``format_attainment``, ``chrome_trace``,
``write_chrome_trace`` and ``render_timeline`` give the same results.
"""
import json

import pytest

from repro.obs import export as ref_export
from repro.obs import report as ref_report
from repro.obs import tracer as ref_tracer
from repro_torch.obs import export, report, tracer
from test_torch_tune import reference_constants

#: (cat, name, t0, t1, step, it, depth, meta): an la(2) run's engine spans
#: with its prologue, a swap and an epilogue, a driver span around them,
#: a tile run's TILE spans over three waves, and a mesh run's broadcasts
SPANS = [
    ("drive", "gesv[96x96]", 0.0, 10.0, -1, -1, 0, {"driver": "gesv"}),
    ("PF", "PF(0)", 0.0, 1.0, 0, -1, 1, {}),
    ("SWAP", "SWAP(0)", 1.0, 1.25, 0, 0, 0, {}),
    ("PU", "PU(0->1)", 1.25, 1.5, 0, 0, 1, {"cols": (32, 64)}),
    ("PF", "PF(1)", 1.5, 2.5, 1, 0, 1, {}),
    ("PU", "PU(0->2)", 2.5, 2.75, 0, 0, 2, {"cols": (64, 96)}),
    ("TU", "TU(0)", 2.75, 4.0, 0, 0, 0, {"cols": (96, 128), "inflight": 2}),
    ("EPI", "EPI(0)", 4.0, 4.1, 0, 0, 0, {}),
    ("SWAP", "SWAP(1)", 4.1, 4.3, 1, 1, 0, {}),
    ("PF", "PF(2)", 4.3, 5.8, 2, 1, 1, {}),
    ("TU", "TU(1)", 5.8, 6.2, 1, 1, 0, {}),
    ("PF", "PF(3)", 6.2, 6.9, 3, 3, 0, {}),
    ("BCAST", "BCAST(1)", 6.9, 7.0, 1, 1, 1, {"bytes": 4096, "shard": 1}),
    ("BCAST", "BCAST(2)", 7.0, 7.3, 2, 2, 0, {"bytes": 2048, "shard": 0}),
    ("TILE", "POTRF(0, 0, 0)", 7.3, 7.5, 0, 0, 0,
     {"kind": "POTRF", "dag_depth": 0}),
    ("TILE", "TRSM(0, 1, 0)", 7.5, 7.8, 0, 1, 0,
     {"kind": "TRSM", "dag_depth": 1}),
    ("TILE", "TRSM(0, 2, 0)", 7.8, 7.9, 0, 1, 0,
     {"kind": "TRSM", "dag_depth": 1}),
    ("TILE", "SYRK(0, 1, 1)", 7.9, 8.6, 0, 2, 0,
     {"kind": "SYRK", "dag_depth": 2}),
    ("TILE", "GEMM(0, 2, 1)", 8.6, 8.7, 0, 2, 0,
     {"kind": "GEMM", "dag_depth": 2, "traced": True}),
    ("sweep", "search", 8.7, 9.0, -1, -1, 0, {}),
    ("serve", "request", 9.0, 9.5, -1, -1, 0, {}),
]


def _spans(module):
    return [module.Span(cat, name, t0, t1, step=step, it=it, depth=depth,
                        meta=dict(meta))
            for cat, name, t0, t1, step, it, depth, meta in SPANS]


def test_categories_hold_the_references_engine_and_tile_lanes():
    assert set(tracer.CATEGORIES) <= set(ref_tracer.CATEGORIES)
    assert {"TILE", "sweep"} <= set(tracer.CATEGORIES)
    assert report.ENGINE_CATS == ref_report.ENGINE_CATS


@pytest.mark.parametrize("subset", ["all", "engine", "tile", "empty"])
def test_overlap_and_tile_dag_equal_the_reference(subset):
    keep = {"all": lambda s: True,
            "engine": lambda s: s.cat in report.ENGINE_CATS,
            "tile": lambda s: s.cat == "TILE",
            "empty": lambda s: False}[subset]
    mine = [s for s in _spans(tracer) if keep(s)]
    ref = [s for s in _spans(ref_tracer) if keep(s)]
    assert report.overlap(mine) == ref_report.overlap(ref)
    assert report.tile_dag(mine) == ref_report.tile_dag(ref)


@pytest.mark.parametrize("dmf,variant,schedule", [
    ("lu", "la2", 32), ("cholesky", "mtb", (32, 32, 16, 16)),
    ("qr", "tiled", 32), ("band_reduction", "la", (32, 16)),
    ("svd", "la", 32)])
def test_attainment_rows_equal_the_reference(monkeypatch, dmf, variant,
                                             schedule):
    reference_constants(monkeypatch)
    mine = report.attainment_row(dmf, 96, variant, schedule,
                                 _spans(tracer), dtype="float64",
                                 backend="cuda")
    ref = ref_report.attainment_row(dmf, 96, variant, schedule,
                                    _spans(ref_tracer), dtype="float64",
                                    backend="jnp")
    assert set(mine) == set(ref)
    for key, want in ref.items():
        got = mine[key]
        if isinstance(want, float) and isinstance(got, float):
            assert got == pytest.approx(want, rel=1e-12), key
        else:
            assert got == want, key
    assert report.format_attainment([mine]) == \
        ref_report.format_attainment([ref])


def test_chrome_trace_and_timeline_equal_the_reference(tmp_path):
    mine, ref = _spans(tracer), _spans(ref_tracer)
    assert export.chrome_trace(mine, label="x") == \
        ref_export.chrome_trace(ref, label="x")
    path = export.write_chrome_trace(str(tmp_path / "t.json"), mine)
    with open(path) as f:
        loaded = json.load(f)
    with open(ref_export.write_chrome_trace(str(tmp_path / "r.json"),
                                            ref)) as f:
        assert loaded == json.load(f)
    lanes = {e["args"]["name"] for e in loaded["traceEvents"]
             if e["name"] == "thread_name"}
    assert {"panel (PF)", "update (TU)", "drivers", "other"} <= lanes
    for width in (40, 72):
        assert export.render_timeline(mine, width=width) == \
            ref_export.render_timeline(ref, width=width)
    assert export.render_timeline([]) == ref_export.render_timeline([])
