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


def _ticks():
    """A fake clock: 0, 1, 2, ... one tick a read."""
    t = iter(range(1000))
    return lambda: float(next(t))


def test_span_clear_and_metrics_as_the_reference():
    """``span()`` (with and without a value to fence), ``clear()`` and the
    ``metrics=`` registry give the reference's spans and histograms on the
    same fake clock."""
    from repro.obs.metrics import Metrics as RefMetrics
    from repro_torch.obs.metrics import Metrics

    assert "serve" in tracer.CATEGORIES
    got = []
    for mod, reg in ((tracer, Metrics()), (ref_tracer, RefMetrics())):
        tr = mod.Tracer(clock=_ticks(), metrics=reg)
        with tr.span("serve", "flush:gesv[64x64x4]", batch=3, cached=False):
            pass
        with tr.span("serve", "flush:posv[32x32x1]+cache", fence_on=[1.0],
                     batch=1, cached=True):
            pass
        tr.wrap("drive", "gesv[64x64]", lambda: 2.0, driver="gesv")
        with pytest.raises(RuntimeError):
            with tr.span("serve", "failing"):
                raise RuntimeError("the span still closes")
        spans = [(s.cat, s.name, s.t0, s.t1, s.meta) for s in tr.spans]
        snap = reg.snapshot()
        assert tr.total("serve") == 3.0 and len(tr.by_cat("serve")) == 3
        tr.clear()
        assert tr.spans == [] and tr.total() == 0.0
        got.append((spans, snap))
    assert got[0] == got[1]
    assert got[0][1]["hist.span.serve.count"] == 3
    assert got[0][1]["hist.span.drive.count"] == 1


def test_serve_flush_span_lands_in_the_servers_registry():
    """The solve server's flush is one `serve` span, recorded in the
    server's own registry as ``span.serve`` when the tracer is built with
    ``metrics=server.metrics``; with no tracer installed no span is
    recorded."""
    import numpy as np

    from repro_torch.serve import ServerConfig, SolveServer

    srv = SolveServer(ServerConfig(max_batch=4, device="cpu"))
    rng = np.random.default_rng(0)
    for n in (20, 24):
        srv.submit("gesv", rng.standard_normal((n, n)) + n * np.eye(n),
                   rng.standard_normal((n, 1)))
    g = rng.standard_normal((16, 16))
    srv.submit("posv", g @ g.T + 16 * np.eye(16), np.ones((16, 1)),
               cache=True)
    with tracer.trace(tracer.Tracer(metrics=srv.metrics)) as tr:
        assert srv.drain() == 3
    flush, cached = tr.by_cat("serve")
    assert flush.name == "flush:gesv[32x32x1]"
    assert flush.meta == {"batch": 2, "cached": False}
    assert cached.name == "flush:posv[32x32x1]+cache"
    assert cached.meta == {"batch": 1, "cached": True}
    inner = [s for s in tr.by_cat("drive")
             if flush.t0 <= s.t0 and s.t1 <= flush.t1]
    assert len(inner) == 4               # gesv + lu_factor, twice
    assert len(tr.by_cat("drive")) == 5  # and the cached cholesky_factor
    snap = srv.snapshot()
    assert snap["hist.span.serve.count"] == 2.0
    assert snap["hist.span.serve.mean"] == pytest.approx(
        (flush.dur + cached.dur) / 2)
    srv.submit("gesv", np.eye(3), np.ones((3, 1)))
    srv.drain()
    assert srv.snapshot()["hist.span.serve.count"] == 2.0
