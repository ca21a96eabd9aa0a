"""The port's tuner (``repro_torch.tune``) against the reference's, on the CPU.

* ``tail_schedule`` / ``is_uniform`` and the variant registry's
  ``list_variants`` / ``TUNABLE`` are the reference's;
* a ``TuneConfig`` written by either package is read by the other, and
  the key names the backend and the device type of the measurement;
* with the reference's constants (read at run time from
  ``repro.tune.model`` and ``repro.launch.roofline``, never copied into
  the port), ``predict`` and ``rank`` give the reference's numbers to
  1e-12 relative for every DMF × variant × schedule;
* ``_candidates`` are the reference's, apart from float64 ``la_mb`` (the
  port keeps it) and the kernel-blocking axis (the port has none);
* a CPU ``search`` measures its baseline, never returns a slower winner,
  and answers the second call from the cache; ``variant="tuned"`` runs
  the winner bitwise, falls back to ``la`` when cold and refuses band
  reduction, a ``kernel_blocks`` entry and ``mesh=``; an entry measured
  on the CPU never serves a lookup on the GPU.
"""
import json
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import lookahead as ref_lookahead
from repro.launch import roofline as ref_roofline
from repro.tune import cache as ref_cache
from repro.tune import model as ref_model
from repro.tune import schedule as ref_schedule
from repro.tune import sweep as ref_sweep
from repro_torch import tune
from repro_torch.core import lookahead
from repro_torch.solve import (TiledQRFactors, cholesky_factor, gesv,
                               lu_factor, posv, qr_factor)
from repro_torch.tune import model, sweep


def reference_constants(monkeypatch):
    """Put the reference's machine and efficiencies into the port's model:
    its bf16 peak scaled by element width, its HBM rate, its jnp backend's
    GEMM efficiency as the port's ``"cuda"``, and no time per panel
    column."""
    peak = ref_roofline.PEAK_FLOPS
    monkeypatch.setattr(model, "MACHINE", model.Machine(
        name="reference", peak_flops={
            "float64": peak * 2.0 / 8, "float32": peak * 2.0 / 4,
            "bfloat16": peak, "float16": peak},
        hbm_bytes_per_s=ref_roofline.HBM_BW))
    monkeypatch.setattr(model, "GEMM_EFF", {"cuda": ref_model.GEMM_EFF["jnp"]})
    # the port's own fixed time per panel column: the reference has none
    monkeypatch.setattr(model, "PANEL_COLUMN_S", {})
    for name in ("PANEL_EFF", "STEP_OVERHEAD_S", "RTM_TASK_OVERHEAD_S",
                 "TILE_TASK_OVERHEAD_S"):
        monkeypatch.setattr(model, name, getattr(ref_model, name))


@pytest.fixture
def tmp_cache(tmp_path):
    """A fresh default cache in ``tmp_path``; the old one is restored."""
    c = tune.TuneCache(tmp_path / "tune.json")
    old = tune.set_default_cache(c)
    yield c
    tune.set_default_cache(old)


def _rand(n, seed=0, spd=False):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a @ a.T + n * np.eye(n) if spd else a


# ---------------------------------------------------------------------------
# Schedules, the registry, the cache schema and the key.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,b,kw", [(1024, 128, {}), (100, 32, {}),
                                    (64, 16, {}), (7, 16, {}),
                                    (1000, 96, {"min_b": 8, "shrink": 3})])
def test_schedules_equal_the_reference(n, b, kw):
    mine = tune.tail_schedule(n, b, **kw)
    assert mine == ref_schedule.tail_schedule(n, b, **kw)
    assert sum(mine) == n
    for s in (mine, tune.uniform_schedule(n, b), (b, b, 3), (b, 3, b)):
        assert tune.is_uniform(s) == ref_schedule.is_uniform(s)
    assert tune.uniform_schedule(n, b) == ref_schedule.uniform_schedule(n, b)
    with pytest.raises(ValueError):
        tune.tail_schedule(n, b, shrink=1)


def test_registry_equals_the_reference():
    assert lookahead.FACTORIZATIONS == ref_lookahead.FACTORIZATIONS
    for dmf in lookahead.FACTORIZATIONS:
        assert lookahead.list_variants(dmf) == \
            ref_lookahead.list_variants(dmf), dmf
    assert lookahead.TUNABLE == ref_lookahead.TUNABLE
    assert lookahead.VARIANTS == ref_lookahead.VARIANTS
    assert lookahead.DERIVED_VARIANTS == ref_lookahead.DERIVED_VARIANTS


def test_tune_config_json_is_read_by_both_packages(tmp_path):
    mine = tune.TuneConfig(
        dmf="qr", shape=(64, 64), dtype="float64", backend="cuda@cpu",
        variant="tiled", schedule=(16, 16, 16, 16), seconds=0.5,
        baseline_seconds=0.75, tile=16)
    theirs = ref_cache.TuneConfig.from_json(mine.to_json())
    assert theirs.to_json() == mine.to_json()
    assert "kernel_blocks" not in mine.to_json()
    ref = ref_cache.TuneConfig(
        dmf="lu", shape=(96, 96), dtype="float32", backend="pallas",
        variant="la2", schedule=(32, 32, 32), seconds=1.0,
        baseline_seconds=2.0, depth=2, kernel_blocks=(32, 128, 128),
        mesh_shape=(4,))
    back = tune.TuneConfig.from_json(ref.to_json())
    assert back.to_json() == ref.to_json()
    assert (back.depth, back.kernel_blocks, back.mesh_shape) == \
        (2, (32, 128, 128), (4,))
    # through the files: each package's cache reads the other's entry
    key = tune.cache_key("qr", 64, torch.float64, "cuda@cpu")
    tune.TuneCache(tmp_path / "port.json").put(key, mine)
    got = ref_cache.TuneCache(tmp_path / "port.json").get(key)
    assert got.to_json() == mine.to_json() and got.from_cache
    ref_cache.TuneCache(tmp_path / "ref.json").put("k", ref)
    assert tune.TuneCache(tmp_path / "ref.json").get("k").to_json() == \
        ref.to_json()
    with pytest.raises(ValueError, match="concrete variant"):
        tune.TuneConfig(dmf="lu", shape=(4, 4), dtype="float64",
                        backend="cuda@cpu", variant="tuned", schedule=(4,),
                        seconds=1.0, baseline_seconds=1.0)


def test_key_format_names_backend_and_device():
    assert tune.measured_on("cuda", "cpu") == "cuda@cpu"
    assert tune.measured_on("torch", torch.device("cuda", 0)) == "torch@cuda"
    for dtype in (torch.float64, np.float64, "float64"):
        assert tune.cache_key("lu", 64, dtype, "cuda@cpu") == \
            "cuda@cpu:lu:64x64:float64"
    assert tune.cache_key("qr", (96, 32), torch.float32, "cuda@cuda",
                          digest="ab12") == "cuda@cuda:qr:96x32:float32:ab12"
    # the reference's format, with the measured-on field in its backend
    assert tune.cache_key("lu", (8, 8), "float32", "jnp") == \
        ref_cache.cache_key("lu", (8, 8), "float32", "jnp")


# ---------------------------------------------------------------------------
# The cost model under the reference's constants.
# ---------------------------------------------------------------------------
def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("dmf", ref_model.STEP_COSTS)
def test_predict_and_rank_equal_the_reference(monkeypatch, dmf):
    reference_constants(monkeypatch)
    n = 192
    variants = ref_lookahead.VARIANTS + ("la2", "la3", "la_mb2", "tuned")
    for dtype in ("float32", "float64"):
        for b in (32, 48, 64):
            for sched in (tune.uniform_schedule(n, b),
                          tune.tail_schedule(n, b)):
                for variant in variants:
                    try:
                        want = ref_model.predict(dmf, n, dtype, variant,
                                                 sched, "jnp")
                    except (KeyError, ValueError) as e:
                        with pytest.raises(type(e)):
                            model.predict(dmf, n, dtype, variant, sched,
                                          "cuda")
                        continue
                    got = model.predict(dmf, n, dtype, variant, sched,
                                        "cuda")
                    assert _close(got, want), (dtype, b, sched, variant)
        for st in range(0, n, 48):
            assert model.step_costs(dmf, n, st, 48, dtype) == \
                ref_model.step_costs(dmf, n, st, 48, dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref_cands = ref_sweep._candidates(dmf, n, dtype, (32, 48, 64),
                                              None, ("jnp",))
        mine = [tune.Candidate(c.variant, c.schedule, "cuda", c.tile)
                for c in ref_cands]
        assert [(c.variant, c.schedule) for c in
                model.rank(dmf, n, dtype, mine)] == \
            [(c.variant, c.schedule) for c in
             ref_model.rank(dmf, n, dtype, ref_cands)]


@pytest.mark.parametrize("dmf,n,b", [
    ("qr", 100, 32), ("qr", 64, 16), ("qr", 100, (48, 16, 16, 8)),
    ("cholesky", 100, 32), ("cholesky", 7, 16),
    ("cholesky", 90, (40, 24, 8)), ("qr", 40, tune.tail_schedule(40, 16))])
def test_tile_groups_count_the_executors_tasks(dmf, n, b):
    """The model prices the tile program by (kind, widths) groups instead of
    building its tasks: the groups count exactly the tasks
    ``core.tiles`` runs, by kind and by the widths of tiles k, i and j."""
    from repro_torch.core import tiles

    widths = tuple(w for _, w in tiles.tile_grid(n, b))
    nt = len(widths)
    tasks = tiles.TILE_PROGRAMS[dmf][0](*((nt, nt) if dmf == "qr" else
                                          (nt,)))
    want = Counter((t.kind, widths[t.key[0]], widths[t.key[1]],
                    widths[t.key[2]]) for t in tasks)
    got = Counter()
    for kind, wk, wi, wj, count in model._tile_groups(dmf, widths):
        got[(kind, wk, wi, wj)] += count
    assert got == want


def test_machine_is_the_h100s():
    m = model.MACHINE
    assert "H100" in m.name and m.power_limit_w == 700.0
    assert m.peak(torch.float64) == m.peak("float32") == 67e12
    assert m.peak(torch.bfloat16) == 989e12
    assert (m.hbm_bytes_per_s, m.sms, m.l2_bytes) == (3.35e12, 132, 50e6)
    assert m.smem_per_sm_bytes == 228 * 1024
    assert m.peak_flops != ref_model.MACHINE.peak_flops
    assert set(model.GEMM_EFF) == {"cuda", "torch"}


@pytest.mark.parametrize("dmf", lookahead.TUNABLE)
def test_candidates_equal_the_reference_but_f64_la_mb(monkeypatch, dmf):
    reference_constants(monkeypatch)
    for dtype in ("float32", "float64"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = ref_sweep._candidates(dmf, 64, dtype, (16, 32, 48), None,
                                        ("jnp",))
        mine = sweep._candidates(dmf, 64, dtype, (16, 32, 48), None,
                                 ("cuda",))
        assert all(c.kernel_blocks is None for c in ref)
        kept = [c for c in mine if not (dtype == "float64"
                                        and c.variant.startswith("la_mb"))]
        if dtype == "float64" and dmf in ("lu", "cholesky"):
            assert len(kept) < len(mine)       # the fused PUs are float64
        else:
            assert kept == mine
        assert Counter((c.variant, c.schedule, c.tile) for c in kept) == \
            Counter((c.variant, c.schedule, c.tile) for c in ref)


# ---------------------------------------------------------------------------
# search and "tuned" on the CPU.
# ---------------------------------------------------------------------------
def test_search_measures_the_baseline_and_caches(tmp_cache, monkeypatch):
    sink = []
    cfg = tune.search("lu", 64, torch.float64, blocks=(16, 32),
                      device="cpu", trace_sink=sink)
    assert not cfg.from_cache
    assert cfg.backend == "cuda@cpu" and cfg.shape == (64, 64)
    assert cfg.seconds <= cfg.baseline_seconds
    labels = {t.candidate.label() for t in sink}
    assert "la/b64/uniform/cuda" in labels          # the b = min(128, n) la
    assert all(t.predicted_s is not None and t.spans for t in sink)
    assert cfg.variant in {t.candidate.variant for t in sink}
    assert sum(cfg.schedule) == 64 and cfg.kernel_blocks is None

    def no_measure(*args, **kw):
        raise AssertionError("a cached search measured again")

    monkeypatch.setattr(sweep, "_measure", no_measure)
    again = tune.search("lu", 64, torch.float64, blocks=(16, 32),
                        device="cpu")
    assert again.from_cache
    assert again.to_json() == cfg.to_json()


def test_tuned_runs_the_winner_bitwise(tmp_cache):
    a, s = _rand(64), _rand(64, spd=True)
    for dmf, x in (("lu", a), ("cholesky", s)):
        cfg = tune.search(dmf, 64, torch.float64, blocks=(16, 32),
                          device="cpu")
        want = lookahead.get_variant(dmf, cfg.variant)(x, cfg.schedule,
                                                       device="cpu")
        got = lookahead.get_variant(dmf, "tuned")(x, device="cpu")
        assert all(torch.equal(g, w) for g, w in zip(
            got if dmf == "lu" else (got,), want if dmf == "lu" else (want,)))
    # through the drivers: the winner's factor, solved at the caller's
    # block (the default 128), as the reference's drivers do
    rhs = _rand(64, 1)[:, :3]
    cfg = tune.tuned("lu", 64, dtype=torch.float64, backend="cuda",
                     device="cpu")
    fac = lu_factor(a, variant="tuned", device="cpu")
    want = lu_factor(a, cfg.schedule, variant=cfg.variant, device="cpu")
    assert torch.equal(fac.lu, want.lu) and torch.equal(fac.ipiv, want.ipiv)
    assert fac.block == 128
    assert torch.equal(gesv(a, rhs, variant="tuned", device="cpu"),
                       fac.solve(rhs))
    cfg = tune.tuned("cholesky", 64, dtype=torch.float64, device="cpu")
    fac = cholesky_factor(s, variant="tuned", device="cpu")
    assert torch.equal(fac.l, cholesky_factor(
        s, cfg.schedule, variant=cfg.variant, device="cpu").l)
    assert torch.equal(posv(s, rhs, variant="tuned", device="cpu"),
                       fac.solve(rhs))


def test_tuned_cold_falls_back_to_la_and_refuses(tmp_cache):
    a = _rand(40)
    for b in (16, None):
        got = lookahead.get_variant("lu", "tuned")(a, b, device="cpu")
        want = lookahead.get_variant("lu", "la")(a, b or 128, device="cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = lookahead.get_variant("qrcp", "tuned")(a, 16, device="cpu")
    want = lookahead.get_variant("qrcp", "mtb")(a, 16, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(KeyError, match="defines the output"):
        lookahead.get_variant("band_reduction", "tuned")
    with pytest.raises(ValueError, match="not tunable"):
        tune.search("band_reduction", 64, device="cpu")
    with pytest.raises(TypeError, match="expects a torch.distributed"):
        tune.search("lu", 64, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="already carries|no look-ahead"):
        lookahead.deepen("tuned", 2)
    key = tune.cache_key("lu", 40, torch.float64, "cuda@cpu")
    tmp_cache.put(key, tune.TuneConfig(
        dmf="lu", shape=(40, 40), dtype="float64", backend="cuda@cpu",
        variant="la", schedule=(16, 16, 8), seconds=1.0,
        baseline_seconds=1.0, kernel_blocks=(32, 128, 128)))
    with pytest.raises(ValueError, match="kernel-blocking"):
        lookahead.get_variant("lu", "tuned")(a, device="cpu")


def test_tiled_winner_returns_tiled_factors(tmp_cache):
    a = _rand(48)
    tmp_cache.put(tune.cache_key("qr", 48, torch.float64, "cuda@cpu"),
                  tune.TuneConfig(dmf="qr", shape=(48, 48), dtype="float64",
                                  backend="cuda@cpu", variant="tiled",
                                  schedule=(16,), seconds=1.0,
                                  baseline_seconds=1.0, tile=16))
    fac = qr_factor(a, variant="tuned", device="cpu")
    assert isinstance(fac, TiledQRFactors)
    assert torch.equal(fac.tqr.r, qr_factor(a, 16, variant="tiled",
                                            device="cpu").tqr.r)


def test_a_cpu_measurement_never_serves_the_gpu(tmp_cache):
    cfg = tune.search("cholesky", 48, torch.float64, blocks=(16,),
                      device="cpu")
    assert tune.tuned("cholesky", 48, dtype=torch.float64, backend="cuda",
                      device="cpu").to_json() == cfg.to_json()
    assert tune.tuned("cholesky", 48, dtype=torch.float64, backend="cuda",
                      device="cuda") is None
    assert tune.tuned("cholesky", 48, dtype=torch.float64, backend="torch",
                      device="cpu") is None
    # and a GPU entry is not served to a CPU call, which runs la cold
    s = _rand(48, spd=True)
    tmp_cache.put(tune.cache_key("cholesky", 48, torch.float64, "cuda@cuda"),
                  tune.TuneConfig(dmf="cholesky", shape=(48, 48),
                                  dtype="float64", backend="cuda@cuda",
                                  variant="mtb", schedule=(8,), seconds=1.0,
                                  baseline_seconds=1.0))
    tmp_cache.clear()
    assert torch.equal(
        lookahead.get_variant("cholesky", "tuned")(s, 16, device="cpu"),
        lookahead.get_variant("cholesky", "la")(s, 16, device="cpu"))
    disk = json.loads(tmp_cache.path.read_text()) \
        if tmp_cache.path.exists() else {}
    assert all(k.startswith("cuda@") for k in disk)
