"""The port's mesh engine (``repro_torch.core.distributed``) on the CPU.

* The 1-D and 2-D ragged block-cyclic layout helpers are bitwise the
  reference's on the same NumPy input.
* The plain GEMM and TRSM are bitwise column-decomposable, the property
  the per-rank updates rest on.
* ``Rules``' ``"panels"`` entry picks the cycle's mesh dimension.
* One spawned 4-rank gloo world (``repro_torch.launch.mesh.spawn``) runs
  LU, Cholesky and QR × ``mtb``/``la``/``la2`` × f32/f64 × n 64 and a
  ragged n at b 16, on a ``(4,)`` mesh (nd 4) and a ``(2, 2)`` mesh with
  ``Layout(axis="model")`` (nd 2).  Every result is bitwise the port's
  single-device engine at the same schedule, pivots included, on every
  rank; rank 0's is held within 200·max(m,n,8)·eps of the reference's
  single-device factorization (JAX on the CPU), pivots equal in f64.  The
  same world runs ``gesv``/``posv``/``gels(mesh=)``, the batched and
  server mesh paths (``pump`` on ranks whose clocks disagree),
  ``tune.search(mesh=)``, one traced ``la2`` and every refusal of the
  mesh path.

The reference's own mesh engine does not run on this JAX (its
``tests/test_distributed.py`` cases fail), so the port's mesh path is held
to the reference's contract instead: bitwise the single-device engine.
JAX is imported inside the tests only: the world's ranks import this
module to find their job, and need only torch.
"""
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.core import pipeline
from repro_torch.core.lookahead import get_variant
from repro_torch.kernels import blis_gemm, trsm
from repro_torch.launch import mesh as M
from repro_torch.parallel import sharding

B = 16
NS = (64, 72)                 # exact, and ragged: n % b and n % (nd·b) != 0
DMFS = ("lu", "cholesky", "qr")
VARIANTS = ("mtb", "la", "la2")
DTYPES = ("float32", "float64")
CPU = dict(device="cpu")


def _input(dmf, n, dtype, seed):
    rng = np.random.default_rng(seed)
    if dmf == "qr":
        return rng.standard_normal((n + B, n)).astype(dtype)
    a = rng.standard_normal((n, n)).astype(dtype)
    if dmf == "cholesky":
        a = (a @ a.T + n * np.eye(n)).astype(dtype)
    return a


def _seed(dmf, n, dtype):
    return 100 * DMFS.index(dmf) + n + (7 if dtype == "float64" else 0)


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def _equal(x, y) -> bool:
    lx, ly = _leaves(x), _leaves(y)
    return len(lx) == len(ly) and all(
        p.dtype == q.dtype and torch.equal(p, q) for p, q in zip(lx, ly))


def _digest(x) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in _leaves(x):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# The world's job: every rank runs it; rank 0 also runs the single-device
# engine and compares.
# ---------------------------------------------------------------------------
def _raises(fn, exc, match) -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def _world_job(rank):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch import tune
    from repro_torch.core import cholesky, ldlt, lu, qr
    from repro_torch.obs import export, report, tracer
    from repro_torch.serve import ServerConfig, SolveServer
    from repro_torch.solve import batched, drivers

    out = {"bitwise": {}, "digest": {}, "mesh_results": {}}
    meshes = {
        "d4": (init_device_mesh("cpu", (4,), mesh_dim_names=("model",)),
               None),
        "d2": (M.make_local_mesh(model=2, data=2, device_type="cpu"),
               D.Layout(axis="model")),
    }
    for mname, (mesh, layout) in meshes.items():
        for dmf in DMFS:
            for dtype in DTYPES:
                for n in NS:
                    a = _input(dmf, n, dtype, _seed(dmf, n, dtype))
                    for variant in VARIANTS:
                        fn = get_variant(dmf, variant)
                        got = fn(a, B, mesh=mesh, layout=layout, **CPU)
                        key = f"{mname}:{dmf}:{dtype}:{n}:{variant}"
                        out["digest"][key] = _digest(got)
                        if rank == 0:
                            out["bitwise"][key] = _equal(got, fn(a, B, **CPU))
                            if mname == "d4" and variant == "mtb":
                                out["mesh_results"][key] = [
                                    t.numpy() for t in _leaves(got)]

    mesh = meshes["d4"][0]
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 64))
    rhs = rng.standard_normal((64, 3))
    spd = a @ a.T + 64 * np.eye(64)
    tall = rng.standard_normal((80, 48))
    trhs = rng.standard_normal((80, 2))
    drv = {
        "gesv": (drivers.gesv(a, rhs, B, mesh=mesh, **CPU),
                 drivers.gesv(a, rhs, B, **CPU)),
        "posv": (drivers.posv(spd, rhs, B, variant="la2", mesh=mesh, **CPU),
                 drivers.posv(spd, rhs, B, variant="la2", **CPU)),
        "gels": (drivers.gels(tall, trhs, B, variant="mtb", mesh=mesh, **CPU),
                 drivers.gels(tall, trhs, B, variant="mtb", **CPU)),
    }
    out["drivers"] = {k: _equal(*v) for k, v in drv.items()}

    # batched: every system over the mesh in turn
    a3 = rng.standard_normal((3, 48, 48))
    b3 = rng.standard_normal((3, 48, 2))
    s3 = np.einsum("bij,bkj->bik", a3, a3) + 48 * np.eye(48)
    out["batched"] = {
        "gesv": _equal(batched.gesv_batched(a3, b3, B, mesh=mesh, **CPU),
                       batched.gesv_batched(a3, b3, B, **CPU)),
        "posv": _equal(batched.posv_batched(s3, b3, B, mesh=mesh, **CPU),
                       batched.posv_batched(s3, b3, B, **CPU)),
        "lu_factor": _equal(
            batched.lu_factor_batched(a3, B, mesh=mesh, **CPU).lu,
            batched.lu_factor_batched(a3, B, **CPU).lu),
    }

    # the server: each rank submits the same requests; responses bitwise
    # the unbatched driver on the raw shape
    srv = SolveServer(ServerConfig(block=32, device="cpu", mesh=mesh))
    reqs = []
    for i, (dmf, n) in enumerate((("gesv", 40), ("gesv", 56),
                                  ("posv", 40), ("gels", 50))):
        g = np.random.default_rng(40 + i).standard_normal((n, n))
        if dmf == "posv":
            g = g @ g.T + n * np.eye(n)
        m = n + 10 if dmf == "gels" else n
        g = g if dmf != "gels" else \
            np.random.default_rng(40 + i).standard_normal((m, n))
        bb = np.random.default_rng(50 + i).standard_normal((m, 2))
        reqs.append((dmf, g, bb, srv.submit(dmf, g, bb)))
    srv.drain()
    out["server"] = [
        _equal(srv.take(rid).x,
               getattr(drivers, dmf)(g, bb, 32, **CPU)) for dmf, g, bb, rid
        in reqs]

    # pump() on clocks that disagree: first only rank 0 finds the gesv
    # bucket due, then only the others do; every rank flushes rank 0's
    # choice (a rank flushing alone would wait in the mesh's collectives)
    now = [0.0]
    srv = SolveServer(ServerConfig(block=32, max_wait_s=1.0, device="cpu",
                                   mesh=mesh), clock=lambda: now[0])
    _, g, bb, _ = reqs[0]
    first = srv.submit("gesv", g, bb)
    now[0] = 2.0 if rank == 0 else 0.5
    produced = [srv.pump()]
    x = srv.take(first).x
    srv.submit("gesv", g, bb)
    now[0] += 0.5 if rank == 0 else 2.0
    produced += [srv.pump(), srv.pending(), srv.drain()]
    out["pump"] = {"produced": produced,
                   "bitwise": _equal(x, drivers.gesv(g, bb, 32, **CPU))}
    # an object from the mesh's first rank, coordinate (0, 0), on a mesh
    # whose ranks run backwards
    rev = DeviceMesh("cpu", torch.arange(3, -1, -1).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    out["broadcast_object"] = D.broadcast_object(rev, rank)

    # the tuner's device-layout axis
    tmp = tempfile.TemporaryDirectory()
    cache = tune.TuneCache(os.path.join(tmp.name, "t.json"))
    sink = []
    cfg = tune.search("lu", 64, torch.float64, blocks=(16, 32),
                      variants=("mtb", "la"), top_k=2, warmup=0, repeats=1,
                      cache=cache, device="cpu", mesh=mesh, trace_sink=sink)
    labels = [t.candidate.label() for t in sink]
    again = tune.TuneCache(cache.path).get(
        tune.cache_key("lu", 64, torch.float64, tune.measured_on(
            "cuda", torch.device("cpu"))))
    tuned = get_variant("lu", "tuned")
    tune.set_default_cache(cache)
    try:
        t_mesh = tuned(a, mesh=mesh, **CPU)
    finally:
        tune.set_default_cache(None)
    want = get_variant("lu", cfg.variant)(a, cfg.schedule, **CPU)
    tmp.cleanup()
    out["tune"] = {
        "twins": sorted(lb for lb in labels if lb.endswith("/d4")),
        "singles": sorted(lb for lb in labels if "/d" not in lb),
        "mesh_shape": cfg.mesh_shape,
        "persisted": again.mesh_shape == cfg.mesh_shape,
        "winner": [c for c in labels if c == _label_of(cfg)],
        "tuned_bitwise": _equal(t_mesh, want),
    }

    # one traced la2: BCAST spans, owner tags and bytes, overlap keys
    with tracer.trace() as tr:
        get_variant("lu", "la2")(a, B, mesh=mesh, **CPU)
    bc = tr.by_cat("BCAST")
    rep = report.overlap(tr.spans)
    lanes = {e["args"]["name"] for e in export.chrome_trace(tr.spans)[
        "traceEvents"] if e.get("name") == "thread_name"}
    out["trace"] = {
        "bcast": [(s.step, s.meta["shard"], s.meta["bytes"]) for s in bc],
        "overlap": {k: rep[k] for k in ("bcast_s", "bcast_bytes",
                                        "bcast_hidden_s",
                                        "bcast_hidden_frac")},
        "shard_lanes": sum(1 for nm in lanes if "@dev" in nm),
    }

    # the refusals of the mesh path
    g = rng.standard_normal((32, 32))
    out["refusals"] = {
        "rtm": _raises(lambda: lu.lu_tiled(g, B, mesh=mesh, **CPU),
                       ValueError, "'mtb' and 'la', got 'rtm'"),
        "tiled": _raises(lambda: drivers.posv(g @ g.T + 32 * np.eye(32), g,
                                              B, variant="tiled", mesh=mesh,
                                              **CPU),
                         ValueError, "got 'tiled'"),
        "la_mb": _raises(lambda: get_variant("lu", "la_mb")(
            g, B, mesh=mesh, **CPU), ValueError, "fused_pu (la_mb)"),
        "schedule": _raises(lambda: lu.lu_blocked(g, [16, 8], mesh=mesh,
                                                  **CPU),
                            ValueError, "uniform block size"),
        "uniform_ok": _equal(lu.lu_blocked(g, [16, 16], mesh=mesh, **CPU),
                             lu.lu_blocked(g, 16, **CPU)),
        "qr_wide": _raises(lambda: qr.qr_blocked(g[:16], B, mesh=mesh,
                                                 **CPU),
                           ValueError, "m >= n"),
        "lu_square": _raises(lambda: lu.lu_blocked(g[:, :16], B, mesh=mesh,
                                                   **CPU),
                             ValueError, "square"),
        "cholesky_square": _raises(lambda: cholesky.cholesky_blocked(
            g[:, :16], B, mesh=mesh, **CPU), ValueError, "square"),
        "registry": _raises(lambda: pipeline.factorize(
            ldlt.LDLT_OPS, g, B, variant="mtb", mesh=mesh, **CPU),
            ValueError, "cholesky, lu, qr"),
        "depth": _raises(lambda: lu.lu_lookahead(g, B, depth=0, mesh=mesh,
                                                 **CPU),
                         ValueError, "depth must be >= 1"),
        "pivot": _raises(lambda: drivers.gels(tall, trhs, B, pivot=True,
                                              mesh=mesh, **CPU),
                         ValueError, "pivot=True has no mesh path"),
        "axis": _raises(lambda: lu.lu_blocked(
            g, B, mesh=mesh, layout=D.Layout(axis="data"), **CPU),
            ValueError, "not a mesh axis"),
        "transport": D.transport(mesh, "model",
                                 torch.device("cpu")).name == "gloo",
        "wrappers": _equal(D.lu_block_cyclic(g, B, mesh, lookahead=False,
                                             **CPU), lu.lu_blocked(g, B, **CPU))
        and _equal(D.cholesky_block_cyclic(g @ g.T + 32 * np.eye(32), B,
                                           mesh, **CPU),
                   cholesky.cholesky_lookahead(g @ g.T + 32 * np.eye(32), B,
                                               **CPU))
        and _equal(D.qr_block_cyclic(tall, B, mesh, **CPU),
                   qr.qr_lookahead(tall, B, **CPU)),
    }
    # Rules' "panels" entry on a live (data, model) mesh
    m2 = meshes["d2"][0]
    with sharding.use_rules(sharding.Rules(m2, {"panels": "data"})):
        out["rules_axis"] = D.resolve_axis(m2)
    out["default_axis"] = D.resolve_axis(m2)
    return out


def _label_of(cfg) -> str:
    from repro_torch.tune.sweep import Candidate

    return Candidate(variant=cfg.variant, schedule=tuple(cfg.schedule),
                     backend=cfg.backend.split("@")[0], tile=cfg.tile,
                     mesh_shape=cfg.mesh_shape).label()


@pytest.fixture(scope="module")
def world():
    return M.spawn(_world_job, 4, device_type="cpu", threads=1,
                   timeout=600)


# ---------------------------------------------------------------------------
# The world's findings.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf", DMFS)
def test_mesh_variants_bitwise_single_device(world, dmf, dtype):
    """Every (mesh, variant, n) cell is exactly the single-device engine's,
    pivots included, and every rank holds the same bits."""
    cells = {k: v for k, v in world[0]["bitwise"].items()
             if k.split(":")[1:3] == [dmf, dtype]}
    assert len(cells) == 2 * len(NS) * len(VARIANTS)
    assert all(cells.values()), [k for k, ok in cells.items() if not ok]
    for key in cells:
        assert len({w["digest"][key] for w in world}) == 1, key


def _tol(m, n, dtype):
    return 200.0 * max(m, n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dmf", DMFS)
def test_mesh_results_near_the_reference(world, dmf, dtype):
    """Rank 0's mesh factors against the reference's single-device
    factorization (JAX on the CPU), pivots equal in f64."""
    import jax
    import jax.numpy as jnp

    from repro.core.lookahead import get_variant as ref_get_variant

    jax.config.update("jax_enable_x64", True)
    for n in NS:
        got = world[0]["mesh_results"][f"d4:{dmf}:{dtype}:{n}:mtb"]
        a = _input(dmf, n, dtype, _seed(dmf, n, dtype))
        ref = jax.jit(ref_get_variant(dmf, "mtb"), static_argnums=1)(
            jnp.asarray(a), B)
        ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple)
                                       else (ref,))]
        m = a.shape[0]
        assert _rel(got[0], ref[0]) < _tol(m, n, dtype), n
        if dmf == "lu" and dtype == "float64":
            assert np.array_equal(got[1], ref[1])
        if dmf == "qr":
            assert _rel(got[1], ref[1]) < _tol(m, n, dtype)


def test_solve_drivers_batched_and_server_on_the_mesh(world):
    w = world[0]
    assert all(w["drivers"].values()), w["drivers"]
    assert all(w["batched"].values()), w["batched"]
    assert w["server"] == [True] * 4


def test_mesh_server_pump_follows_the_first_rank(world):
    """The ranks' clocks disagree on which buckets are due; each pump
    flushes the same batches on every rank, bitwise the driver."""
    for w in world:
        assert w["pump"] == {"produced": [1, 0, 1, 1], "bitwise": True}
        assert w["broadcast_object"] == 3


def test_tune_search_measures_mesh_twins(world):
    t = world[0]["tune"]
    assert t["twins"] and all(lb.replace("/d4", "") in t["singles"]
                              for lb in t["twins"])
    assert t["mesh_shape"] in (None, (4,))
    assert t["persisted"] and t["winner"]
    assert t["tuned_bitwise"]
    # the ranks agreed on one winner
    assert len({str(w["tune"]["mesh_shape"]) + str(w["tune"]["winner"])
                for w in world}) == 1


def test_traced_la2_bcast_spans(world):
    for rank, w in enumerate(world):
        t = w["trace"]
        steps = -(-64 // B)
        assert [s for s, _, _ in t["bcast"]] == list(range(steps))
        assert all(shard == s % 4 for s, shard, _ in t["bcast"])
        assert all(nb == 3 * 64 * B * 8 for _, _, nb in t["bcast"])
        ov = t["overlap"]
        assert ov["bcast_s"] > 0
        assert ov["bcast_bytes"] == steps * 3 * 64 * B * 8
        assert 0.0 <= ov["bcast_hidden_frac"] <= 1.0
        assert t["shard_lanes"] >= 2, rank


def test_mesh_refusals(world):
    bad = [k for k, ok in world[0]["refusals"].items() if not ok]
    assert not bad, bad
    assert world[0]["rules_axis"] == "data"
    assert world[0]["default_axis"] == "model"


# ---------------------------------------------------------------------------
# In-process: layouts, column decomposability, Rules, type refusals.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,nd,b", [(16, 16, 4, 16), (7, 13, 4, 3),
                                      (5, 33, 8, 4), (9, 50, 4, 16),
                                      (3, 2, 4, 5), (11, 64, 4, 16)])
def test_block_cyclic_matches_reference(m, n, nd, b):
    import jax.numpy as jnp

    from repro.core import distributed as ref

    a = np.random.default_rng(m * n).standard_normal((m, n))
    cyc = D.to_block_cyclic(a, nd, b)
    want = np.asarray(ref.to_block_cyclic(jnp.asarray(a), nd, b))
    assert np.array_equal(cyc.numpy(), want)
    back = D.from_block_cyclic(cyc, b, n=n)
    assert np.array_equal(back.numpy(), a)
    assert np.array_equal(
        D.from_block_cyclic(cyc, b).numpy(),
        np.asarray(ref.from_block_cyclic(jnp.asarray(want), b)))


@pytest.mark.parametrize("m,n,pr,pc,br,bc", [
    (16, 16, 2, 2, 4, 4), (7, 13, 2, 4, 3, 2), (33, 5, 4, 2, 4, 3),
    (50, 50, 2, 2, 16, 16)])
def test_block_cyclic_2d_matches_reference(m, n, pr, pc, br, bc):
    import jax.numpy as jnp

    from repro.core import distributed as ref

    a = np.random.default_rng(m + n).standard_normal((m, n))
    cyc = D.to_block_cyclic_2d(a, (pr, pc), br, bc)
    want = np.asarray(ref.to_block_cyclic_2d(jnp.asarray(a), (pr, pc), br,
                                             bc))
    assert np.array_equal(cyc.numpy(), want)
    back = D.from_block_cyclic_2d(cyc, br, bc, shape=(m, n))
    assert np.array_equal(back.numpy(), a)
    assert np.array_equal(
        back.numpy(),
        np.asarray(ref.from_block_cyclic_2d(jnp.asarray(want), br, bc,
                                            shape=(m, n))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_update_kernels_column_decomposable(dtype):
    """The plain GEMM-accumulate and TRSM give each column block the bits
    of the wide call: the local per-rank updates equal the wide one."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(48, 40, generator=g, dtype=dtype)
    bm = torch.randn(40, 80, generator=g, dtype=dtype)
    c = torch.randn(48, 80, generator=g, dtype=dtype)
    lo = torch.tril(torch.randn(48, 48, generator=g, dtype=dtype)) \
        + 4 * torch.eye(48, dtype=dtype)
    rhs = torch.randn(48, 80, generator=g, dtype=dtype)
    wide = blis_gemm.gemm_accum(c, a, bm, alpha=-1.0)
    wide_t = trsm.trsm(lo, rhs, lower=True)
    wide_u = trsm.trsm(lo, rhs, lower=True, unit_diagonal=True)
    for j0, j1 in [(0, 16), (16, 48), (48, 80), (0, 80), (7, 29)]:
        assert torch.equal(blis_gemm.gemm_accum(c[:, j0:j1], a,
                                                bm[:, j0:j1], alpha=-1.0),
                           wide[:, j0:j1])
        assert torch.equal(trsm.trsm(lo, rhs[:, j0:j1], lower=True),
                           wide_t[:, j0:j1])
        assert torch.equal(trsm.trsm(lo, rhs[:, j0:j1], lower=True,
                                     unit_diagonal=True), wide_u[:, j0:j1])


def test_rules_resolve_the_panels_axis():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert D.resolve_axis(mesh) == "model"
    rules = sharding.default_rules(mesh)
    assert rules.table["panels"] == "model"
    assert rules.table["batch"] == ("data",)
    with sharding.use_rules(sharding.Rules(mesh, {"panels": "data"})):
        assert sharding.active_rules().table["panels"] == "data"
        assert D.resolve_axis(mesh) == "data"
        assert D.resolve_axis(mesh, D.Layout(axis="model")) == "model"
        with sharding.use_rules(None):
            assert D.resolve_axis(mesh) == "model"
    assert sharding.active_rules() is None
    other = types.SimpleNamespace(mesh_dim_names=("rows", "cols"))
    assert D.resolve_axis(other) == "rows"
    with pytest.raises(ValueError, match="not a mesh axis"):
        D.resolve_axis(mesh, D.Layout(axis="pod"))
    assert M.PRODUCTION_MESHES[False] == ((16, 16), ("data", "model"))
    assert M.PRODUCTION_MESHES[True] == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert M.world_backend("cpu", 4) == "gloo"


def test_mesh_must_be_a_device_mesh():
    from repro_torch.solve import drivers

    a = np.eye(32)
    with pytest.raises(TypeError, match="DeviceMesh, got builtins.object"):
        drivers.gesv(a, np.ones(32), B, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="layout= is a mesh-path"):
        get_variant("lu", "mtb")(a, B, layout=D.Layout(), **CPU)
