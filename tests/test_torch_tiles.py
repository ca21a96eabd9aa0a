"""The port's tile-DAG backend against the reference's, on the CPU.

The same NumPy inputs go through ``repro.core.tiles`` (JAX on the CPU, the
jnp backend) and ``repro_torch.core.tiles`` (``device="cpu"``: the
``"cuda"`` backend's kernels run their plain versions, and the ``"torch"``
library backend):

* the task programs, their dependencies and wavefronts, and the tile grid
  are the reference's;
* tiled Cholesky is within the reference's 200·max(n,8)·eps of the
  reference's tiled Cholesky, and bitwise the port's ``rtm`` and ``mtb``
  factors under ``"cuda"`` (the plain GEMM and TRSM are row- and
  column-decomposable, as the kernels are);
* tiled QR's R and ``qr_apply_qt`` are within that tolerance of the
  reference's; a single tile is the port's GEQRF bitwise; two runs are
  bitwise equal; ``TiledQRFactors`` solves and logdets as the reference's;
* the task bodies take their kernels from the backend alone;
* ``make_tiled`` refuses what the reference refuses, and a traced run
  gives the reference's TILE spans and ``tile_dag`` counts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.solve as ref_solve
from repro.core import tiles as ref_tiles
from repro.obs import report as ref_report
from repro.obs import tracer as ref_tracer
from repro_torch.core import cholesky, lookahead, qr, tiles
from repro_torch.core.backend import TORCH_BACKEND, Backend
from repro_torch.core.qrcp import QRCP_OPS
from repro_torch.obs import report, tracer
from repro_torch.solve import (TiledQRFactors, cholesky_factor, gels, posv,
                               qr_factor)

jax.config.update("jax_enable_x64", True)

DTYPES = ("float32", "float64")
BACKENDS = ("cuda", "torch")
#: shape class -> ((m, n), b)
QR_SHAPES = {"tall": ((64, 40), 16), "square": ((48, 48), 16),
             "wide": ((40, 64), 16), "ragged": ((50, 35), 16)}
CHOL_SHAPES = {"square": (48, 16), "ragged": (50, 16), "small": (7, 16)}


def _tol(n, dtype):
    return 200.0 * max(n, 8) * float(np.finfo(dtype).eps)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-300))


def _rand(m, n, dtype="float64", seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _spd(n, dtype="float64", seed=0):
    g = _rand(n, n, dtype, seed)
    return g @ g.T + n * np.eye(n, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _ref_qr(shape, dtype):
    (m, n), b = QR_SHAPES[shape]
    return jax.jit(ref_tiles.qr_tiles, static_argnums=1)(
        jnp.asarray(_rand(m, n, dtype)), b)


def _program(name, dims, module):
    return getattr(module, f"_{name}_tasks")(*dims)


# ---------------------------------------------------------------------------
# The task programs and the grid.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,dims", [
    ("qr", (1, 3)), ("qr", (2, 2)), ("qr", (3, 3)), ("qr", (4, 2)),
    ("qr", (3, 5)), ("cholesky", (1,)), ("cholesky", (3,)),
    ("cholesky", (5,))], ids=lambda v: str(v))
def test_dag_keys_and_waves_equal_the_reference(name, dims):
    mine = tiles.build_dag(_program(name, dims, tiles))
    ref = ref_tiles.build_dag(_program(name, dims, ref_tiles))
    assert [(t.kind, t.key, t.reads, t.writes) for t in mine.tasks] == \
        [(t.kind, t.key, t.reads, t.writes) for t in ref.tasks]
    assert mine.deps == ref.deps
    assert mine.wave == ref.wave
    assert [[t.key for t in w] for w in mine.waves] == \
        [[t.key for t in w] for w in ref.waves]
    assert mine.depth == ref.depth


def test_build_dag_refuses_duplicate_keys():
    t = tiles.TileTask("POTRF", (0, 0, 0), reads=(("A", 0, 0),),
                       writes=(("A", 0, 0),), run=lambda st: None)
    with pytest.raises(ValueError, match="unique"):
        tiles.build_dag([t, t])


@pytest.mark.parametrize("n,b", [(100, 32), (100, (48, 32)), (7, 16),
                                 (64, 16), (64, (16, 8, 40))])
def test_tile_grid_equals_the_reference(n, b):
    assert tiles.tile_grid(n, b) == ref_tiles.tile_grid(n, b)


# ---------------------------------------------------------------------------
# Tiled Cholesky.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(CHOL_SHAPES))
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_cholesky_against_the_reference(dtype, backend, shape):
    n, b = CHOL_SHAPES[shape]
    a = _spd(n, dtype)
    ref = jax.jit(ref_tiles.cholesky_tiles, static_argnums=1)(
        jnp.asarray(a), b)
    got = lookahead.get_variant("cholesky", "tiled")(a, b, backend=backend,
                                                     device="cpu")
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.numpy(), ref) < _tol(n, dtype)
    if backend == "cuda":
        # the decomposable GEMM and TRSM: the same bits as the pipeline's
        for variant in ("rtm", "mtb"):
            assert torch.equal(got, lookahead.get_variant(
                "cholesky", variant)(a, b, device="cpu")), variant


# ---------------------------------------------------------------------------
# Tiled QR.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(QR_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_qr_against_the_reference(dtype, shape):
    (m, n), b = QR_SHAPES[shape]
    a = _rand(m, n, dtype)
    ref = _ref_qr(shape, dtype)
    got = tiles.qr_tiles(a, b, device="cpu")
    assert len(got.factors) == len(ref.factors)
    assert [(f.col, f.rows0, f.rows1) for f in got.factors] == \
        [(f.col, f.rows0, f.rows1) for f in ref.factors]
    tol = _tol(max(m, n), dtype)
    assert float(torch.tril(got.r[: n], -1).abs().max()) == 0.0
    assert _rel(got.r.numpy(), ref.r) < tol
    c = _rand(m, 3, dtype, seed=1)
    want = ref_tiles.qr_apply_qt(ref, jnp.asarray(c))
    assert _rel(tiles.qr_apply_qt(got, c).numpy(), want) < tol
    assert _rel(tiles.qr_apply_qt(got, c[:, 0]).numpy(), want[:, 0]) < tol
    q = tiles.qr_form_q(got, backend="torch").double()
    assert _rel((q @ got.r.double()).numpy(), a) < tol
    assert float(torch.linalg.matrix_norm(
        q.mT @ q - torch.eye(m, dtype=torch.float64))) < tol


@pytest.mark.parametrize("shape", [(24, 16), (16, 24), (20, 20)])
def test_single_tile_is_the_ports_geqrf_bitwise(shape):
    a = _rand(*shape, seed=5)
    got = tiles.qr_tiles(a, 32, device="cpu")
    assert len(got.factors) == 1
    packed, _ = lookahead.get_variant("qr", "mtb")(a, 32, device="cpu")
    assert torch.equal(got.r, torch.triu(packed))


def test_tiled_runs_are_bitwise_deterministic():
    a = _rand(70, 45, seed=1)
    t1 = tiles.qr_tiles(a, 16, device="cpu")
    t2 = tiles.qr_tiles(a, 16, device="cpu")
    assert torch.equal(t1.r, t2.r)
    for f1, f2 in zip(t1.factors, t2.factors, strict=True):
        assert torch.equal(f1.v, f2.v) and torch.equal(f1.t, f2.t)
    s = _spd(50)
    assert torch.equal(tiles.cholesky_tiles(s, 16, device="cpu"),
                       tiles.cholesky_tiles(s, 16, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_qr_factors_solve_and_logdet_against_the_reference(dtype):
    a, rhs = _rand(40, 24, dtype, seed=9), _rand(40, 2, dtype, seed=10)
    sq = _spd(32, dtype, seed=13)

    @jax.jit
    def reference(a, rhs, sq):
        return (ref_solve.qr_factor(a, 16, variant="tiled").solve(rhs),
                ref_solve.qr_factor(sq, 16, variant="tiled").logdet())

    want, (ref_sign, ref_logabs) = reference(
        jnp.asarray(a), jnp.asarray(rhs), jnp.asarray(sq))
    fac = qr_factor(a, 16, variant="tiled", device="cpu")
    assert isinstance(fac, TiledQRFactors)
    assert (fac.m, fac.n) == (40, 24)
    tol = _tol(40, dtype)
    assert _rel(fac.solve(rhs).numpy(), want) < tol
    assert _rel(fac.solve(rhs[:, 0]).numpy(), want[:, 0]) < tol
    assert torch.equal(gels(a, rhs, 16, variant="tiled", device="cpu"),
                       fac.solve(rhs))
    sign, logabs = qr_factor(sq, 16, variant="tiled", device="cpu").logdet()
    assert float(sign) == float(ref_sign) == 0.0
    assert abs(float(logabs) - float(ref_logabs)) < tol * abs(
        float(ref_logabs))
    with pytest.raises(ValueError, match="m >= n"):
        qr_factor(_rand(24, 40), 16, variant="tiled",
                  device="cpu").solve(np.ones(24))
    with pytest.raises(ValueError, match="square"):
        fac.logdet()


# ---------------------------------------------------------------------------
# The backend supplies every kernel; the drivers and the registry.
# ---------------------------------------------------------------------------
def _recording(counts):
    def rec(name, fn):
        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    return Backend(
        name="rec", gemm=rec("gemm", TORCH_BACKEND.gemm),
        trsm=rec("trsm", TORCH_BACKEND.trsm),
        update=rec("update", TORCH_BACKEND.update),
        panel_fns={"qr": rec("qr_panel", qr.qr_panel_plain),
                   "cholesky": rec("cholesky_panel",
                                   cholesky.cholesky_panel)})


def test_task_bodies_take_their_kernels_from_the_backend():
    counts = {}
    tiles.cholesky_tiles(_spd(48), 16, backend=_recording(counts),
                         device="cpu")
    kinds = [t.kind for t in tiles._cholesky_tasks(3)]
    assert counts == {"cholesky_panel": kinds.count("POTRF"),
                      "trsm": kinds.count("TRSM"),
                      "update": kinds.count("SYRK") + kinds.count("GEMM")}
    counts.clear()
    tiles.qr_tiles(_rand(48, 32), 16, backend=_recording(counts),
                   device="cpu")
    kinds = [t.kind for t in tiles._qr_tasks(3, 2)]
    applies = kinds.count("UNMQR") + kinds.count("TSMQR")
    assert counts == {"qr_panel": kinds.count("GEQRT") + kinds.count("TSQRT"),
                      "gemm": 2 * applies, "update": applies}


def test_drivers_and_registry_take_tiled():
    s, rhs = _spd(40), _rand(40, 2, seed=3)
    assert torch.equal(cholesky_factor(s, 16, variant="tiled",
                                       device="cpu").l,
                       cholesky_factor(s, 16, variant="mtb", device="cpu").l)
    x = posv(s, rhs, 16, variant="tiled", device="cpu")
    assert _rel((torch.from_numpy(s) @ x).numpy(), rhs) < _tol(40, "float64")
    assert lookahead.get_variant("qr", "tiled") is tiles.qr_tiles
    assert lookahead.get_variant("cholesky", "tiled") is tiles.cholesky_tiles
    for dmf in ("lu", "ldlt", "gauss_jordan", "band_reduction"):
        with pytest.raises(KeyError, match="not available"):
            lookahead.get_variant(dmf, "tiled")
    for dmf in ("qrcp", "hessenberg"):
        with pytest.raises(KeyError, match="excluded by policy"):
            lookahead.get_variant(dmf, "tiled")
    with pytest.raises(ValueError, match="no look-ahead window"):
        lookahead.deepen("tiled", 2)
    with pytest.raises(ValueError, match="square"):
        tiles.cholesky_tiles(np.ones((4, 3)), 2, device="cpu")
    for call in (lambda: posv(s, rhs, 16, variant="tiled", mesh=object(),
                              device="cpu"),
                 lambda: qr_factor(s, 16, variant="tiled", mesh=object(),
                                   device="cpu")):
        with pytest.raises(ValueError, match="'mtb' and 'la', got 'tiled'"):
            call()


@pytest.mark.parametrize("ops,exc,match", [
    (QRCP_OPS, ValueError, "cannot emit a tile DAG for 'qrcp'"),
    (dataclasses.replace(qr.QR_OPS, tiles=None), ValueError,
     "per-tile fragmentation"),
    (dataclasses.replace(qr.QR_OPS, name="mystery"), KeyError,
     "no tile task program")], ids=["la_unsafe", "no_tiles_hook", "unknown"])
def test_make_tiled_refuses_what_the_reference_refuses(ops, exc, match):
    with pytest.raises(exc, match=match):
        tiles.make_tiled(ops)


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dmf", ["cholesky", "qr"])
def test_tile_spans_and_report_equal_the_reference(dmf):
    if dmf == "cholesky":
        a, mine_fn, ref_fn = _spd(48), tiles.cholesky_tiles, \
            ref_tiles.cholesky_tiles
    else:
        a, mine_fn, ref_fn = _rand(48, 32), tiles.qr_tiles, ref_tiles.qr_tiles
    with tracer.trace() as tr:
        mine_fn(a, 16, device="cpu")
    with ref_tracer.trace() as ref_tr:
        ref_fn(jnp.asarray(a), 16)

    def key(spans):
        return [(s.cat, s.name, s.step, s.it, s.depth, s.meta)
                for s in spans]

    assert key(tr.spans) == key(ref_tr.spans)
    mine, ref = report.tile_dag(tr.spans), ref_report.tile_dag(ref_tr.spans)
    for k in ("n_tasks", "n_waves", "max_wave_width"):
        assert mine[k] == ref[k], k
    assert set(mine["kind_s"]) == set(ref["kind_s"])
    assert mine["critical_path_s"] <= mine["serialized_s"]
