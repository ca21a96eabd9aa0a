"""The port's bucketed solve server on the CPU, against its own unbatched
drivers and against the reference's server.

The port's ``repro_torch.serve.solver`` runs the reference's
``tests/test_serve_solver.py`` cases on ``device="cpu"`` (the kernels'
plain versions): every response of ``gesv``, ``posv``, ``gels`` and
``geqp3`` (f32 and f64, ragged shapes sharing a bucket, cached and direct)
is bitwise the port's unbatched driver on the raw shape.  Against the
reference on the same NumPy inputs: the bucket keys and slot counts are
equal, the padded operands and the extracted solutions bitwise equal, the
flop counts equal, and one raw-shape response per dmf lies within the
reference driver's 200·max(m,n,8)·eps.  Also the admission policy (a fake
clock), the ``FactorCache`` LRU, the metrics schema and the refused
blocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.bucketing as ref_bucketing
from repro.solve import drivers as ref_drivers
from repro_torch.kernels import trsm as port_trsm
from repro_torch.serve import (FactorCache, ServerConfig, SolveServer,
                               shape_class)
from repro_torch.serve import bucketing
from repro_torch.serve.metrics import SUMMARY_KEYS, throughput_summary
from repro_torch.solve import drivers

jax.config.update("jax_enable_x64", True)

DTYPES = (np.float32, np.float64)
#: the reference's test shapes: ragged requests that share a bucket
SHAPES = {
    "gesv": [(48, 48, 3), (33, 33, 1), (64, 64, 4)],
    "posv": [(48, 48, 3), (33, 33, 1), (64, 64, 4)],
    "gels": [(56, 30, 2), (80, 17, 3), (33, 20, 2)],
    "geqp3": [(56, 30, 2), (80, 17, 3), (33, 20, 2)],
}
CPU = dict(device="cpu")


def _mk(rng, dmf, m, n, nrhs, dtype=np.float32):
    a = rng.standard_normal((m, n)).astype(dtype)
    if dmf == "posv":
        a = a @ a.T + n * np.eye(n, dtype=dtype)
    return a, rng.standard_normal((m, nrhs)).astype(dtype)


def _driver(dmf, a, b, block=32):
    """The port's unbatched driver on the raw shape."""
    if dmf == "geqp3":
        return drivers.gels(a, b, block, pivot=True, **CPU)
    return getattr(drivers, dmf)(a, b, block, **CPU)


def _server(**kw):
    return SolveServer(ServerConfig(device="cpu", **kw))


# ---------------------------------------------------------------------------
# Bucketing against the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_bucket_keys_slots_and_flops_equal_the_reference(dtype):
    for dmf in ("gesv", "posv", "gels", "geqp3"):
        for n in (1, 17, 32, 33, 96, 127, 128, 129, 250, 600):
            for m in ((n,) if dmf in ("gesv", "posv") else (n, n + 7, 3 * n)):
                for nrhs in (1, 3, 4, 9):
                    key = shape_class(dmf, m, n, nrhs, dtype)
                    assert tuple(key) == tuple(ref_bucketing.shape_class(
                        dmf, m, n, nrhs, dtype))
                    assert key == shape_class(dmf, m, n, nrhs,
                                              torch.from_numpy(
                                                  np.zeros(1, dtype)).dtype)
                    assert bucketing.flops(dmf, m, n, nrhs) == \
                        ref_bucketing.flops(dmf, m, n, nrhs)
    for reqs in range(1, 40):
        for mb in (1, 2, 5, 16):
            assert bucketing.batch_slots(reqs, mb) == \
                ref_bucketing.batch_slots(reqs, mb)


def test_shape_class_rejects_bad_shapes():
    with pytest.raises(ValueError):
        shape_class("gesv", 4, 5, 1, np.float32)
    with pytest.raises(ValueError):
        shape_class("gels", 4, 5, 1, np.float32)
    with pytest.raises(ValueError):
        shape_class("sytrf", 4, 4, 1, np.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dmf", sorted(SHAPES))
def test_pad_and_extract_bitwise_the_reference(dmf, dtype):
    rng = np.random.default_rng(1)
    for m, n, r in SHAPES[dmf]:
        a, b = _mk(rng, dmf, m, n, r, dtype)
        key = shape_class(dmf, m, n, r, dtype)
        ap, bp = bucketing.pad_request(dmf, torch.from_numpy(a),
                                       torch.from_numpy(b), key)
        rap, rbp = ref_bucketing.pad_request(dmf, jnp.asarray(a),
                                             jnp.asarray(b), key)
        assert ap.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(ap.numpy(), np.asarray(rap))
        np.testing.assert_array_equal(bp.numpy(), np.asarray(rbp))
        np.testing.assert_array_equal(
            bucketing.extract(ap, n, r).numpy(),
            np.asarray(ref_bucketing.extract(rap, n, r)))


# ---------------------------------------------------------------------------
# The bitwise property: padded + batched == the unbatched driver.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dmf", sorted(SHAPES))
def test_bucketed_batch_bitwise_vs_unbatched_driver(dmf, dtype):
    """Ragged shapes landing in one bucket: every response bit-identical to
    the port's unbatched driver on the raw shape."""
    rng = np.random.default_rng(2)
    srv = _server(max_batch=8)
    reqs = [_mk(rng, dmf, m, n, r, dtype) for m, n, r in SHAPES[dmf]]
    keys = [shape_class(dmf, *a.shape, b.shape[1], dtype) for a, b in reqs]
    rids = [srv.submit(dmf, a, b) for a, b in reqs]
    assert srv.drain() == len(reqs)
    for rid, key, (a, b) in zip(rids, keys, reqs):
        resp = srv.take(rid)
        ref = _driver(dmf, a, b)
        assert resp.x.shape == ref.shape and resp.x.dtype == ref.dtype
        assert torch.equal(resp.x, ref), f"{dmf} {a.shape} not bitwise"
        assert resp.bucket == key and not resp.cache_hit
        assert resp.batch_size == keys.count(key)


@pytest.mark.parametrize("dmf", sorted(SHAPES))
def test_response_within_the_reference_driver(dmf):
    """One raw-shape request per dmf (f64) against the reference's own
    driver on the same input."""
    rng = np.random.default_rng(3)
    m, n, r = SHAPES[dmf][0]
    a, b = _mk(rng, dmf, m, n, r, np.float64)
    srv = _server()
    rid = srv.submit(dmf, a, b)
    srv.drain()
    x = srv.take(rid).x.numpy()
    if dmf == "geqp3":
        ref = ref_drivers.gels(jnp.asarray(a), jnp.asarray(b), 32,
                               pivot=True)
    else:
        ref = getattr(ref_drivers, dmf)(jnp.asarray(a), jnp.asarray(b), 32)
    ref = np.asarray(ref)
    tol = 200.0 * max(m, n, 8) * np.finfo(np.float64).eps
    assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < tol


def test_response_independent_of_batch_composition():
    """The same request gives the same bits whatever shares its flush."""
    rng = np.random.default_rng(4)
    a, b = _mk(rng, "gesv", 48, 48, 2)
    lone = _server(max_batch=8)
    rid = lone.submit("gesv", a, b)
    lone.drain()
    x_alone = lone.take(rid).x
    crowd = _server(max_batch=8)
    rid2 = crowd.submit("gesv", a, b)
    for _ in range(3):
        crowd.submit("gesv", *_mk(rng, "gesv", 40, 40, 2))
    crowd.drain()
    resp = crowd.take(rid2)
    assert resp.batch_size == 4 and resp.batch_index == 0
    assert torch.equal(resp.x, x_alone)


def test_block_128_bitwise_on_larger_buckets():
    """block=128: a system that fits one panel (n ≤ 128) takes the fused
    small solve raw and padded alike; wider ones the blocked solve."""
    rng = np.random.default_rng(5)
    srv = _server(block=128)
    cases = [("gesv", 100, 100, 3), ("gesv", 130, 130, 2),
             ("posv", 90, 90, 5), ("gels", 150, 40, 2),
             ("geqp3", 150, 40, 2)]
    reqs = [(dmf, *_mk(rng, dmf, m, n, r, np.float64))
            for dmf, m, n, r in cases]
    rids = [srv.submit(dmf, a, b) for dmf, a, b in reqs]
    srv.drain()
    for rid, (dmf, a, b) in zip(rids, reqs):
        assert torch.equal(srv.take(rid).x, _driver(dmf, a, b, 128)), dmf


# ---------------------------------------------------------------------------
# The block rule: a raw system and its bucket take the same solve route.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,ok", [
    (32, True), (64, True), (96, True), (128, True), (256, True),
    (384, True), (512, True), (16, False), (40, False), (48, False),
    (100, False), (160, False), (192, False), (255, False)])
def test_server_block_rule(block, ok):
    if ok:
        assert ServerConfig(block=block, device="cpu").block == block
    else:
        with pytest.raises(ValueError, match="bucket boundary"):
            ServerConfig(block=block, device="cpu")


def test_refused_block_changes_the_route_not_the_bits(monkeypatch):
    """What the rule guards against: with block 40, n = 40 takes the fused
    small solve and its 64-bucket the blocked one.  The bits still agree:
    the small solve is taken only where the whole real system lies in the
    first panel, whose sweep is the small solve's, and the padding's
    coupling terms are exact zeros.  The rule keeps the kernels (and the
    launch counts) of a response those of its raw shape."""
    from repro_torch.kernels import ops

    calls = []
    small = ops.lu_solve_small
    monkeypatch.setattr(ops, "lu_solve_small",
                        lambda lu, b: calls.append(lu.shape[0]) or small(lu, b))
    rng = np.random.default_rng(6)
    a, b = _mk(rng, "gesv", 40, 40, 4, np.float64)
    key = shape_class("gesv", 40, 40, 4, np.float64)
    ap, bp = bucketing.pad_request("gesv", torch.from_numpy(a),
                                   torch.from_numpy(b), key)
    raw = _driver("gesv", a, b, 40)
    assert calls == [40]                 # the fused small solve
    padded = bucketing.extract(_driver("gesv", ap, bp, 40), 40, 4)
    assert calls == [40]                 # the blocked solve
    assert torch.equal(raw, padded)
    _driver("gesv", a, b, 32)
    _driver("gesv", ap, bp, 32)
    assert calls == [40]                 # block 32: both blocked


def test_mesh_and_bad_configs_refused():
    with pytest.raises(TypeError, match="expects a torch.distributed"):
        ServerConfig(mesh=object())
    with pytest.raises(ValueError):
        ServerConfig(max_batch=0)
    srv = _server()
    with pytest.raises(ValueError):
        srv.submit("gesv", np.eye(4), np.ones(4))
    with pytest.raises(ValueError):
        srv.submit("gels", *_mk(np.random.default_rng(7), "gels", 8, 4, 1),
                   cache=True)


# ---------------------------------------------------------------------------
# FactorCache and the factor-once/solve-many path.
# ---------------------------------------------------------------------------
def test_factor_cache_hit_miss_eviction_under_pressure():
    rng = np.random.default_rng(8)
    cache = FactorCache(capacity=2)
    mats = [torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
            for _ in range(3)]
    keys = [cache.key_for("gesv", m, "cuda@cpu") for m in mats]
    assert len(set(keys)) == 3           # digests distinguish content
    assert keys[0].startswith("cuda@cpu:gesv:8x8:float32:")
    # the digest of the same values, from NumPy, as the reference takes it
    assert cache.digest(mats[0]) == cache.digest(mats[0].numpy())
    for k in keys:
        assert cache.get(k) is None      # 3 misses
    cache.put(keys[0], "f0")
    cache.put(keys[1], "f1")
    assert cache.get(keys[0]) == "f0"    # hit refreshes LRU position
    cache.put(keys[2], "f2")             # evicts keys[1] (least recent)
    assert cache.get(keys[1]) is None
    assert cache.get(keys[0]) == "f0"
    assert cache.evictions == 1
    assert cache.hits == 2 and cache.misses == 4
    assert 0 < cache.hit_rate < 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("dmf", ["gesv", "posv"])
def test_factor_once_solve_many_bitwise_and_hits(dmf, dtype):
    """Cached factors from different requests, ragged shapes in one
    bucket: every answer still bit-matches the unbatched driver."""
    rng = np.random.default_rng(9)
    srv = _server(max_batch=8)
    mats = [_mk(rng, dmf, n, n, 1, dtype)[0] for n in (48, 40)]
    rids = []
    for _ in range(3):                   # same two matrices, fresh RHS
        for a in mats:
            b = rng.standard_normal((a.shape[0], 2)).astype(dtype)
            rids.append((srv.submit(dmf, a, b, cache=True), a, b))
        srv.drain()
    for i, (rid, a, b) in enumerate(rids):
        resp = srv.take(rid)
        assert resp.cache_hit == (i >= 2)
        assert torch.equal(resp.x, _driver(dmf, a, b))
    assert srv.factor_cache.hits == 4    # rounds 2 and 3 hit for both
    assert srv.factor_cache.misses == 2
    assert srv.summary()["cache_hit_rate"] == pytest.approx(4 / 6)
    snap = srv.snapshot()
    assert snap["counter.cache.hits"] == 4
    assert snap["gauge.cache.size"] == 2
    # factor + cached-solve (bucket, slots) pairs, first served once each
    assert snap["counter.compiles"] == 2


# ---------------------------------------------------------------------------
# Admission / flush policy (injectable clock — no sleeping).
# ---------------------------------------------------------------------------
def test_flush_on_max_batch_and_max_wait():
    t = [0.0]
    srv = SolveServer(ServerConfig(max_batch=2, max_wait_s=1.0,
                                   device="cpu"), clock=lambda: t[0])
    a, b = _mk(np.random.default_rng(10), "gesv", 16, 16, 1)
    srv.submit("gesv", a, b)
    assert srv.pump() == 0               # neither full nor old
    srv.submit("gesv", a, b)
    assert srv.pump() == 2               # full batch flushes
    srv.submit("gesv", a, b)
    t[0] = 2.0
    assert srv.pump() == 1               # wait budget exceeded
    assert srv.pending() == 0
    assert srv.metrics.histogram("latency_s").percentile(100) == 2.0


# ---------------------------------------------------------------------------
# Metrics.
# ---------------------------------------------------------------------------
def test_summary_and_snapshot_schema():
    rng = np.random.default_rng(11)
    srv = _server(max_batch=2)
    a, b = _mk(rng, "gesv", 16, 16, 1)
    srv.submit("gesv", a, b)
    srv.submit("gesv", *_mk(rng, "gesv", 20, 20, 1))
    srv.submit("gels", *_mk(rng, "gels", 30, 10, 1))
    srv.drain()
    summ = srv.summary()
    for k in SUMMARY_KEYS + ("gflops_per_s", "cache_hit_rate"):
        assert k in summ
    ts = throughput_summary(2.0, 10.0)
    assert tuple(ts) == SUMMARY_KEYS and ts["items_per_s"] == 5.0
    snap = srv.snapshot()
    for k in ("gauge.queue_depth", "hist.bucket_fill.mean",
              "gauge.cache.hit_rate", "hist.padding_waste.mean",
              "hist.latency_s.p99", "counter.flops", "counter.requests",
              "counter.responses", "counter.batches", "counter.compiles"):
        assert k in snap, k
    assert snap["counter.requests"] == snap["counter.responses"] == 3
    assert snap["counter.batches"] == 2 and snap["counter.compiles"] == 2
    # 2 gesv requests in a 2-slot batch fill it; the gels one fills half
    assert snap["hist.bucket_fill.mean"] == pytest.approx(0.75)
    assert snap["counter.flops"] == pytest.approx(
        bucketing.flops("gesv", 16, 16, 1) + bucketing.flops("gesv", 20, 20, 1)
        + bucketing.flops("gels", 30, 10, 1))
