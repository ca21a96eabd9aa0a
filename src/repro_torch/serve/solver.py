"""Factorization-as-a-service: the bucketed, cached solve server.

The port of :mod:`repro.serve.solver`.  Many small heterogeneous systems
are packed into shape buckets (:mod:`repro_torch.serve.bucketing`) and
flushed a bucket at a time:

    submit → bucket queue → (admission: max batch / max wait) →
    pad to bucket shape → driver, system by system → unpad → response

plus a factor-once/solve-many path: padded operands are content-hashed
into an LRU :class:`FactorCache` keyed like the tuner's cache
(:func:`repro_torch.tune.cache.cache_key`); a flush factors only its
misses, then solves every request against its cached factors.

Reproducibility contract: every response is bitwise the port's unbatched
driver (``gesv``, ``posv``, ``gels``, ``gels(pivot=True)`` at
``ServerConfig.block``) on the raw request shape, on CPU tensors (the
kernels' plain versions) and on the GPU (the kernels), for ragged shapes
sharing a bucket and for cached and direct requests alike.  It rests on
the padding being exact (``bucketing``'s docstring) and on one limit:

* ``ServerConfig.block`` must send a raw system and its bucket down the
  same solve route: ``lu_solve_packed`` takes the fused small solve for
  ``n ≤ min(block, SMALL_SOLVE_MAX_N)``, so that bound must itself be a
  bucket boundary (32, 64, 96, 128 or 256; a block of 40 would solve
  n = 40 by the small solve and its 64-bucket blocked).  Any other block
  is refused with a ValueError.  The bits would agree even so (the small
  solve is taken only where the whole real system lies in the first
  panel, whose sweep is the small solve's); the rule keeps a response's
  kernels, and its launch counts, those of its raw shape.

The QR and QRCP panel kernels deal a panel's rows to their blocks in
32-row chunks round-robin, so a ``gels``/``geqp3`` bucket of any height
(past 32 rows an SM too) sums its real rows as the raw shape does.

Departures from the reference, all from running hand-written kernels
rather than one ``vmap``-compiled program a bucket:

* **Unused slots are not computed.**  The reference fills a batch up to
  :func:`~repro_torch.serve.bucketing.batch_slots` with replicas of a real
  request (XLA lowers a batch of 1 differently).  The port keeps the slot
  count for the ``bucket_fill`` and ``padding_waste`` metrics and runs
  only the real requests, one after another in slot order.
* **``compiles`` counts the (bucket, slots) pairs first served** — per
  direct solve, factor and cached solve, as the reference counts its
  executables.  There is no executable here: the count keeps the
  reference's key and still shows the logarithmic bound on shape classes.
  The kernels themselves are built once a library, at first use.
* **``ServerConfig.backend`` defaults to ``"cuda"``** (the kernels; their
  plain versions on CPU tensors) and ``device`` to the GPU.
* **``ServerConfig.mesh`` is a ``DeviceMesh``, and the server is SPMD.**
  Direct ``gesv``/``posv`` flushes factor each system over the mesh's
  block-cyclic shards (:mod:`repro_torch.solve.batched`'s mesh loop, the
  reference's path), bitwise the single-device answers.  Every rank of
  the mesh runs the same server and submits the same requests in the same
  order, as every rank calls a mesh driver with the same input; each rank
  holds every response.  ``pump`` flushes what the mesh's first rank finds
  due by its own clock, on every rank.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.trsm import SMALL_SOLVE_MAX_N
from repro_torch.obs import tracer as _obs
from repro_torch.serve import bucketing
from repro_torch.serve.bucketing import BucketKey
from repro_torch.serve.metrics import Metrics, throughput_summary
from repro_torch.solve import drivers
from repro_torch.tune.cache import cache_key, measured_on

__all__ = ["ServerConfig", "SolveRequest", "SolveResponse", "FactorCache",
           "SolveServer"]

#: dmfs with a factor-object fast path (factor once / solve many).
CACHEABLE_DMFS = ("gesv", "posv")


def _driver(dmf: str, a, b, cfg: "ServerConfig", device):
    kw = dict(backend=cfg.backend, device=device)
    if dmf == "geqp3":
        return drivers.gels(a, b, cfg.block, pivot=True, **kw)
    return getattr(drivers, dmf)(a, b, cfg.block, **kw)


def _factor(dmf: str, a, cfg: "ServerConfig", device):
    fn = drivers.lu_factor if dmf == "gesv" else drivers.cholesky_factor
    return fn(a, cfg.block, backend=cfg.backend, device=device)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    max_batch: int = 16        # flush a bucket at this many requests
    max_wait_s: float = 0.01   # ... or once its oldest request is this old
    block: int = 32            # panel width (see the module docstring)
    cache_capacity: int = 64   # FactorCache entries
    backend: str = "cuda"
    #: a torch.distributed.device_mesh.DeviceMesh: direct gesv/posv
    #: batches factor each system over its block-cyclic shards
    mesh: Optional[object] = None
    #: where requests are solved: None = the GPU, "cpu" for the plain
    #: versions
    device: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            from repro_torch.core.distributed import check_mesh

            check_mesh(self.mesh)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if isinstance(self.block, bool) or not isinstance(self.block, int) \
                or self.block < 1:
            raise ValueError(f"block must be a positive int, got "
                             f"{self.block!r}")
        small = min(self.block, SMALL_SOLVE_MAX_N)
        if bucketing.boundary(small) != small:
            raise ValueError(
                f"block={self.block}: systems of n <= {small} take the fused "
                f"small solve, and {small} is not a bucket boundary, so a "
                f"raw system and its bucket would be solved by different "
                f"routes (n = {small} and its {bucketing.boundary(small)}-"
                f"bucket); use a block whose min(block, {SMALL_SOLVE_MAX_N}) "
                f"is 32, 64, 96, 128 or 256")


@dataclasses.dataclass
class SolveRequest:
    req_id: int
    dmf: str
    a: torch.Tensor
    b: torch.Tensor
    bucket: BucketKey
    submit_t: float
    cache: bool = False        # route through the FactorCache


@dataclasses.dataclass
class SolveResponse:
    req_id: int
    dmf: str
    x: torch.Tensor            # raw request shape — unpadded
    bucket: BucketKey
    batch_index: int           # slot inside the flushed batch
    batch_size: int            # real requests in that batch
    latency_s: float
    cache_hit: bool = False


class FactorCache:
    """LRU of factor objects, keyed like :class:`repro_torch.tune.TuneCache`.

    Key: ``backend:dmf:MxN:dtype:digest`` (:func:`repro_torch.tune.cache.
    cache_key`) — shapes are the bucket-canonical shapes, the digest a
    content hash of the padded operand, so a hit means "same matrix, same
    bucket".
    """

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._store: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def digest(a) -> str:
        """SHA-1 of the operand's bytes (a tensor on any device, or a NumPy
        array), 16 hex digits — the reference's digest of the same values."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().contiguous().numpy()
        return hashlib.sha1(a.tobytes()).hexdigest()[:16]

    def key_for(self, dmf: str, a, backend: str) -> str:
        return cache_key(dmf, tuple(a.shape), a.dtype, backend,
                         digest=self.digest(a))

    def get(self, key: str):
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._store.move_to_end(key)
        return entry

    def put(self, key: str, factors) -> None:
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = factors
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._store)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SolveServer:
    """Single-threaded bucketed solve server with an injectable clock.

    Usage::

        srv = SolveServer(ServerConfig(max_batch=8, device="cpu"))
        rid = srv.submit("gesv", a, b)
        srv.drain()                      # or srv.pump() on a schedule
        x = srv.take(rid).x
    """

    def __init__(self, config: ServerConfig = ServerConfig(), *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config
        self.clock = clock
        self.device = resolve_device(config.device)
        self.metrics = Metrics()
        self.factor_cache = FactorCache(config.cache_capacity)
        self._queues: Dict[Tuple[BucketKey, bool], List[SolveRequest]] = {}
        self._responses: Dict[int, SolveResponse] = {}
        self._next_id = 0
        #: (kind, bucket, slots) first served: the reference's executables
        self._served: set = set()
        self._wall0: Optional[float] = None

    # ------------------------------------------------------------------
    # Ingest.
    # ------------------------------------------------------------------
    def submit(self, dmf: str, a, b, *, cache: bool = False) -> int:
        """Enqueue one request (``a`` m × n, ``b`` m × nrhs: tensors or
        NumPy arrays, copied once to the server's device); returns its id.
        ``cache=True`` routes via the factor-once/solve-many path (``dmf``
        must be cacheable)."""
        a = torch.as_tensor(a)
        b = torch.as_tensor(b)
        if b.dim() != 2:
            raise ValueError("b must be (m, nrhs)")
        if a.dim() != 2 or b.shape[0] != a.shape[0]:
            raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do "
                             f"not form a system")
        if cache and dmf not in CACHEABLE_DMFS:
            raise ValueError(f"{dmf} has no factor-object solve path")
        key = bucketing.shape_class(dmf, a.shape[0], a.shape[1],
                                    b.shape[1], a.dtype)
        a = a.to(self.device, copy=True)
        b = b.to(device=self.device, dtype=a.dtype, copy=True)
        now = self.clock()
        if self._wall0 is None:
            self._wall0 = now
        req = SolveRequest(self._next_id, dmf, a, b, key, now, cache)
        self._next_id += 1
        self._queues.setdefault((key, cache), []).append(req)
        self.metrics.counter("requests").inc()
        self.metrics.gauge("queue_depth").set(self._depth())
        return req.req_id

    def _depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------------
    # Scheduling.
    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Flush every bucket that is full or past its wait budget.
        Returns the number of responses produced.

        On a mesh, every rank flushes what the mesh's first rank chose by
        its own clock (a mesh flush enters collectives, and the ranks'
        clocks differ), so every rank calls ``pump`` at the same point of
        the same request stream."""
        plan = self._due(self.clock())
        if self.config.mesh is not None:
            from repro_torch.core.distributed import broadcast_object

            plan = broadcast_object(self.config.mesh, plan)
        produced = 0
        for qkey, count in plan:
            q = self._queues.get(qkey, [])
            if len(q) < count:
                raise RuntimeError(
                    f"the mesh's first rank flushes {count} requests of "
                    f"{qkey[0]}, this rank holds {len(q)}: every rank must "
                    f"submit the same requests")
            produced += self._flush(qkey, q[:count])
            del q[:count]
            if not q:
                self._queues.pop(qkey, None)
        self.metrics.gauge("queue_depth").set(self._depth())
        return produced

    def _due(self, now: float) -> List[Tuple[Tuple[BucketKey, bool], int]]:
        """The flushes ``pump`` makes at ``now``, in order: (queue, requests)
        for every full batch, then the rest of a queue whose oldest request
        has waited ``max_wait_s``."""
        cfg = self.config
        plan = []
        for qkey, q in self._queues.items():
            full = len(q) // cfg.max_batch * cfg.max_batch
            plan += [(qkey, cfg.max_batch)] * (full // cfg.max_batch)
            if len(q) > full and now - q[full].submit_t >= cfg.max_wait_s:
                plan.append((qkey, len(q) - full))
        return plan

    def drain(self) -> int:
        """Flush everything regardless of admission policy."""
        produced = 0
        for qkey in list(self._queues):
            q = self._queues.pop(qkey)
            for i in range(0, len(q), self.config.max_batch):
                produced += self._flush(qkey, q[i:i + self.config.max_batch])
        self.metrics.gauge("queue_depth").set(self._depth())
        return produced

    def take(self, req_id: int) -> SolveResponse:
        return self._responses.pop(req_id)

    def pending(self) -> int:
        return self._depth()

    # ------------------------------------------------------------------
    # Execution.
    # ------------------------------------------------------------------
    def _flush(self, qkey: Tuple[BucketKey, bool],
               batch: List[SolveRequest]) -> int:
        key, cached = qkey
        # One `serve` span a flushed batch when a tracer is installed; a
        # tracer built with ``metrics=server.metrics`` puts its span.serve
        # histogram in the registry snapshot() reads.
        tr = _obs.active()
        run = self._run_cached if cached else self._run_direct
        if tr is None:
            xs, hits = run(key, batch)
        else:
            name = (f"flush:{key.dmf}[{key.m}x{key.n}x{key.nrhs}]"
                    f"{'+cache' if cached else ''}")
            xs, hits = tr.wrap("serve", name, lambda: run(key, batch),
                               batch=len(batch), cached=cached)
        if self.device.type == "cuda":   # a response is done when computed
            torch.cuda.synchronize(self.device)
        done = self.clock()
        real = sum(bucketing.flops(r.dmf, r.a.shape[0], r.a.shape[1],
                                   r.b.shape[1]) for r in batch)
        slots = bucketing.batch_slots(len(batch), self.config.max_batch)
        self.metrics.histogram("bucket_fill").record(len(batch) / slots)
        pad_cells = slots * (key.m * key.n + key.m * key.nrhs)
        real_cells = sum(r.a.numel() + r.b.numel() for r in batch)
        self.metrics.histogram("padding_waste").record(
            pad_cells / real_cells - 1.0)
        self.metrics.counter("batches").inc()
        self.metrics.counter("flops").inc(real)
        for i, req in enumerate(batch):
            lat = done - req.submit_t
            self.metrics.histogram("latency_s").record(lat)
            self.metrics.counter("responses").inc()
            x = bucketing.extract(xs[i], req.a.shape[1], req.b.shape[1])
            self._responses[req.req_id] = SolveResponse(
                req.req_id, req.dmf, x, key, i, len(batch), lat, hits[i])
        return len(batch)

    def _first_served(self, kind: str, key: BucketKey, n: int) -> None:
        """Count a (bucket, slots) pair the first time it is served."""
        ekey = (kind, key, bucketing.batch_slots(n, self.config.max_batch))
        if ekey not in self._served:
            self._served.add(ekey)
            self.metrics.counter("compiles").inc()

    def _run_direct(self, key: BucketKey, batch: List[SolveRequest]):
        """Every request padded and solved by the unbatched driver, in slot
        order."""
        self._first_served("solve", key, len(batch))
        if self.config.mesh is not None and key.dmf in ("gesv", "posv"):
            # the mesh's direct path: each system over the whole mesh in
            # turn (solve.batched's mesh loop)
            from repro_torch.solve import batched

            pads = [bucketing.pad_request(r.dmf, r.a, r.b, key)
                    for r in batch]
            fn = (batched.gesv_batched if key.dmf == "gesv"
                  else batched.posv_batched)
            xs = fn(torch.stack([p[0] for p in pads]),
                    torch.stack([p[1] for p in pads]), self.config.block,
                    backend=self.config.backend, device=self.device,
                    mesh=self.config.mesh)
            return xs, [False] * len(batch)
        xs = [_driver(key.dmf, *bucketing.pad_request(r.dmf, r.a, r.b, key),
                      self.config, self.device) for r in batch]
        return xs, [False] * len(batch)

    def _run_cached(self, key: BucketKey, batch: List[SolveRequest]):
        """Factor-once/solve-many: look every padded operand up in the
        cache, factor only the misses, then solve every request against
        its factors."""
        cfg = self.config
        backend = measured_on(cfg.backend, self.device)
        pads = [bucketing.pad_request(r.dmf, r.a, r.b, key) for r in batch]
        keys = [self.factor_cache.key_for(r.dmf, ap, backend)
                for r, (ap, _) in zip(batch, pads)]
        entries = [self.factor_cache.get(ck) for ck in keys]
        hits = [e is not None for e in entries]
        misses = [i for i, e in enumerate(entries) if e is None]
        if misses:
            self._first_served("factor", key, len(misses))
            for i in misses:
                entries[i] = _factor(key.dmf, pads[i][0], cfg, self.device)
                self.factor_cache.put(keys[i], entries[i])
        self._first_served("gather", key, len(batch))
        xs = [f.solve(bp) for f, (_, bp) in zip(entries, pads)]
        self._sync_cache_metrics()
        return xs, hits

    def _sync_cache_metrics(self) -> None:
        fc = self.factor_cache
        self.metrics.gauge("cache.size").set(len(fc))
        self.metrics.gauge("cache.hit_rate").set(fc.hit_rate)
        self.metrics.counter("cache.hits").value = float(fc.hits)
        self.metrics.counter("cache.misses").value = float(fc.misses)
        self.metrics.counter("cache.evictions").value = float(fc.evictions)

    # ------------------------------------------------------------------
    # Observability.
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        self._sync_cache_metrics()
        return self.metrics.snapshot()

    def summary(self) -> Dict[str, float]:
        """Shared serve-layer schema (metrics.SUMMARY_KEYS) + solver extras."""
        now = self.clock()
        wall = (now - self._wall0) if self._wall0 is not None else 0.0
        done = self.metrics.counter("responses").value
        out = throughput_summary(wall, done,
                                 self.metrics.histogram("latency_s"))
        out["gflops_per_s"] = (
            self.metrics.counter("flops").value / wall / 1e9 if wall else 0.0)
        out["cache_hit_rate"] = self.factor_cache.hit_rate
        return out
