"""Model-seeded empirical search over (variant, depth, schedule).

The port of :mod:`repro.tune.sweep`.  The sweep for one ``(dmf, n,
dtype)`` case on one device:

1. enumerate candidates: every variant × block size × backend, each block
   contributing its uniform schedule and the decreasing-``b`` tail
   (:func:`repro_torch.tune.schedule.tail_schedule`, the paper's §5
   early-termination analogue).  Look-ahead depth is a knob like the
   others (``"la2"`` from ``list_variants``, any ``"la<d>"`` passed
   explicitly); a deep candidate is dropped when it has no more panels
   than its depth, or when the cost model scores it no faster than its
   depth-1 twin;
2. rank them with :mod:`repro_torch.tune.model` and keep the top ``k``;
3. measure those **and the fixed ``b = 128`` ``la`` baseline** with
   :func:`_time_fn`, so the winner is never slower than the untuned
   default on this device;
4. store the winner in the :class:`~repro_torch.tune.cache.TuneCache`
   under a key that names the backend and the device type; the next call
   returns it without measuring (``from_cache=True``).

Two departures from the reference, on purpose:

* **f64 ``la_mb`` stays.**  The reference drops ``la_mb`` from float64
  sweeps because its fused kernels accumulate in float32.  The port's
  fused panel updates compute in float64 and are bitwise ``mtb``
  (PERF.md §5), so a float64 sweep keeps them.
* **No kernel-blocking axis.**  The reference sweeps the BLIS GEMM's
  (bm, bn, bk), derived from the TPU's on-chip memory.  The port's GEMM
  picks its tile from compiled instances
  (:func:`repro_torch.kernels.blis_gemm.plan`), so every candidate has
  ``kernel_blocks=None``, and ``"tuned"`` refuses an entry that has them.

Calls run eagerly (there is no ``jax.jit``); a candidate's time includes
the driver's copy of the input, as a user's call does.

Device layout.  ``search(mesh=...)`` (a ``DeviceMesh``; every rank of it
calls ``search`` alike) also measures a block-cyclic twin of each ranked
``mtb``/``la``-family candidate with a uniform schedule, label suffix
``/d{nd}`` (``Candidate.mesh_shape = (nd,)``); a mesh winner persists
``TuneConfig.mesh_shape``.  Each rank times its own calls; the mesh's
collectives keep the ranks in step, and the first rank's timings decide
for all (broadcast over the world), so every rank caches the same winner.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backend import gemm_torch, get_backend
from repro_torch.core.blocking import expand_schedule
from repro_torch.core.lookahead import list_variants, parse_variant
from repro_torch.device import resolve_device
from repro_torch.tune import model
from repro_torch.tune.cache import (TuneCache, TuneConfig, cache_key,
                                    default_cache, dtype_name, measured_on)
from repro_torch.tune.schedule import is_uniform, tail_schedule

__all__ = ["Candidate", "CandidateTrace", "search", "DEFAULT_BLOCKS",
           "BASELINE_BLOCK", "BASELINE_VARIANT"]

DEFAULT_BLOCKS: Tuple[int, ...] = (32, 48, 64, 96, 128, 192, 256)
BASELINE_BLOCK = 128          # every entry point's default block
BASELINE_VARIANT = "la"

#: DMFs whose unpivoted algorithms need an SPD / diagonally dominant input.
_SPD_DMFS = ("cholesky", "ldlt", "gauss_jordan")


@dataclasses.dataclass(frozen=True)
class Candidate:
    variant: str
    schedule: Tuple[int, ...]
    backend: str
    #: the tile size of a ``variant="tiled"`` candidate (the leading width
    #: of its schedule, from which the tile grid is built), else None
    tile: Optional[int] = None
    #: the mesh shape a block-cyclic twin is measured over, ``(nd,)`` for
    #: the engine's 1-D column cycle; None = one device
    mesh_shape: Optional[Tuple[int, ...]] = None

    def label(self) -> str:
        tail = "uniform" if is_uniform(self.schedule) else "tail"
        lbl = f"{self.variant}/b{self.schedule[0]}/{tail}/{self.backend}"
        if self.tile is not None:
            lbl += f"/t{self.tile}"
        if self.mesh_shape is not None:
            nd = 1
            for d in self.mesh_shape:
                nd *= d
            lbl += f"/d{nd}"
        return lbl


@dataclasses.dataclass
class CandidateTrace:
    """One measured candidate's trace beside its modeled cost.

    :func:`search` fills these when given a ``trace_sink`` list: after the
    timed runs, each measured candidate runs once more under
    :func:`repro_torch.obs.tracer.trace`, so its spans (PF/TU/PU with
    in-flight depth, or TILE) sit beside the model's prediction.
    ``overlap`` is :func:`repro_torch.obs.report.overlap` of the spans;
    ``predicted_s`` is None for an unmodeled (dmf, schedule).
    """

    dmf: str
    n: int
    candidate: Candidate
    measured_s: float
    predicted_s: Optional[float]
    spans: list
    overlap: dict


def _test_matrix(dmf: str, n: int, dtype, seed: int,
                 device: torch.device) -> torch.Tensor:
    """The reference's input recipe: normal entries from ``seed`` (NumPy),
    ``A·Aᵀ + n·I`` for the DMFs that need a definite input, the product
    taken on ``device``."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(
        dtype_name(dtype))).to(device)
    if dmf in _SPD_DMFS:
        a = gemm_torch(a, a.mT)
        a.diagonal().add_(float(n))
    return a


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, a: torch.Tensor, *, warmup: int = 1,
             repeats: int = 3) -> float:
    """Median seconds of ``repeats`` calls of ``fn(a)`` after ``warmup``
    calls, by the host clock, the device synchronised before and after
    each call when ``a`` is on a GPU."""
    for _ in range(warmup):
        fn(a)
    _sync(a.device)
    times = []
    for _ in range(repeats):
        _sync(a.device)
        t0 = time.perf_counter()
        fn(a)
        _sync(a.device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _run(dmf: str, cand: Candidate, a: torch.Tensor, mesh=None):
    from repro_torch.core.lookahead import get_variant

    kw = {}
    if cand.mesh_shape is not None:
        if mesh is None:
            raise ValueError(f"candidate {cand.label()} needs the live mesh "
                             f"it was enumerated for")
        kw["mesh"] = mesh
    return get_variant(dmf, cand.variant)(
        a, cand.schedule, backend=get_backend(cand.backend), device=a.device,
        **kw)


def _measure(dmf: str, cand: Candidate, a: torch.Tensor, *,
             warmup: int, repeats: int, mesh=None) -> float:
    """Median seconds of one candidate, eager calls."""
    return _time_fn(lambda x: _run(dmf, cand, x, mesh), a, warmup=warmup,
                    repeats=repeats)


def _candidates(dmf: str, n: int, dtype, blocks: Sequence[int],
                variants: Optional[Sequence[str]],
                backends: Sequence[str]) -> list:
    from repro_torch.core.lookahead import get_variant

    variants = list(variants) if variants is not None \
        else [v for v in list_variants(dmf) if v != "tuned"]
    if "tuned" in variants:               # not a measurable variant
        warnings.warn("tune: dropping 'tuned' from the candidate variants")
        variants.remove("tuned")
    for v in [v for v in variants if parse_variant(v)[0] == "la_mb"]:
        # without a fused kernel la_mb is la: do not measure it twice.
        # (The reference also drops la_mb from float64 sweeps, its fused
        # kernels summing in float32; the port's are float64: kept.)
        if get_variant(dmf, "la_mb") is get_variant(dmf, "la"):
            variants.remove(v)
    out = []
    for be in backends:
        for v in variants:
            base, depth = parse_variant(v)
            for b in blocks:
                if b > n:
                    continue
                for s in {expand_schedule(n, b), tail_schedule(n, b)}:
                    # a depth-d window needs > d panels to differ from the
                    # shallower schedule
                    if depth > 1 and len(s) <= depth:
                        continue
                    # a deeper window pays only where some iteration is
                    # panel-bound; if the model sees no gain over depth 1
                    # the wall clock will not either
                    if depth > 1:
                        try:
                            if not (model.predict(dmf, n, dtype, v, s, be)
                                    < model.predict(dmf, n, dtype, base, s,
                                                    be)):
                                continue
                        except (KeyError, ValueError):
                            pass          # unmodeled DMF/schedule: measure
                    out.append(Candidate(
                        variant=v, schedule=s, backend=be,
                        tile=s[0] if base == "tiled" else None))
    return out


def _mesh_twins(dmf: str, chosen: Sequence[Candidate], mesh) -> list:
    """Block-cyclic twins of the ranked candidates (the device-layout axis):
    ``mtb``/``la``-family candidates with uniform schedules of the DMFs the
    mesh engine lowers.  Appended after ranking (as the baseline is), so a
    live mesh is always measured."""
    from repro_torch.core.distributed import (DIST_REGISTRY, axis_size,
                                              resolve_axis)

    if dmf not in DIST_REGISTRY:
        return []
    nd = axis_size(mesh, resolve_axis(mesh))
    twins = []
    for c in chosen:
        base, _ = parse_variant(c.variant)
        if base not in ("mtb", "la") or not is_uniform(c.schedule):
            continue
        if c.tile is not None:
            continue
        twin = dataclasses.replace(c, mesh_shape=(nd,))
        if twin not in twins and twin not in chosen:
            twins.append(twin)
    return twins


def _agree(timings: dict, mesh) -> dict:
    """The mesh's first rank's timings on every rank of the mesh."""
    from repro_torch.core.distributed import broadcast_object

    return dict(broadcast_object(mesh, list(timings.items())))


def _trace_candidates(dmf, n, dtype, a, timings, mesh=None) -> list:
    """One traced run per measured candidate (:class:`CandidateTrace`)."""
    from repro_torch.obs import report as obs_report
    from repro_torch.obs import tracer as obs_tracer

    out = []
    for cand, measured_s in timings.items():
        with obs_tracer.trace() as trc:
            _run(dmf, cand, a, mesh)
        try:
            predicted = model.predict(dmf, n, dtype, cand.variant,
                                      cand.schedule, cand.backend)
        except (KeyError, ValueError):
            predicted = None
        out.append(CandidateTrace(
            dmf=dmf, n=n, candidate=cand, measured_s=measured_s,
            predicted_s=predicted, spans=list(trc.spans),
            overlap=obs_report.overlap(trc.spans)))
    return out


def search(
    dmf: str,
    n: int,
    dtype=torch.float32,
    *,
    blocks: Sequence[int] = DEFAULT_BLOCKS,
    variants: Optional[Sequence[str]] = None,
    backends: Sequence[str] = ("cuda",),
    top_k: int = 3,
    warmup: int = 1,
    repeats: int = 3,
    cache: Optional[TuneCache] = None,
    force: bool = False,
    seed: int = 0,
    verbose: bool = False,
    trace_sink: Optional[list] = None,
    device=None,
    mesh=None,
) -> TuneConfig:
    """Tune ``dmf`` at size ``n`` on ``device`` (None = the GPU) and store
    the winner (module doc).

    Returns the cached entry at once (``from_cache=True``) unless the key
    is cold or ``force=True``.  The measured set always holds the fixed
    ``b = 128`` ``la`` baseline (``mtb`` for the DMFs without look-ahead),
    so ``result.seconds <= result.baseline_seconds`` on the device that ran
    the search.  ``trace_sink``: a list that receives one
    :class:`CandidateTrace` per measured candidate, recorded after the
    timed runs so they never perturb the stored numbers.  ``mesh``: a
    ``DeviceMesh`` whose every rank calls ``search`` alike; it adds the
    ``/d{nd}`` twins (module doc).
    """
    from repro_torch.core.lookahead import TUNABLE

    if mesh is not None:
        from repro_torch.core.distributed import check_mesh

        check_mesh(mesh)
    if dmf not in TUNABLE:
        raise ValueError(
            f"{dmf!r} is not tunable: its block size defines the output "
            f"(band reduction's w is the bandwidth), so candidates with "
            f"different blocks compute different results")
    dev = resolve_device(device)
    # `cache or default_cache()` would be wrong: an empty cache is falsy
    cache = cache if cache is not None else default_cache()
    keys = {be: cache_key(dmf, n, dtype, measured_on(be, dev))
            for be in backends}
    hits = {be: None if force else cache.get(keys[be]) for be in backends}
    cold = [be for be in backends if hits[be] is None]
    if not cold:
        return hits[backends[0]]

    a = _test_matrix(dmf, n, dtype, seed, dev)
    # rank and slice per backend: a pooled top-k would be taken by the
    # fastest-modeled backend
    chosen, baselines = [], {}
    base_variant = (BASELINE_VARIANT
                    if BASELINE_VARIANT in list_variants(dmf) else "mtb")
    for be in cold:
        mine = _candidates(dmf, n, dtype, blocks, variants, (be,))
        chosen += model.rank(dmf, n, dtype, mine)[: max(top_k, 1)]
        baselines[be] = Candidate(
            variant=base_variant,
            schedule=expand_schedule(n, min(BASELINE_BLOCK, n)), backend=be)
    chosen += [b for b in baselines.values() if b not in chosen]
    if mesh is not None:
        chosen += _mesh_twins(dmf, chosen, mesh)

    timings = {}
    for cand in chosen:
        try:
            timings[cand] = _measure(dmf, cand, a, warmup=warmup,
                                     repeats=repeats, mesh=mesh)
        except ValueError as e:
            # a schedule this DMF refuses; any other fault propagates
            warnings.warn(f"tune: skipped {cand.label()}: {e}")
            continue
        if verbose:
            print(f"tune: {cand.label()}: {timings[cand] * 1e3:.2f} ms")
    if not timings:
        raise RuntimeError(f"no tuning candidate succeeded for {dmf} n={n}")
    if mesh is not None:
        timings = _agree(timings, mesh)

    if trace_sink is not None:
        trace_sink.extend(_trace_candidates(dmf, n, dtype, a, timings,
                                            mesh=mesh))

    # one entry per cold backend: "tuned" dispatches on the caller's
    # backend, so each key records the best candidate measured on it
    for be in cold:
        mine = {c: t for c, t in timings.items() if c.backend == be}
        if not mine:
            continue
        best = min(mine, key=mine.get)
        hits[be] = TuneConfig(
            dmf=dmf, shape=(n, n), dtype=dtype_name(dtype),
            backend=measured_on(be, dev), variant=best.variant,
            schedule=best.schedule, depth=parse_variant(best.variant)[1],
            tile=best.tile, mesh_shape=best.mesh_shape, seconds=mine[best],
            baseline_seconds=mine.get(baselines[be], mine[best]))
        cache.put(keys[be], hits[be])
    return next(h for h in (hits[be] for be in backends) if h is not None)
