"""Autotuning and block schedules: the port of :mod:`repro.tune`.

The paper fixes its block size by hand (b = 192, §6.1) and shrinks it on
the fly by early termination (§5).  This package replaces both with a
model-seeded empirical search per ``(dmf, n, dtype, backend, device)``:

* :func:`search` — sweep variant × look-ahead depth × block size ×
  uniform/tail schedule, pruned by the cost model (:mod:`.model`, the
  H100's constants), measured on the device, stored in the cache
  (:mod:`.sweep`);
* :func:`tuned` — the read-only lookup behind ``get_variant(dmf,
  "tuned")`` and ``variant="tuned"`` in :mod:`repro_torch.solve`;
* :class:`TuneCache` / :class:`TuneConfig` — the JSON record with an LRU
  front, in the reference's schema (:mod:`.cache`);
* :func:`tail_schedule` — decreasing-``b`` schedules (:mod:`.schedule`).

The reference's ``repro.tune.search`` module is a deprecation alias of
its ``sweep`` module for a name the port never had; it is not ported.
"""
from repro_torch.tune import model
from repro_torch.tune.cache import (TuneCache, TuneConfig, cache_key,
                                    default_cache, measured_on,
                                    set_default_cache, tuned)
from repro_torch.tune.schedule import is_uniform, tail_schedule, \
    uniform_schedule
from repro_torch.tune.sweep import (BASELINE_BLOCK, BASELINE_VARIANT,
                                    DEFAULT_BLOCKS, Candidate, search)

__all__ = [
    "model",
    "TuneCache",
    "TuneConfig",
    "cache_key",
    "measured_on",
    "default_cache",
    "set_default_cache",
    "tuned",
    "is_uniform",
    "tail_schedule",
    "uniform_schedule",
    "Candidate",
    "search",
    "DEFAULT_BLOCKS",
    "BASELINE_BLOCK",
    "BASELINE_VARIANT",
]
