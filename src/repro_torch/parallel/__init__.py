"""Parallel layout: logical axis names to mesh dimensions (the part of
:mod:`repro.parallel` the distributed engine reads)."""
from repro_torch.parallel.sharding import (Rules, active_rules, default_rules,
                                           use_rules)

__all__ = ["Rules", "default_rules", "use_rules", "active_rules"]
