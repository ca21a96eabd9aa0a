"""Fault-tolerance runtime pieces.

The port of :mod:`repro.train.fault_tolerance`:

* :class:`StragglerWatchdog` — per-step timing; flags a step slower than
  ``factor`` × the running median of the steps before it (after
  ``warmup`` steps), so the trainer can checkpoint early and a reschedule
  loses bounded work.  Its clock is a function it is handed
  (``time.perf_counter`` by default), so a test can drive it without
  sleeping.
* :class:`PreemptionHandler` — SIGTERM → "checkpoint and exit at the next
  step boundary" (the standard preemption contract on managed clusters).
* :func:`elastic_reshard` — restoring onto a mesh of another shape waits
  for the mesh trainer (ROADMAP Queue 1 item 18) and raises.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, Optional

__all__ = ["StragglerWatchdog", "PreemptionHandler", "elastic_reshard"]


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 window: int = 50,
                 clock: Callable[[], float] = time.perf_counter):
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self.clock = clock
        self.times: list[float] = []
        self.flags = 0
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self) -> bool:
        """Returns True if this step looked like a straggler event."""
        dt = self.clock() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) <= self.warmup:
            return False
        med = statistics.median(self.times[:-1])
        if dt > self.factor * med:
            self.flags += 1
            return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class PreemptionHandler:
    """Installs a SIGTERM handler that sets a flag instead of dying."""

    def __init__(self):
        self.requested = False
        self._installed = False

    def install(self):
        if self._installed:
            return

        def handler(signum, frame):
            self.requested = True

        signal.signal(signal.SIGTERM, handler)
        self._installed = True

    def should_stop(self) -> bool:
        return self.requested


def elastic_reshard(ckpt_path: str, template, shardings):
    """Restore a checkpoint onto a mesh of another shape: not ported yet."""
    raise NotImplementedError(
        "elastic_reshard is not ported yet: resharding waits for the mesh "
        "trainer (ROADMAP Queue 1 item 18); restore_checkpoint restores "
        "onto one device")
