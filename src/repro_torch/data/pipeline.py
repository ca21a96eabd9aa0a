"""Deterministic, shardable, resumable data pipeline (NumPy only).

Design for 1000+ nodes (DESIGN.md §7): a batch is a *pure function* of
``(seed, step, shard_index)`` — no iterator state to checkpoint or lose.
Resume = seek: the trainer stores only the step counter.  Each data-parallel
host generates exactly its shard; no host ever materializes the global batch.

Two sources:
* :class:`SyntheticTask` — structured pseudo-language (affine next-token map
  with noise) so optimization progress is measurable in examples/tests.
* :class:`TokenFileSource` — memory-mapped token corpus (``.bin`` of uint16/
  uint32), strided deterministically.

The port of :mod:`repro.data.pipeline`, copied: it is NumPy only, so the
port's batches are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    """next_tok = (a·tok + b) mod V with probability (1−noise), else uniform."""

    vocab_size: int
    seq_len: int
    a: int = 31
    b: int = 17
    noise: float = 0.1
    seed: int = 0

    def batch(self, step: int, shard: int, num_shards: int,
              per_shard_batch: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        b, s, v = per_shard_batch, self.seq_len, self.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise_mask = rng.random((b, s)) < self.noise
        noise_toks = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = (toks[:, t] * self.a + self.b) % v
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_toks[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class TokenFileSource:
    """Memory-mapped token corpus; deterministic strided sampling."""

    path: str
    vocab_size: int
    seq_len: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch(self, step: int, shard: int, num_shards: int,
              per_shard_batch: int) -> dict:
        n = len(self._data) - self.seq_len - 1
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        starts = rng.integers(0, n, per_shard_batch)
        toks = np.stack([np.asarray(self._data[i : i + self.seq_len + 1],
                                    np.int32) for i in starts])
        return {"tokens": toks[:, :-1] % self.vocab_size,
                "labels": toks[:, 1:] % self.vocab_size}


def make_source(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticTask(**kw)
    if kind == "file":
        return TokenFileSource(**kw)
    raise ValueError(kind)
