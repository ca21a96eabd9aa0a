"""Persistent tuning cache: JSON on disk, an in-memory LRU in front.

The port of :mod:`repro.tune.cache`.  One entry per
``backend@device:dmf:MxN:dtype`` key holding the winning
:class:`TuneConfig`.  The JSON schema of an entry is the reference's, so
each package reads the other's entries; a field left unset
(``kernel_blocks``, ``tile``, ``mesh_shape``) is dropped from the JSON.

The backend field of a key, and ``TuneConfig.backend``, carry the device
type of the measurement beside the backend's name (:func:`measured_on`):
``"cuda@cuda"`` is the kernels on the GPU, ``"cuda@cpu"`` the same
backend running its kernels' plain versions on CPU tensors.  A winner
measured on the CPU so never serves a call on the GPU.

The file is ``$REPRO_TORCH_TUNE_CACHE`` if set, else
``~/.cache/repro_torch/tune.json``: the port's entries never share a file
with the reference's.  Writes are atomic (a rename) under an ``fcntl``
lock; a lookup only reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from collections import OrderedDict
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["TuneConfig", "TuneCache", "cache_key", "default_cache",
           "set_default_cache", "tuned", "measured_on", "dtype_name"]

ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_PATH = Path("~/.cache/repro_torch/tune.json")

ShapeLike = Union[int, Tuple[int, ...]]


def _norm_shape(shape: ShapeLike) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (shape, shape)
    return tuple(int(s) for s in shape)


def dtype_name(dtype) -> str:
    """Canonical name of a torch, NumPy or string dtype (``"float64"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return dtype
    return np.dtype(dtype).name


def measured_on(backend: str, device) -> str:
    """The key's backend field: the backend's name and the type of the
    device the measurement ran on, ``"cuda@cpu"``."""
    return f"{backend}@{torch.device(device).type}"


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """The winner of one search: everything ``"tuned"`` dispatch needs."""

    dmf: str
    shape: Tuple[int, ...]
    dtype: str                       # canonical name, e.g. "float32"
    backend: str                     # measured_on(): "cuda@cuda", ...
    variant: str                     # concrete (never "tuned"); "la2" ok
    schedule: Tuple[int, ...]        # per-iteration block widths
    seconds: float                   # measured wall clock of the winner
    baseline_seconds: float          # measured fixed-b baseline
    depth: int = 1                   # look-ahead depth of the winner
    #: the reference's kernel-blocking axis (BLIS (bm, bn, bk)); the port
    #: never sets it, and ``"tuned"`` refuses an entry that has it
    kernel_blocks: Optional[Tuple[int, int, int]] = None
    #: tile size of a ``variant="tiled"`` winner, None otherwise
    tile: Optional[int] = None
    #: device layout of a mesh-measured winner, ``(nd,)`` for the mesh
    #: engine's 1-D column cycle (``search(mesh=...)``), None for a
    #: single-device winner; ``"tuned"`` runs a winner on the mesh the
    #: caller passes, and refuses a mesh winner whose cycle has another size
    mesh_shape: Optional[Tuple[int, ...]] = None
    from_cache: bool = False         # True when returned without measuring

    def __post_init__(self):
        if self.variant == "tuned":
            raise ValueError("a TuneConfig must record a concrete variant")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("from_cache")
        d["shape"] = list(self.shape)
        d["schedule"] = list(self.schedule)
        if self.kernel_blocks is None:
            d.pop("kernel_blocks")
        else:
            d["kernel_blocks"] = list(self.kernel_blocks)
        if self.tile is None:
            d.pop("tile")
        if self.mesh_shape is None:
            d.pop("mesh_shape")
        else:
            d["mesh_shape"] = list(self.mesh_shape)
        return d

    @classmethod
    def from_json(cls, d: dict, *, from_cache: bool = False) -> "TuneConfig":
        # an entry without "depth" takes it from the variant's name; keys
        # this reader does not know are dropped
        from repro_torch.core.lookahead import parse_variant

        depth = d.get("depth", None)
        if depth is None:
            depth = parse_variant(d["variant"])[1]
        kb = d.get("kernel_blocks")
        tile = d.get("tile")
        ms = d.get("mesh_shape")
        return cls(dmf=d["dmf"], shape=tuple(d["shape"]), dtype=d["dtype"],
                   backend=d["backend"], variant=d["variant"],
                   schedule=tuple(d["schedule"]), seconds=d["seconds"],
                   baseline_seconds=d["baseline_seconds"],
                   depth=int(depth),
                   kernel_blocks=tuple(kb) if kb else None,
                   tile=int(tile) if tile else None,
                   mesh_shape=tuple(ms) if ms else None,
                   from_cache=from_cache)


def cache_key(dmf: str, shape: ShapeLike, dtype, backend: str,
              digest: Optional[str] = None) -> str:
    """``backend:dmf:MxN:dtype[:digest]``, the reference's key format;
    ``backend`` is the :func:`measured_on` field (``"cuda@cuda"``).

    ``digest`` tells apart entries that share a configuration but not the
    content (a hash of the factored operand, for a factor cache).
    """
    m, n = (_norm_shape(shape) + (0, 0))[:2]
    base = f"{backend}:{dmf}:{m}x{n}:{dtype_name(dtype)}"
    return f"{base}:{digest}" if digest else base


class TuneCache:
    """Write-through JSON store with an LRU front (newest at the end)."""

    #: LRU sentinel for a key known to be absent on disk, so a cold-cache
    #: ``tuned()`` dispatch does not re-parse the JSON on every call.
    _MISS = object()

    def __init__(self, path: Optional[Union[str, Path]] = None,
                 lru_size: int = 64):
        env = os.environ.get(ENV_VAR)
        self.path = Path(path or env or _DEFAULT_PATH).expanduser()
        self.lru_size = lru_size
        self._lru: "OrderedDict[str, object]" = OrderedDict()
        self._lru_stamp = self._file_stamp()

    def _file_stamp(self):
        """(mtime_ns, size) of the JSON file; None when absent."""
        try:
            st = os.stat(self.path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _read_disk(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_disk(self, data: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)               # atomic on POSIX
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive advisory lock, so that concurrent :meth:`put` calls do
        not drop each other's entries (the rename alone keeps the file
        whole, not both writes)."""
        try:
            import fcntl
        except ImportError:                          # non-POSIX: no locking
            yield
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path.with_suffix(self.path.suffix + ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def get(self, key: str) -> Optional[TuneConfig]:
        # the LRU memoizes an unchanged file; another process's write drops
        # the memo, so tune-then-serve across processes sees new entries
        stamp = self._file_stamp()
        if stamp != self._lru_stamp:
            self._lru.clear()
            self._lru_stamp = stamp
        if key in self._lru:
            self._lru.move_to_end(key)
            hit = self._lru[key]
            return None if hit is self._MISS else hit
        entry = self._read_disk().get(key)
        if entry is not None:
            try:
                cfg = TuneConfig.from_json(entry, from_cache=True)
            except (KeyError, TypeError, ValueError):
                entry = None        # a malformed entry is a miss, not a crash
        if entry is None:
            self._remember(key, self._MISS)
            return None
        self._remember(key, cfg)
        return cfg

    def put(self, key: str, cfg: TuneConfig) -> None:
        with self._locked():
            data = self._read_disk()
            data[key] = cfg.to_json()
            self._write_disk(data)
            # stamped inside the lock: a later writer's file must not be
            # masked by this process's memo
            stamp = self._file_stamp()
        self._lru.clear()
        self._lru_stamp = stamp
        self._remember(key, dataclasses.replace(cfg, from_cache=True))

    def _remember(self, key: str, cfg) -> None:
        self._lru[key] = cfg
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)

    def clear(self) -> None:
        self._lru.clear()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._lru_stamp = None

    def __len__(self) -> int:
        return len(self._read_disk())


_DEFAULT: Optional[TuneCache] = None


def default_cache() -> TuneCache:
    """The process-wide cache (``$REPRO_TORCH_TUNE_CACHE`` at first use)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = TuneCache()
    return _DEFAULT


def set_default_cache(cache: Optional[TuneCache]) -> Optional[TuneCache]:
    """Swap the process-wide cache; returns the old one."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, cache
    return old


def tuned(dmf: str, shape: ShapeLike, *, dtype=torch.float32,
          backend: str = "cuda", device="cuda",
          cache: Optional[TuneCache] = None) -> Optional[TuneConfig]:
    """The cached winner for ``(dmf, shape, dtype)`` measured with
    ``backend`` on ``device``'s type, or None when cold.

    The read-only hook behind ``get_variant(dmf, "tuned")``: it never
    measures; :func:`repro_torch.tune.sweep.search` fills the cache.
    """
    cache = cache if cache is not None else default_cache()
    return cache.get(cache_key(dmf, shape, dtype,
                               measured_on(backend, device)))
