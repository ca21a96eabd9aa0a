"""Atomic checkpointing of trees of tensors (no pickle, no external deps).

The port of :mod:`repro.train.checkpoint`, with its layout and guarantees:

* Layout: ``<dir>/step_<N:08d>/arrays.npz`` + ``manifest.json``; the
  arrays keyed by their path in the tree (:mod:`repro_torch.tree`).
* **Atomic**: written to ``<dir>/.tmp_<N>`` and ``os.rename``d — a reader
  never sees a half-written checkpoint; an interrupted save leaves only a
  tmp dir that the next save sweeps away; the ``keep`` newest stay.
* **Resumable data**: the manifest carries the step and any extra JSON
  state (data cursor, loss); the data pipeline is a pure function of the
  step, so that is all a resume needs.

NumPy has no bfloat16: a bfloat16 leaf is stored as its ``uint16`` bits,
and the manifest records every leaf's dtype (``dtypes``), so a restore
gives back the same bits.  Arrays are the leaves' full values, gathered to
the host; restoring onto a mesh of another shape waits for the mesh
trainer (``fault_tolerance.elastic_reshard``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

__all__ = ["save_checkpoint", "list_checkpoints", "latest_checkpoint",
           "restore_checkpoint"]


def _to_numpy(t) -> tuple:
    """(array, dtype name) of a leaf; bfloat16 as its uint16 bits."""
    t = torch.as_tensor(t).detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(directory: str, step: int, state,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in flatten_with_paths(state):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "dtypes": dtypes,
                "extra": extra or {}, "format": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomicity boundary
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int):
    steps = list_checkpoints(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    for d in os.listdir(directory):            # sweep stale tmp dirs
        if d.startswith(".tmp_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def list_checkpoints(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[str]:
    steps = list_checkpoints(directory)
    if not steps:
        return None
    return os.path.join(directory, f"step_{steps[-1]:08d}")


def restore_checkpoint(path: str, template, device=None):
    """Restore into the structure of ``template``: each leaf in the
    template leaf's dtype, on ``device`` (the template leaf's device when
    None).  Returns (tree, manifest); raises ``KeyError`` when the
    checkpoint lacks a leaf of the template."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in flatten_with_paths(template):
            if key not in data:
                raise KeyError(f"checkpoint {path} has no leaf {key!r}")
            arr = data[key]
            t = _from_numpy(arr, dtypes.get(key, str(arr.dtype)))
            like = torch.as_tensor(leaf)
            new_leaves.append(t.to(device=device or like.device,
                                   dtype=like.dtype))
    return unflatten(template, new_leaves), manifest
