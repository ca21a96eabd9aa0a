"""Weights of the port: seeded random init, and the carrier to and from the
reference's param pytree.

The port's params keep the reference's tree and layouts (``embed/tok``,
``embed/unembed``, ``final_norm``, ``seg<i>/p<j>/attn/wq`` of shape
``(L, d, h·hd)`` with the segment's layers stacked first, ...), so a
tree of NumPy arrays taken from the reference (``jax.tree.map(np.asarray,
params)``) carries across leaf by leaf.  bfloat16 arrays (NumPy's
``ml_dtypes`` type) carry their bits; :func:`params_to_numpy` returns
bfloat16 leaves as float32, since NumPy has no bfloat16 of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

__all__ = ["init_params", "params_from_numpy", "params_to_numpy"]


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random weights on ``device`` (the GPU by default) from a
    ``torch.Generator`` seeded with ``seed``: the reference's truncated
    normals and scales (``repro/models/layers.py``), the port's own bits."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return T.init_params(cfg, gen, device)


def _leaf(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, params_np: dict, device=None):
    """The reference's param tree (NumPy leaves) as the port's params, in
    ``cfg.dtype`` on ``device``; raises ``ValueError`` on a missing or
    extra key or a shape that differs from the config's."""
    device = resolve_device(device)
    dtype = T.dtype_of(cfg)

    def walk(spec, tree, path):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            have = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: keys {have}, expected "
                             f"{sorted(spec)}")
        out = {}
        for name, leaf in spec.items():
            where = f"{path}/{name}"
            if isinstance(leaf, dict):
                out[name] = walk(leaf, tree[name], where)
                continue
            shape = tuple(np.shape(tree[name]))
            if shape != tuple(leaf[0]):
                raise ValueError(f"params{where}: shape {shape}, expected "
                                 f"{tuple(leaf[0])}")
            out[name] = _leaf(tree[name], dtype, device)
        return out

    return walk(T.param_spec(cfg), params_np, "")


def params_to_numpy(params: dict) -> dict:
    """The inverse: the port's params as a tree of NumPy arrays (bfloat16
    leaves as float32)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[name] = t.numpy()
    return out
