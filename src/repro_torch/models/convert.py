"""Weights of the port: seeded random init, and the carrier to and from the
reference's param pytree.

The port's params keep the reference's tree and layouts (``embed/tok``,
``embed/unembed``, ``final_norm``, ``seg<i>/p<j>/attn/wq`` of shape
``(L, d, h·hd)`` with the segment's layers stacked first, ...), so a
tree of NumPy arrays taken from the reference (``jax.tree.map(np.asarray,
params)``) carries across leaf by leaf.  bfloat16 arrays (NumPy's
``ml_dtypes`` type) carry their bits; :func:`params_to_numpy` returns
bfloat16 leaves as float32, since NumPy has no bfloat16 of its own.  A leaf
whose spec names its own dtype (RWKV's float32 ``w0``, ``wa``, ``wb``,
``u`` in a bfloat16 model) keeps it both ways.

A train state carries across the same way
(:func:`train_state_from_numpy`, :func:`train_state_to_numpy`): the
reference's ``TrainState`` with NumPy leaves — the params, the AdamW or
DMF-Shampoo state (its float32 moments, statistics and roots) and the
compression residual — as the port's, so both packages can start from one
state in the middle of training.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

__all__ = ["init_params", "params_from_numpy", "params_to_numpy",
           "train_state_from_numpy", "train_state_to_numpy"]


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random weights on ``device`` (the GPU by default) from a
    ``torch.Generator`` seeded with ``seed``: the reference's truncated
    normals and scales (``repro/models/layers.py``), the port's own bits."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return T.init_params(cfg, gen, device)


def _leaf(arr, dtype, device) -> torch.Tensor:
    """A tensor of ``arr`` on ``device`` in ``dtype`` (its own when
    None)."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(cfg: ModelConfig, params_np: dict, device=None):
    """The reference's param tree (NumPy leaves) as the port's params on
    ``device``, each in its spec's dtype (``cfg.dtype`` unless the spec
    names another); raises ``ValueError`` on a missing or
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
            out[name] = _leaf(tree[name], L.leaf_dtype(leaf, dtype), device)
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


def _opt_state_class(opt):
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.shampoo import ShampooState
    fields = tuple(getattr(opt, "_fields", ()))
    for cls in (AdamWState, ShampooState):
        if fields == cls._fields:
            return cls
    raise ValueError(f"optimizer state with fields {fields}: expected "
                     f"AdamWState {AdamWState._fields} or ShampooState "
                     f"{ShampooState._fields}")


def train_state_from_numpy(cfg: ModelConfig, state, device=None):
    """The reference's ``TrainState`` with NumPy leaves
    (``jax.tree.map(np.asarray, state)``; any NamedTuple with the fields
    ``step, params, opt_state, residual``) as the port's
    :class:`repro_torch.train.trainer.TrainState` on ``device``: the params
    by :func:`params_from_numpy`, every other leaf in its own dtype (the
    optimizer's float32 moments, statistics and roots, its int32 step)."""
    from repro_torch.train.trainer import TrainState
    device = resolve_device(device)
    leaf = lambda a: _leaf(a, None, device)
    opt = state.opt_state
    return TrainState(
        step=leaf(state.step),
        params=params_from_numpy(cfg, state.params, device),
        opt_state=_opt_state_class(opt)(*(tree_map(leaf, x) for x in opt)),
        residual=tree_map(leaf, state.residual))


def train_state_to_numpy(state):
    """The inverse: the port's train state as the same NamedTuples with
    NumPy leaves (bfloat16 leaves as float32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, state)
