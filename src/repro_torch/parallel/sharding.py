"""Sharding rules: logical axis names → mesh dimensions.

The port of the part of :mod:`repro.parallel.sharding` that
:func:`repro_torch.core.distributed.resolve_axis` reads: the :class:`Rules`
table, :func:`default_rules` with its ``"panels" → "model"`` entry, and the
:func:`use_rules` / :func:`active_rules` context.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions.

``panels`` → ``"model"`` is the DMF engine's 1-D column block-cyclic
dimension: ``pipeline.factorize(mesh=...)`` resolves its layout through the
active rules' ``"panels"`` entry, so model code and the factorization
layer agree on which mesh dimension carries tensor parallelism.  The
rules' activation annotations (``shard``, ``param_sharding``) come with the
model and train stack's mesh path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence, Union

__all__ = ["Rules", "default_rules", "use_rules", "active_rules"]

MeshAxes = Union[str, Sequence[str], None]


@dataclasses.dataclass(frozen=True)
class Rules:
    """A mesh and the table from logical axis names to its dimensions."""

    mesh: Any
    table: Mapping[str, MeshAxes]


def default_rules(mesh, *, seq_shard: bool = True) -> Rules:
    """The standard FSDP(data[, pod]) × TP(model) layout."""
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(ax for ax in ("pod", "data") if ax in names)
    table = {
        "batch": dp,
        "embed": "data" if "data" in names else None,
        "act_embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "seq": "model" if seq_shard else None,
        "qkv": None,
        "layers": None,
        "conv": None,
        "state": "model",
        "panels": "model",
    }
    return Rules(mesh=mesh, table=table)


_ACTIVE = threading.local()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Install ``rules`` for the dynamic extent of the block (per thread)."""
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        yield rules
    finally:
        _ACTIVE.rules = prev


def active_rules() -> Optional[Rules]:
    return getattr(_ACTIVE, "rules", None)
