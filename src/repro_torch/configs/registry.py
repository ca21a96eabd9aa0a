"""Architecture registry of the port: ``--arch <id>`` resolution and the
smoke-test preset.

The port of :mod:`repro.configs.registry` for the archs the port runs.
``get_config`` of an arch the reference has but the port does not raises
``KeyError`` naming the ROADMAP item that ports it.  ``reduced_config`` is
the reference's smoke preset, copied.  The reference's ``input_specs`` and
``cache_specs`` (JAX shape stand-ins for its dry-run) have no counterpart.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

#: The archs the port runs: the dense decoder (served through the flash
#: attention kernel) and RWKV6 (its prefill through the WKV6 kernel).
ARCH_IDS = ("phi3-medium-14b", "rwkv6-7b")

#: The reference's other archs, with what ports them.
NOT_PORTED = {
    "chameleon-34b": "ROADMAP Queue 1 item 18 (model stack)",
    "qwen2-72b": "ROADMAP Queue 1 item 18 (model stack)",
    "qwen1.5-32b": "ROADMAP Queue 1 item 18 (model stack)",
    "gemma-7b": "ROADMAP Queue 1 item 18 (model stack)",
    "llama4-scout-17b-a16e": "ROADMAP Queue 1 item 18 (model stack, MoE)",
    "deepseek-moe-16b": "ROADMAP Queue 1 item 18 (model stack, MoE)",
    "whisper-small": "ROADMAP Queue 1 item 18 (model stack, enc-dec)",
    "recurrentgemma-9b": "ROADMAP Queue 1 item 18 (model stack, RG-LRU)",
}

_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: "
                       f"{NOT_PORTED[arch]}; the port has {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family preset for CPU smoke tests."""
    kv_ratio = cfg.num_kv_heads / cfg.num_heads
    heads = 4
    kv = max(1, int(heads * kv_ratio))
    changes = dict(
        num_layers=max(len(cfg.pattern) + len(cfg.pattern_tail),
                       2 if cfg.moe is None or not cfg.moe.first_dense_layers
                       else cfg.moe.first_dense_layers + len(cfg.pattern)),
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_chunk_q=64,
        attn_chunk_k=64,
        rwkv_chunk=16,
        dtype="float32",
        remat=False,
    )
    if cfg.local_window:
        changes["local_window"] = 32
    if cfg.d_rnn:
        changes["d_rnn"] = 128
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
        changes["num_layers"] = 2
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
        )
    if cfg.family == "ssm":
        changes["num_heads"] = 4       # head_dim = 128/4 = 32
        changes["num_kv_heads"] = 4
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
