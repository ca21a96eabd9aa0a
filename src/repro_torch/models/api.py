"""Model API of the port: one surface for the archs it runs (the dense
decoder and RWKV6).

The port of :mod:`repro.models.api` for serving:

* ``init_params(cfg, seed, device=None)`` → params (seeded random weights)
* ``init_decode_cache(cfg, batch, max_len, device=None)``
* ``prefill(cfg, params, batch, max_len)`` → (last-token logits, cache)
* ``decode_step(cfg, params, cache, tokens, pos)`` → (logits, cache)
* ``apply(cfg, params, batch)`` → logits of a full sequence (no gradient)

``batch`` is ``{"tokens": (B, S) int}`` (a tensor or a NumPy array); the
work runs on the params' device.  Logits are float32.  Every call runs
under ``torch.no_grad`` with the library products at full precision
(:func:`repro_torch.core.backend.no_tf32`).  Enc-dec archs raise
``NotImplementedError``; ``loss_fn`` and ``apply_train`` come with the
training slice (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import no_tf32
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.models import transformer as T

__all__ = ["init_params", "init_decode_cache", "prefill", "decode_step",
           "apply", "device_of"]

_ENC_DEC_TODO = ("encoder-decoder archs are not ported yet "
                 "(ROADMAP Queue 1 item 18)")


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_enc_dec:
        raise NotImplementedError(_ENC_DEC_TODO)


def device_of(params) -> torch.device:
    return params["embed"]["tok"].device


def _tokens(tokens, device) -> torch.Tensor:
    t = tokens if isinstance(tokens, torch.Tensor) else torch.as_tensor(tokens)
    if t.dim() != 2:
        raise ValueError(f"tokens must be (B, S), got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.long)


def init_params(cfg: ModelConfig, seed: int, device=None):
    _decoder_only(cfg)
    return convert.init_params(cfg, seed, device)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None):
    _decoder_only(cfg)
    return T.init_cache(cfg, batch, max_len, resolve_device(device))


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Build the cache from a prompt; returns (last-token logits (B, 1, V),
    cache).  Only the last position is unembedded: the same rows as the
    reference's slice of its full logits."""
    _decoder_only(cfg)
    no_tf32()
    device = device_of(params)
    tokens = _tokens(batch["tokens"], device)
    if tokens.shape[1] > max_len:
        raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds the "
                         f"cache length {max_len}")
    cache = T.init_cache(cfg, tokens.shape[0], max_len, device)
    logits, cache = T.forward(cfg, params, tokens, cache=cache,
                              mode="prefill", last_only=True)
    return logits, cache


def _cache_length(cache):
    """The slot count of the first cache with position slots; None when no
    layer has any (an RWKV cache holds O(1) state, with no length)."""
    for seg in cache.values():
        for layer in seg.values():
            if "pos" in layer:
                return layer["pos"].shape[-1]
    return None


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One new token per sequence.  tokens: (B, 1); pos: its position.
    Writes the token's keys and values (or, for RWKV, the new state) into
    ``cache`` in place."""
    _decoder_only(cfg)
    no_tf32()
    device = device_of(params)
    tokens = _tokens(tokens, device)
    pos = int(pos)
    max_len = _cache_length(cache)
    if pos < 0 or (max_len is not None and pos >= max_len):
        raise ValueError(f"position {pos} outside the cache (length "
                         f"{max_len})")
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=device)
    return T.forward(cfg, params, tokens, positions=positions, cache=cache,
                     mode="decode")


@torch.no_grad()
def apply(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) of a full sequence."""
    _decoder_only(cfg)
    no_tf32()
    tokens = _tokens(batch["tokens"], device_of(params))
    logits, _ = T.forward(cfg, params, tokens, mode="train")
    return logits
