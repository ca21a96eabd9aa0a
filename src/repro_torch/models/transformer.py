"""Decoder backbone: dense attention and RWKV6 blocks, segment loops, the
caches.

The port of :mod:`repro.models.transformer` for dense attention blocks and
RWKV6 blocks.
Layers are grouped into :class:`repro_torch.configs.base.Segment` runs of
identical structure; each segment's params are stacked on a leading layer
axis, as in the reference, and a Python loop walks the layers (the
reference's ``lax.scan``).  Nothing here takes a gradient, so there is no
remat.

Cache model (decode), stacked per segment like the params:

* ``attn`` — a dense KV cache ``(B, G, W, hd)`` ×2 and per-slot positions
  ``(B, W)``, ``-1`` where unfilled;
* ``rwkv`` — the WKV matrix state ``s (B, H, dk, dk)`` in float32 and the
  token-shift tails ``x_tm``, ``x_cm (B, 1, d)``: O(1) state, no length.

Where the reference returns a new cache, the port writes the new keys and
values, or the new state, into the cache's tensors in place and returns
the same dict.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``local`` blocks and the ring cache, ``rg`` (RG-LRU), and MoE MLPs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment, layer_plan
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RWKV

__all__ = ["dtype_of", "layer_param_spec", "param_spec", "init_layer",
           "init_params", "init_layer_cache", "init_cache", "layer_forward",
           "forward"]

_TODO = {
    "local": "local (sliding-window) attention and its ring cache: "
             "ROADMAP Queue 1 item 18",
    "rg": "RG-LRU blocks: ROADMAP Queue 1 item 18",
    "moe": "MoE MLPs: ROADMAP Queue 1 item 18",
}


def _unported(what: str):
    return NotImplementedError(f"not ported yet — {_TODO[what]}")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_spec(spec: LayerSpec) -> None:
    if spec.block not in ("attn", "rwkv"):
        raise _unported(spec.block if spec.block in _TODO else "rg")
    if spec.mlp == "moe":
        raise _unported("moe")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def layer_param_spec(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Shapes and initialisers of one layer's params (``(shape, init[,
    dtype])`` leaves, see :func:`repro_torch.models.layers.materialize`)."""
    _check_spec(spec)
    if spec.block == "rwkv":     # LayerSpec("rwkv", "none"): all in the block
        return {"rwkv": RWKV.rwkv_spec(cfg)}
    p = {"norm1": L.norm_spec(cfg), "attn": L.attention_spec(cfg)}
    if spec.mlp == "dense":
        p["norm2"] = L.norm_spec(cfg)
        p["mlp"] = L.mlp_spec(cfg)
    return p


def param_spec(cfg: ModelConfig) -> dict:
    """The whole model's spec in the reference's tree: ``embed``,
    ``final_norm`` and ``seg<i>/p<j>`` with the segment's repeats as a
    leading dim (the reference stacks a segment of one repeat without it)."""
    out = {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg)}
    for si, seg in enumerate(layer_plan(cfg)):
        lead = () if seg.repeats == 1 else (seg.repeats,)
        out[f"seg{si}"] = {
            f"p{pi}": _stack(layer_param_spec(cfg, spec), lead)
            for pi, spec in enumerate(seg.pattern)}
    return out


def _stack(spec, lead):
    if isinstance(spec, dict):
        return {k: _stack(v, lead) for k, v in spec.items()}
    return (tuple(lead) + tuple(spec[0]),) + tuple(spec[1:])


def init_layer(cfg: ModelConfig, spec: LayerSpec, generator, device,
               lead=()):
    return L.materialize(layer_param_spec(cfg, spec), dtype_of(cfg), device,
                         generator, lead)


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random params, segment-stacked, on ``device``: in ``cfg.dtype``
    except the leaves whose spec names their own dtype."""
    return L.materialize(param_spec(cfg), dtype_of(cfg), device, generator)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device, lead=()):
    _check_spec(spec)
    lead = tuple(lead)
    if spec.block == "rwkv":
        h = cfg.num_heads
        dk = cfg.d_model // h
        tail = lead + (batch, 1, cfg.d_model)
        return {"s": torch.zeros(lead + (batch, h, dk, dk),
                                 dtype=torch.float32, device=device),
                "x_tm": torch.zeros(tail, dtype=dtype_of(cfg), device=device),
                "x_cm": torch.zeros(tail, dtype=dtype_of(cfg), device=device)}
    g, hd = cfg.num_kv_heads, cfg.head_dim
    kv = lead + (batch, g, max_len, hd)
    return {
        "k": torch.zeros(kv, dtype=dtype_of(cfg), device=device),
        "v": torch.zeros(kv, dtype=dtype_of(cfg), device=device),
        "pos": torch.full(lead + (batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    cache = {}
    for si, seg in enumerate(layer_plan(cfg)):
        lead = () if seg.repeats == 1 else (seg.repeats,)
        cache[f"seg{si}"] = {
            f"c{pi}": init_layer_cache(cfg, spec, batch, max_len, device,
                                       lead)
            for pi, spec in enumerate(seg.pattern)}
    return cache


# ---------------------------------------------------------------------------
# Per-layer forward (train / prefill / decode)
# ---------------------------------------------------------------------------
def _attn_train(cfg, spec, p, x, positions):
    h = L.apply_norm(cfg, x, p["norm1"])
    q, k, v = L.attention_qkv(cfg, p["attn"], h, positions)
    ctx = L.chunked_attention(q, k, v, positions[0], positions[0],
                              causal=True, chunk_q=cfg.attn_chunk_q,
                              chunk_k=cfg.attn_chunk_k)
    return x + L.attention_out(cfg, p["attn"], ctx)


def _cache_store(cache, k_new, v_new, positions, *, ring: bool):
    """Write S new kv pairs at their slots, in place.  k_new: (B,G,S,hd).

    The non-ring slots are the positions themselves (the reference writes
    at ``positions[0, 0]`` onwards); the caller keeps them below the
    cache's length.
    """
    if ring:
        raise _unported("local")
    slots = positions[0].long()
    cache["k"].index_copy_(2, slots, k_new)
    cache["v"].index_copy_(2, slots, v_new)
    cache["pos"].index_copy_(1, slots, positions.to(torch.int32))
    return cache


def _attn_prefill(cfg, spec, p, x, positions, cache):
    h = L.apply_norm(cfg, x, p["norm1"])
    q, k, v = L.attention_qkv(cfg, p["attn"], h, positions)
    ctx = L.chunked_attention(q, k, v, positions[0], positions[0],
                              causal=True, chunk_q=cfg.attn_chunk_q,
                              chunk_k=cfg.attn_chunk_k)
    cache = _cache_store(cache, k, v, positions, ring=False)
    return x + L.attention_out(cfg, p["attn"], ctx), cache


def _attn_decode(cfg, spec, p, x, positions, cache):
    h = L.apply_norm(cfg, x, p["norm1"])
    q, k_new, v_new = L.attention_qkv(cfg, p["attn"], h, positions)
    cache = _cache_store(cache, k_new, v_new, positions, ring=False)
    ctx = L.decode_attention(q, cache["k"], cache["v"], cache["pos"],
                             positions[:, 0])
    return x + L.attention_out(cfg, p["attn"], ctx), cache


def _rwkv(cfg, p, x, cache, mode):
    """The RWKV6 block: train and prefill from zero state, decode from the
    cache's; prefill and decode write the new state into the cache's
    tensors in place."""
    x, st = RWKV.rwkv_block(cfg, p["rwkv"], x,
                            cache if mode == "decode" else None)
    if mode != "train":
        for name in ("s", "x_tm", "x_cm"):
            cache[name].copy_(st[name])
    return x, cache


def layer_forward(cfg, spec, p, x, positions, cache=None, mode="train"):
    """Returns (x, new_cache)."""
    _check_spec(spec)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if spec.block == "rwkv":
        return _rwkv(cfg, p, x, cache, mode)
    if mode == "train":
        x = _attn_train(cfg, spec, p, x, positions)
    elif mode == "prefill":
        x, cache = _attn_prefill(cfg, spec, p, x, positions, cache)
    else:
        x, cache = _attn_decode(cfg, spec, p, x, positions, cache)
    if spec.mlp == "dense":
        x = x + L.mlp_block(cfg, p["mlp"], L.apply_norm(cfg, x, p["norm2"]))
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------
def _index(tree, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _segment_apply(cfg, seg: Segment, seg_p, x, positions, seg_c, mode):
    """Run one segment: its layers in order (the reference's scan)."""
    for i in range(seg.repeats):
        lp = seg_p if seg.repeats == 1 else _index(seg_p, i)
        lc = seg_c if seg_c is None or seg.repeats == 1 \
            else _index(seg_c, i)
        for pi, spec in enumerate(seg.pattern):
            x, _ = layer_forward(cfg, spec, lp[f"p{pi}"], x, positions,
                                 None if lc is None else lc[f"c{pi}"], mode)
    return x, seg_c


@torch.no_grad()
def forward(cfg: ModelConfig, params, tokens, *, positions=None, cache=None,
            mode="train", return_hidden=False, last_only=False):
    """tokens: (B, S) → logits (B, S, V) in float32.  Returns
    (logits, cache); ``last_only`` unembeds the last position only
    (B, 1, V), the same rows at 1/S of the cost."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = L.embed(cfg, params["embed"], tokens)
    for si, seg in enumerate(layer_plan(cfg)):
        seg_c = None if cache is None else cache[f"seg{si}"]
        x, _ = _segment_apply(cfg, seg, params[f"seg{si}"], x, positions,
                              seg_c, mode)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(cfg, x, params["final_norm"])
    if return_hidden:
        return x, cache
    return L.unembed(cfg, params["embed"], x), cache
