"""Decoder backbone: dense attention blocks, segment loops, the KV cache.

The port of :mod:`repro.models.transformer` for dense attention blocks.
Layers are grouped into :class:`repro_torch.configs.base.Segment` runs of
identical structure; each segment's params are stacked on a leading layer
axis, as in the reference, and a Python loop walks the layers (the
reference's ``lax.scan``).  Nothing here takes a gradient, so there is no
remat.

Cache model (decode): ``attn`` — a dense KV cache ``(B, G, W, hd)`` ×2 and
per-slot positions ``(B, W)``, ``-1`` where unfilled, stacked per segment
like the params.  Where the reference returns a new cache, the port writes
the new keys and values into the cache's tensors in place and returns the
same dict.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``local`` blocks and the ring cache, ``rg`` (RG-LRU), ``rwkv``
(RWKV6, with the ``wkv6_fused`` kernel), and MoE MLPs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment, layer_plan
from repro_torch.models import layers as L

__all__ = ["dtype_of", "layer_param_spec", "param_spec", "init_layer",
           "init_params", "init_layer_cache", "init_cache", "layer_forward",
           "forward"]

_TODO = {
    "local": "local (sliding-window) attention and its ring cache: "
             "ROADMAP Queue 1 item 18",
    "rg": "RG-LRU blocks: ROADMAP Queue 1 item 18",
    "rwkv": "RWKV6 blocks (and the wkv6_fused kernel): ROADMAP Queue 1 "
            "item 18, the next slice",
    "moe": "MoE MLPs: ROADMAP Queue 1 item 18",
}


def _unported(what: str):
    return NotImplementedError(f"not ported yet — {_TODO[what]}")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_spec(spec: LayerSpec) -> None:
    if spec.block != "attn":
        raise _unported(spec.block if spec.block in _TODO else "rg")
    if spec.mlp == "moe":
        raise _unported("moe")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def layer_param_spec(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Shapes and initialisers of one layer's params (``(shape, init)``
    leaves, see :func:`repro_torch.models.layers.materialize`)."""
    _check_spec(spec)
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
    shape, init = spec
    return (tuple(lead) + tuple(shape), init)


def init_layer(cfg: ModelConfig, spec: LayerSpec, generator, device,
               lead=()):
    return L.materialize(layer_param_spec(cfg, spec), dtype_of(cfg), device,
                         generator, lead)


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random params, segment-stacked, in ``cfg.dtype`` on ``device``."""
    return L.materialize(param_spec(cfg), dtype_of(cfg), device, generator)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device, lead=()):
    if spec.block != "attn":
        raise _unported(spec.block if spec.block in _TODO else "rg")
    g, hd = cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
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


def layer_forward(cfg, spec, p, x, positions, cache=None, mode="train"):
    """Returns (x, new_cache)."""
    _check_spec(spec)
    if mode == "train":
        x = _attn_train(cfg, spec, p, x, positions)
    elif mode == "prefill":
        x, cache = _attn_prefill(cfg, spec, p, x, positions, cache)
    elif mode == "decode":
        x, cache = _attn_decode(cfg, spec, p, x, positions, cache)
    else:
        raise ValueError(f"unknown mode {mode!r}")
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
