"""Shared neural layers of the dense decoder (pure functions, explicit params).

The port of :mod:`repro.models.layers` without its loss functions (they
belong to the training slice).  Params are plain dicts of tensors with the
reference's names and layouts (``wq`` is ``(d, h·hd)``, ...); each
``*_spec`` function gives the shapes and initialisers of a block's params,
and ``init_*`` fills them from a ``torch.Generator``.

Numerics follow the reference: params in ``cfg.dtype`` (bfloat16 by
default; a spec leaf may name its own, as RWKV's float32 decay params
do), norms, softmax and attention in float32, products accumulated in
float32 (:func:`repro_torch.core.backend.no_tf32` keeps the library
products at full precision), logits in float32.

Attention keeps the reference's grouped layout at these functions'
boundaries: ``q (B, G, Hg, S, hd)``, ``k``/``v (B, G, S, hd)`` with
``G = num_kv_heads`` and ``Hg = num_heads / G``.  The reference's
``shard(...)`` annotations are dropped: on one device they do nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import NEG_INF, flash_attention

__all__ = ["truncated_normal", "full", "leaf_dtype", "materialize", "rmsnorm", "layernorm",
           "apply_norm", "norm_spec", "init_norm", "rope", "chunked_attention",
           "decode_attention", "attention_spec", "init_attention",
           "attention_qkv", "attention_out", "mlp_spec", "init_mlp",
           "mlp_block", "embed_spec", "init_embed", "embed", "unembed",
           "matmul_f32"]

_LOCAL_TODO = ("sliding-window (local) attention is not ported yet "
               "(ROADMAP Queue 1 item 18)")


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------
def truncated_normal(out: torch.Tensor, scale: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` in place with N(0, 1) truncated to [-2, 2], times
    ``scale`` (the reference's ``truncated_normal``), drawn in float32 one
    leading slice at a time so a stacked weight needs no float32 copy."""
    slices = out if out.dim() >= 3 else [out]
    for part in slices:
        tmp = torch.empty(part.shape, dtype=torch.float32, device=part.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        part.copy_(tmp.mul_(scale))
    return out


def full(value: float) -> tuple:
    """The ``init`` of a leaf filled with the constant ``value``."""
    return ("full", float(value))


def leaf_dtype(leaf: tuple, dtype: torch.dtype) -> torch.dtype:
    """A spec leaf's own dtype, else the model's ``dtype``."""
    return leaf[2] if len(leaf) > 2 else dtype


def materialize(spec: dict, dtype: torch.dtype, device,
                generator: torch.Generator, lead: tuple = ()) -> dict:
    """Tensors for a (nested) spec of ``(shape, init[, dtype])`` leaves,
    each with ``lead`` prepended to its shape, in the leaf's dtype if it
    names one (the float32 leaves of a bfloat16 RWKV block), else in
    ``dtype``; ``init`` is ``"ones"``, ``"zeros"``, :func:`full` of a
    constant or a float: the scale of a truncated normal."""
    out = {}
    for name, leaf in spec.items():
        if isinstance(leaf, dict):
            out[name] = materialize(leaf, dtype, device, generator, lead)
            continue
        shape, init = leaf[:2]
        t = torch.empty(tuple(lead) + tuple(shape),
                        dtype=leaf_dtype(leaf, dtype), device=device)
        if init == "ones":
            t.fill_(1.0)
        elif init == "zeros":
            t.zero_()
        elif isinstance(init, tuple):
            t.fill_(init[1])
        else:
            truncated_normal(t, float(init), generator)
        out[name] = t
    return out


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 output: the products of bfloat16 operands
    summed in float32 and never rounded to bfloat16 (the reference's
    ``preferred_element_type=float32``).  On the card one library call does
    it; on the CPU, which has no such call, the operands go to float32
    first, which gives the same products (a bfloat16 product is exact in
    float32)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        out = x2 @ w
    elif x.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm; ``plus_one`` is the Gemma (1 + w) convention."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def layernorm(x, weight, bias, *, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x, w):
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, w, eps=cfg.norm_eps, plus_one=False)
    if cfg.norm_type == "rmsnorm_plus_one":
        return rmsnorm(x, w, eps=cfg.norm_eps, plus_one=True)
    if cfg.norm_type == "layernorm":
        return layernorm(x, w["scale"], w["bias"], eps=cfg.norm_eps)
    raise ValueError(cfg.norm_type)


def norm_spec(cfg):
    if cfg.norm_type == "layernorm":
        return {"scale": ((cfg.d_model,), "ones"),
                "bias": ((cfg.d_model,), "zeros")}
    init = "zeros" if cfg.norm_type == "rmsnorm_plus_one" else "ones"
    return ((cfg.d_model,), init)


def init_norm(cfg, dtype, device, lead=()):
    return materialize({"w": norm_spec(cfg)}, dtype, device, None, lead)["w"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, d); positions: (..., S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; blockwise online softmax for long context)
# ---------------------------------------------------------------------------
def _attn_mask(qpos, kpos, *, causal: bool, window: Optional[int]):
    """(Sq, Sk) bool mask from global positions."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= kpos[None, :] > (qpos[:, None] - window)
    return m


def chunked_attention(q, k, v, qpos, kpos, *, causal=True, window=None,
                      chunk_q: int = 512, chunk_k: int = 1024,
                      scale: Optional[float] = None):
    """Memory-O(chunk²) attention.  q: (B,G,Hg,Sq,d), k/v: (B,G,Sk,d).

    One call of :func:`repro_torch.kernels.attention.flash_attention`: on
    CUDA tensors a launch of the kernel (which walks its own 64-key tiles),
    on CPU tensors its plain version over ``chunk_q × chunk_k`` blocks.
    Both keep the reference's shape rule: ``Sq`` and ``Sk`` divisible by
    their chunk (or shorter than it).  The grouped
    layout reshapes to the kernel's ``(B, G·Hg, S, d)`` without a copy:
    query head ``g·Hg + j`` reads KV head ``g``.
    """
    if window is not None:
        raise NotImplementedError(_LOCAL_TODO)
    b, g, hg, sq, d = q.shape
    sk = k.shape[2]
    dv = v.shape[-1]
    if scale is None:
        scale = d ** -0.5
    cq = min(chunk_q, sq)
    ck = min(chunk_k, sk)
    if sq % cq or sk % ck:
        raise ValueError(f"chunked_attention: Sq {sq} and Sk {sk} must be "
                         f"multiples of their chunks ({cq}, {ck})")
    out = flash_attention(q.reshape(b, g * hg, sq, d), k, v, causal=causal,
                          scale=scale, qpos=qpos, kpos=kpos, block_q=cq,
                          block_k=ck)
    return out.reshape(b, g, hg, sq, dv)


def decode_attention(q, k, v, kpos, qpos, *, window=None,
                     scale: Optional[float] = None):
    """Single-position attention over a cache.  q: (B,G,Hg,1,d);
    k/v: (B,G,Sk,d); plain PyTorch ops on every device, as the reference
    computes it without a Pallas kernel.

    ``kpos`` (B, Sk) carries per-slot validity: slots with kpos < 0 or
    kpos > qpos are masked (handles ring buffers and unfilled cache).
    """
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bghqd,bgkd->bghqk", q.float(), k.float()) * scale
    valid = (kpos >= 0) & (kpos <= qpos[:, None])
    if window is not None:
        valid &= kpos > (qpos[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bghqk,bgkv->bghqv", p, v.float())
    return out.to(q.dtype)


def attention_spec(cfg):
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    scale = d ** -0.5
    p = {
        "wq": ((d, h * hd), scale),
        "wk": ((d, kv * hd), scale),
        "wv": ((d, kv * hd), scale),
        "wo": ((h * hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p.update(bq=((h * hd,), "zeros"), bk=((kv * hd,), "zeros"),
                 bv=((kv * hd,), "zeros"))
    if cfg.qk_norm:
        p.update(q_norm=((hd,), "ones"), k_norm=((hd,), "ones"))
    return p


def init_attention(cfg, generator, dtype, device, lead=()):
    return materialize(attention_spec(cfg), dtype, device, generator, lead)


def attention_qkv(cfg, p, x, positions):
    """Project to (q, k, v) grouped for GQA: q (B,G,Hg,S,hd); k/v (B,G,S,hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hg = h // kv
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, kv, hg, hd).permute(0, 2, 3, 1, 4)   # (B,G,Hg,S,hd)
    k = k.reshape(b, s, kv, hd).permute(0, 2, 1, 3)           # (B,G,S,hd)
    v = v.reshape(b, s, kv, hd).permute(0, 2, 1, 3)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], eps=cfg.norm_eps)
    if cfg.rope_theta:
        q = rope(q, positions[:, None, None], theta=cfg.rope_theta)
        k = rope(k, positions[:, None], theta=cfg.rope_theta)
    return q, k, v


def attention_out(cfg, p, ctx):
    """ctx: (B,G,Hg,S,hd) → (B,S,D)."""
    b, g, hg, s, hd = ctx.shape
    ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, s, g * hg * hd)
    return ctx @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_spec(cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": ((d, f), d ** -0.5), "w_down": ((f, d), f ** -0.5)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = ((d, f), d ** -0.5)
    return p


def init_mlp(cfg, generator, dtype, device, lead=(), d_ff=None):
    return materialize(mlp_spec(cfg, d_ff), dtype, device, generator, lead)


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def mlp_block(cfg, p, x):
    if cfg.mlp_type == "gelu":                      # plain 2-layer (whisper)
        h = _gelu(x @ p["w_up"])
    else:
        act = {"swiglu": F.silu, "geglu": _gelu}[cfg.mlp_type]
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_spec(cfg):
    p = {"tok": ((cfg.vocab_size, cfg.d_model), 1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = ((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5)
    return p


def init_embed(cfg, generator, dtype, device):
    return materialize(embed_spec(cfg), dtype, device, generator)


def embed(cfg, p, tokens):
    x = p["tok"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(cfg, p, x):
    """Float32 logits ``(…, V)`` from ``x (…, d)``."""
    w = p["tok"].mT if cfg.tie_embeddings else p["unembed"]
    return matmul_f32(x, w)
