"""RWKV6 "Finch" blocks — attention-free, data-dependent decay
(arXiv:2404.05892).

The port of :mod:`repro.models.rwkv6`.  TimeMix runs the WKV6 recurrence
with a matrix-valued state ``S (dk, dv)`` per head::

    out_t = r_tᵀ·(S_t + diag(u)·k_t v_tᵀ)
    S_{t+1} = diag(w_t)·S_t + k_t v_tᵀ          (w_t data-dependent)

Prefill and the full forward take the chunked parallel form
(:func:`wkv6_chunked`, one call of
:func:`repro_torch.kernels.wkv6.wkv6_fused`: on CUDA tensors a launch of
the WKV6 kernel); decode carries ``S`` exactly one token at a time
(:func:`wkv6_step`, plain tensor ops on every device, as the reference
computes it without a kernel).  The chunked form clips its exponents at
±80 as the reference does, so where the cumulative log-decay inside one
chunk passes −80 it differs from the token recurrence; the port keeps
that.

Dtypes follow the reference: the token-shift mixes and the projections in
``cfg.dtype``; the decay in float32 on the float32 ``w0``/``wa``/``wb``;
the WKV in float32 (the kernel converts bfloat16 ``r``, ``k``, ``v``
inside); the per-head group norm in float32; ``y·g`` cast to
``cfg.dtype`` before ``wo``.  The reference's static token-shift
coefficients (RWKV5-style, instead of the ddlerp LoRA stack) are kept.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv6 as K
from repro_torch.models import layers as L

__all__ = ["rwkv_spec", "wkv6_chunked", "wkv6_step", "rwkv_block",
           "LORA"]

#: rank of the decay's low-rank MLP (``wa``, ``wb``)
LORA = 64


def rwkv_spec(cfg) -> dict:
    """Shapes and initialisers of one block's params (the reference's
    ``init_rwkv_block``): ``w0``, ``wa``, ``wb`` and ``u`` stay float32 in
    a bfloat16 model."""
    d, h, f = cfg.d_model, cfg.num_heads, cfg.d_ff
    dk = d // h
    f32 = torch.float32
    return {
        "ln1": L.norm_spec(cfg), "ln2": L.norm_spec(cfg),
        "mu": ((5, d), L.full(0.5)),                  # r, k, v, w, g shifts
        "wr": ((d, d), d ** -0.5),
        "wk": ((d, d), d ** -0.5),
        "wv": ((d, d), d ** -0.5),
        "wg": ((d, d), d ** -0.5),
        "wo": ((d, d), d ** -0.5),
        "w0": ((d,), L.full(-0.6), f32),              # base decay exp(-e^-0.6)
        "wa": ((d, LORA), d ** -0.5, f32),
        "wb": ((LORA, d), LORA ** -0.5, f32),
        "u": ((h, dk), 0.5, f32),
        "ln_x": ((d,), "ones"),                       # per-head group norm
        "mu_c": ((2, d), L.full(0.5)),                # channel-mix shifts
        "ck": ((d, f), d ** -0.5),
        "cv": ((f, d), f ** -0.5),
        "cr": ((d, d), d ** -0.5),
    }


def _token_shift(x, prev):
    """x_{t-1} along seq; ``prev`` (B, 1, D) supplies the t = 0 value."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _heads(x, h):
    b, s, d = x.shape
    return x.reshape(b, s, h, d // h).transpose(1, 2)      # (B, H, S, dk)


def _decay(p, xw):
    """Data-dependent per-channel decay w_t ∈ (0, 1); returns log w
    (float32)."""
    dd = torch.tanh(xw.float() @ p["wa"]) @ p["wb"]
    return -torch.exp(p["w0"] + dd)


def wkv6_chunked(r, k, v, logw, u, s0, chunk: int):
    """Full-sequence WKV6.  r, k, v, logw: (B, H, S, dk); returns
    (out (B, H, S, dv) float32, s_final)."""
    return K.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=chunk)


def wkv6_step(r, k, v, logw, u, s):
    """Exact single-token recurrence.  r, k, v, logw: (B, H, dk)."""
    kv = k[..., :, None] * v[..., None, :]                  # (B, H, dk, dv)
    out = torch.einsum("bhd,bhdv->bhv", r, s + u[None, :, :, None] * kv)
    s_new = torch.exp(logw)[..., None] * s + kv
    return out, s_new


def _group_norm_heads(x, scale, eps=1e-5):
    """Per-head LayerNorm of the WKV output (RWKV convention)."""
    b, hh, s, dv = x.shape
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    xf = xf.transpose(1, 2).reshape(b, s, hh * dv)
    return xf * scale.float()


def rwkv_block(cfg, p, x, state=None):
    """Full RWKV6 block (TimeMix + ChannelMix).  x: (B, S, D).

    ``state`` (decode): dict(s, x_tm, x_cm); None starts from zero (train
    and prefill).  Returns (y, new_state).
    """
    b, s, d = x.shape
    h = cfg.num_heads
    dk = d // h
    if state is None:
        prev_tm = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
        prev_cm = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=x.device)
    else:
        prev_tm, prev_cm, s0 = state["x_tm"], state["x_cm"], state["s"]

    # ---- TimeMix ----------------------------------------------------------
    x_in = L.apply_norm(cfg, x, p["ln1"])
    xprev = _token_shift(x_in, prev_tm)
    xr, xk, xv, xw, xg = (x_in + (xprev - x_in) * p["mu"][i]
                          for i in range(5))
    r = _heads(xr @ p["wr"], h)
    k = _heads(xk @ p["wk"], h)
    v = _heads(xv @ p["wv"], h)
    g = F.silu(xg @ p["wg"])
    logw = _heads(_decay(p, xw), h)

    if s == 1 and state is not None:
        out, s_new = wkv6_step(r[:, :, 0].float(), k[:, :, 0].float(),
                               v[:, :, 0].float(), logw[:, :, 0], p["u"], s0)
        out = out[:, :, None, :]
    else:
        out, s_new = wkv6_chunked(r, k, v, logw, p["u"], s0, cfg.rwkv_chunk)

    y = _group_norm_heads(out, p["ln_x"])
    x_mid = x + (y * g.float()).to(x.dtype) @ p["wo"]

    # ---- ChannelMix --------------------------------------------------------
    cm_in = L.apply_norm(cfg, x_mid, p["ln2"])
    xprev = _token_shift(cm_in, prev_cm)
    xk_c = cm_in + (xprev - cm_in) * p["mu_c"][0]
    xr_c = cm_in + (xprev - cm_in) * p["mu_c"][1]
    kk = torch.square(F.relu(xk_c @ p["ck"]))
    out_x = x_mid + torch.sigmoid(xr_c @ p["cr"]) * (kk @ p["cv"])

    new_state = {"x_tm": x_in[:, -1:],         # TimeMix shift: normed input
                 "x_cm": cm_in[:, -1:],        # ChannelMix shift: normed mid
                 "s": s_new}
    return out_x, new_state
