"""Blockwise (flash) attention, forward only, and the softmax oracle.

Kernel: ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a), replacing the
TPU kernel ``repro/kernels/attention.py::flash_attention``.  The source
note there says what bounds it on an H100 and how its design answers that.
bfloat16 inputs run on the tensor cores (``wgmma``): one block per
(128-row query tile, batch·head), a producer warp bringing K and V tiles
of 64 keys by TMA into a ring of shared-memory stages, two consumer
warpgroups of 64 rows running Q·Kᵀ, the online softmax in registers and
P·V with P split into a bfloat16 high and low part, so P·V keeps the TPU
kernel's float32 P.  float32 inputs run on the CUDA cores.  Both carry the running max,
denominator and accumulator in registers across the key tiles, skip the
tiles the causal mask hides, and take head dims 32, 64 and 128;
:func:`kernel_config` reports the bfloat16 kernel's tiling.

The plain PyTorch version, :func:`flash_attention_plain`, runs the same
online-softmax recurrence over ``block_q × block_k`` blocks (the reference's
Pallas blocks by default), forming P·V from the same split for bfloat16
inputs; :func:`flash_attention` runs it on CPU tensors, with the chunk
sizes :func:`repro_torch.models.layers.chunked_attention` passes.  Scores
are masked with ``-1e30``, as in the reference, and ``l == 0`` divides
by 1.  :func:`attn_expect` gives the kernel's elementwise tolerance against
the plain version run in float64, the bound the card's checks hold the
kernel to, and :func:`attn_faults` two wrong outputs it must reject.

The mask follows ``repro/models/layers.py::_attn_mask``: with ``causal``,
key ``j`` is visible to query ``i`` when ``qpos[i] >= kpos[j]``.  Without
positions both default to ``arange``, which is the Pallas kernel's
top-left mask.  :func:`attention` (the reference's ``ref.attention``)
aligns its causal mask bottom-right, so it agrees with the kernel only for
``Sq == Sk``.

The kernel reads contiguous, 16-byte aligned ``(B, H, S, D)`` operands:
the wrapper copies a view that is not.  There is no backward (nor has the
Pallas kernel), so an input that requires a gradient is refused;
``window`` (local attention) is not ported yet and raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain", "attention",
           "attn_expect", "attn_faults", "kernel_config", "NEG_INF",
           "HEAD_DIMS"]

NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
#: input dtypes the kernel is instantiated for
DTYPES = (torch.float32, torch.bfloat16)
#: Higham and Mary's probabilistic rounding factor in :func:`attn_expect`
ATTN_LAMBDA = 10.0
#: keys of the tile :func:`attn_faults` hides (the kernel's tile)
FAULT_TILE = 64
_WINDOW_TODO = ("sliding-window attention is not ported yet "
                "(ROADMAP Queue 1 item 18, local attention)")

_LIB = "flash_attention"
_ARGS = [_build.c_ptr] * 6 + [_build.c_i64] * 6 + [
    _build.c_f64, ctypes.c_int, _build.c_ptr]
_CONFIG = ("route", "block_q", "block_k", "stages", "threads", "smem_bytes")


def _check(q, k, v, qpos, kpos, window):
    if window is not None:
        raise NotImplementedError(_WINDOW_TODO)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention {name} must be a 4-D tensor")
        if t.requires_grad:
            raise ValueError("flash_attention has no backward: "
                             f"{name} requires grad")
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         "(B, H, Sq, D) and two of (B, Hkv, Sk, D)")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} "
                         "KV heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v dtypes differ")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v devices differ")
    qpos = _positions("qpos", qpos, sq, q.device)
    kpos = _positions("kpos", kpos, sk, q.device)
    return qpos, kpos


def _positions(what, pos, n, device):
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    if not isinstance(pos, torch.Tensor) or pos.shape != (n,):
        raise ValueError(f"flash_attention {what} must be a ({n},) tensor")
    if pos.device != device:
        raise ValueError(f"flash_attention {what} is on {pos.device}, "
                         f"expected {device}")
    return pos.to(torch.int32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    qpos: torch.Tensor | None = None,
                    kpos: torch.Tensor | None = None,
                    window: int | None = None, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, D)`` over ``k``, ``v (B, Hkv, Sk, D)``.

    Query head ``h`` reads KV head ``h // (H // Hkv)``; ``scale`` defaults
    to ``D ** -0.5``; ``qpos``/``kpos`` are the positions the causal mask
    compares.  ``block_q``/``block_k`` are the plain version's blocks on
    CPU tensors; the kernel walks its own tiles (:func:`kernel_config`).  Returns
    ``(B, H, Sq, D)`` in ``q.dtype``.
    """
    qpos, kpos = _check(q, k, v, qpos, kpos, window)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, qpos, kpos, causal=causal,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported "
                         f"(one of {HEAD_DIMS})")
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    qpos, kpos = qpos.contiguous(), kpos.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    fn = _build.function(
        _LIB, f"repro_flash_attention_{_build.SUFFIX[q.dtype]}", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                 _build.ptr(qpos), _build.ptr(kpos), b, h, hkv, sq, sk, d,
                 scale, int(bool(causal)), _build.stream_of(q.device))
    _build.check_launch(_LIB, err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def kernel_config(d: int = 128) -> dict:
    """The bfloat16 kernel's tiling at head dim ``d``, as its source states
    it: route (``wgmma``), query rows and keys a tile, K/V stages, threads
    a block and dynamic shared memory bytes.  Loads the library."""
    out = (ctypes.c_int64 * len(_CONFIG))()
    fn = _build.function(_LIB, "repro_flash_attention_bf16_config",
                         [_build.c_i64, _build.c_ptr])
    _build.check_launch(_LIB, fn(d, ctypes.cast(out, ctypes.c_void_p)),
                        "flash_attention config")
    cfg = dict(zip(_CONFIG, out))
    cfg["route"] = {1: "wgmma"}[cfg["route"]]
    return cfg


def flash_attention_plain(q, k, v, qpos=None, kpos=None, *, causal=True,
                          scale=None, block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    """The kernel's algorithm as PyTorch ops: for each ``block_q`` query
    rows, an online softmax over ``block_k`` keys at a time, all in float32
    (float64 for float64 inputs, the reference the card's checks hold the
    kernel to).  For bfloat16 inputs each block's P·V is formed as the
    kernel forms it, P_hi·V + P_lo·V with P_hi = bf16(p) and
    P_lo = bf16(p − P_hi).

    Same layout and semantics as :func:`flash_attention`, except that ``v``
    may have another last dimension than ``q``; the last blocks may be
    short.  Returns ``q.dtype``.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    if qpos is None:
        qpos = torch.arange(sq, device=q.device)
    if kpos is None:
        kpos = torch.arange(sk, device=q.device)
    # (B, Hkv, G, S, D): query head h = kv·G + g reads KV head kv
    cdt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, sq, d)
    kf = k.to(cdt).unsqueeze(2)
    vf = v.to(cdt).unsqueeze(2)
    out = torch.empty(b, hkv, g, sq, v.shape[-1], dtype=q.dtype,
                      device=q.device)
    for i in range(0, sq, block_q):
        qb = qg[:, :, :, i:i + block_q].to(cdt)
        qp = qpos[i:i + block_q]
        shape = qb.shape[:-1] + (1,)
        m = torch.full(shape, NEG_INF, dtype=cdt, device=q.device)
        l = torch.zeros(shape, dtype=cdt, device=q.device)
        acc = torch.zeros(qb.shape[:-1] + (v.shape[-1],), dtype=cdt,
                          device=q.device)
        for j in range(0, sk, block_k):
            s = torch.matmul(qb, kf[:, :, :, j:j + block_k].mT) * scale
            if causal:
                mask = qp[:, None] >= kpos[None, j:j + block_k]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            vb = vf[:, :, :, j:j + block_k]
            if q.dtype == torch.bfloat16:
                hi = p.to(torch.bfloat16).to(cdt)
                pv = torch.matmul(hi, vb) + torch.matmul(
                    (p - hi).to(torch.bfloat16).to(cdt), vb)
            else:
                pv = torch.matmul(p, vb)
            acc = acc * alpha + pv
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, i:i + block_q] = (acc / l).to(q.dtype)
    return out.reshape(b, h, sq, v.shape[-1])


def attn_expect(q, k, v, *, causal: bool = True, qpos=None, kpos=None):
    """The plain version in float64 and the kernel's elementwise tolerance
    against it: ``(want, tol)``, both float64 of ``q``'s shape.

    One output is o = Σ p_j·v_j / Σ p_j with p_j = exp(s_j − m).  With
    u = 2^-24 and rounding errors bounded as Higham and Mary's
    probabilistic analysis does, at λ = 10 (a miss chance far below 1e-9
    over all outputs): a score, a D-term dot product scaled, is off by
    (λ·√D + 1)·u·a, a = scale·|q_i|·max_j|k_j| ≥ |s_j|; exp's argument
    s_j − m by u·2a more, and expf adds 2 ulp, so every p_j is off by a
    relative δ = u·((λ·√D + 3)·a + 4), which moves o by at most 2·δ·M,
    M = Σ p_j·|v_j| / Σ p_j.  The two sums over Sk keys and the Sk/64 tile
    rescalings add 2·λ·√(Sk + Sk/64)·u·M, the division u·M.  bfloat16
    output adds its rounding, 2^-8 of |o| + the above.  The bound scales
    with M, not with max|v|: a tile left out or a row not written exceeds
    it (:func:`attn_faults`).
    """
    h, d, hkv, sk = q.shape[1], q.shape[3], k.shape[1], k.shape[2]
    q64, k64, v64 = q.double(), k.double(), v.double()
    both = flash_attention_plain(
        q64, k64, torch.cat([v64, v64.abs()], dim=-1), qpos, kpos,
        causal=causal, block_q=1024, block_k=1024)
    want, mag = both[..., :d], both[..., d:]
    kmax = k64.norm(dim=-1).amax(dim=-1).repeat_interleave(h // hkv, dim=1)
    a = d ** -0.5 * q64.norm(dim=-1, keepdim=True) * kmax[:, :, None, None]
    del q64, k64, v64, both
    lam, u = ATTN_LAMBDA, 2.0 ** -24
    tol = u * mag * (2.0 * ((lam * d ** 0.5 + 3.0) * a + 4.0)
                     + 2.0 * lam * (sk + sk / 64) ** 0.5 + 1.0)
    if q.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * (want.abs() + tol)
    return want, tol


def attn_faults(q, k, v, out, *, causal: bool = True, qpos=None,
                kpos=None) -> dict:
    """Two wrong versions of ``out``, what :func:`flash_attention` returned
    for these inputs, which :func:`attn_expect`'s bound must reject:
    ``tile_skipped`` (the kernel run again with the ``FAULT_TILE`` keys
    from Sk/2 hidden through ``kpos``, placed past every query, so it
    leaves that tile out) and ``half_rows_zero`` (the second half of the
    rows not written)."""
    sq, sk = q.shape[2], k.shape[2]
    qpos = _positions("qpos", qpos, sq, q.device)
    hidden = _positions("kpos", kpos, sk, q.device).clone()
    hidden[sk // 2:sk // 2 + FAULT_TILE] = int(qpos.max()) + 1
    zero = out.clone()
    zero[:, :, sq // 2:] = 0
    return {"tile_skipped": flash_attention(q, k, v, causal=causal,
                                            qpos=qpos, kpos=hidden),
            "half_rows_zero": zero}


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Softmax attention oracle of one head: ``q (Sq, d)``, ``k (Sk, d)``,
    ``v (Sk, dv)``; the causal mask aligned bottom-right (the reference's
    ``ref.attention``), ``-inf`` where masked."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (q @ k.mT) * scale
    if causal:
        sq, sk = q.shape[0], k.shape[0]
        mask = (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ v).to(q.dtype)
