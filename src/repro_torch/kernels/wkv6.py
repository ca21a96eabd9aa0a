"""The chunked WKV6 recurrence of RWKV6 ("Finch"), forward only.

Kernel: ``csrc/wkv6.cu`` (CUDA C++ for sm_90a), replacing the TPU kernel
``repro/kernels/wkv6.py::wkv6_fused``.  For each (batch, head) it carries
the state ``S (dk, dv)`` in float32 across chunks of ``c`` tokens and
computes, chunk by chunk (``cum`` the inclusive cumulative sum of ``logw``
inside the chunk, ``wtot`` its last row, exponents clipped at ±80)::

    r_in  = r·exp(clip(cum − logw))      k_out = k·exp(clip(−cum))
    out   = r_in·S + tril(r_in·k_outᵀ, −1)·v + (Σ r·u·k)·v
    S    ← exp(clip(wtot))ᵀ ⊙ S + (k·exp(clip(wtot − cum)))ᵀ·v

It differs from the TPU kernel in two ways, both needed by
:func:`repro_torch.models.rwkv6.wkv6_chunked`: it starts from a given
state ``s0`` (the TPU kernel from zero), and it takes any sequence length
(the TPU kernel asserts ``S % c == 0``): a short last chunk is processed as
it is, which equals the reference's zero padding exactly, since padded
rows have ``logw = 0`` and ``k = v = 0``.  The kernel takes float32 or
bfloat16 ``r``, ``k``, ``v`` (converted to float32 inside), float32
``logw``, ``u`` and ``s0``, head dims ``dk = dv`` of 32 or 64, and chunks
of at most 128 tokens.

The kernel cuts the work into (batch·head, chunk) tiles, which a
persistent grid of one block an SM takes in chunk-major order; each tile
does its chunk's own work and then waits for the state of the chunk
before it, so only the state update runs in chunk order (the source note
of ``csrc/wkv6.cu``).  :func:`plan` shows how a shape runs: the tiles, the
grid, the workspace (two state slots a head) and the int32 flags.

The plain PyTorch version, :func:`wkv6_fused_plain`, is the reference's
chunk loop; :func:`wkv6_fused` runs it on CPU tensors.  :func:`wkv6_expect`
gives the kernel's elementwise tolerance against the plain version run in
float64, the bound the card's checks hold the kernel to.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["wkv6_fused", "wkv6_fused_plain", "wkv6_expect", "wkv6_faults",
           "plan", "CLIP", "HEAD_DIMS", "MAX_CHUNK"]

#: the exponent guard of the reference (``repro/models/rwkv6.py::_CLIP``)
CLIP = 80.0
#: head dims (dk = dv) the kernel is instantiated for
HEAD_DIMS = (32, 64)
#: the longest chunk the kernel holds in shared memory
MAX_CHUNK = 128
#: dtypes of r, k, v the kernel is instantiated for
DTYPES = (torch.float32, torch.bfloat16)
#: Higham and Mary's probabilistic rounding factor in ``wkv6_expect``
_LAMBDA = 10.0

_LIB = "wkv6"
_ARGS = [_build.c_ptr] * 10 + [_build.c_i64] * 6 + [_build.c_ptr]
_PLAN_ARGS = [_build.c_i64, ctypes.POINTER(_build.c_i64)]
#: (device index, raw stream) -> the kernel's int32 flags (a head's count of
#: published chunks, then the ticket): zeroed when allocated and left at 0
#: by every launch (a head's last chunk resets its count, the last ticket
#: taken the ticket)
_FLAGS: dict = {}


def _check(r, k, v, logw, u, s0, chunk):
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"wkv6_fused {name} must be a 4-D tensor")
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or logw.shape != r.shape \
            or v.shape[:3] != (b, h, s):
        raise ValueError(f"wkv6_fused shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}: expected three of (B, H, S, "
                         "dk) and v (B, H, S, dv)")
    if not isinstance(u, torch.Tensor) or u.shape != (h, dk):
        raise ValueError(f"wkv6_fused u must be a ({h}, {dk}) tensor")
    if s0 is not None and (not isinstance(s0, torch.Tensor)
                           or s0.shape != (b, h, dk, dv)):
        raise ValueError(f"wkv6_fused s0 must be a ({b}, {h}, {dk}, {dv}) "
                         "tensor")
    ts = [r, k, v, logw, u] + ([] if s0 is None else [s0])
    if any(t.device != r.device for t in ts):
        raise ValueError("wkv6_fused: operands on different devices")
    if any(t.requires_grad for t in ts):
        raise ValueError("wkv6_fused has no backward: an operand requires "
                         "grad")
    if int(chunk) < 1:
        raise ValueError(f"wkv6_fused: chunk {chunk} < 1")


@functools.lru_cache(maxsize=None)
def _card(dtype: torch.dtype, d: int, index: int) -> dict:
    """What one SM of card ``index`` takes of the kernel (builds the
    library): blocks an SM, shared bytes a block, registers and local
    (spill) bytes a thread, threads a block, and the card's SMs."""
    out = (_build.c_i64 * 5)()
    fn = _build.function(_LIB, f"repro_wkv6_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(d, out)
    _build.check_launch(_LIB, err, f"wkv6 plan for {dtype}, D {d}")
    return {"blocks_per_sm": out[0], "smem_bytes": out[1],
            "registers": out[2], "local_bytes": out[3], "threads": out[4],
            "sms": torch.cuda.get_device_properties(index)
            .multi_processor_count}


def plan(b: int, h: int, s: int, d: int, chunk: int = 128,
         dtype: torch.dtype = torch.bfloat16, *, sms: Optional[int] = None,
         blocks_per_sm: Optional[int] = None,
         device: Optional[torch.device] = None) -> dict:
    """How ``wkv6_fused`` runs (B, H, S, D) with ``chunk``: the chunk
    length ``chunk`` (``min(chunk, S)``, at least 1), ``chunks`` a head and
    ``last_rows`` in the last one, ``tiles`` (B·H·chunks, taken in
    chunk-major order: ticket i is chunk i // (B·H) of head i % (B·H)),
    ``grid`` (the tiles, at most ``sms`` × ``blocks_per_sm``, at least 1),
    ``workspace_bytes`` (two float32 D × D state slots a head) and
    ``flag_words`` (a count a head and the ticket).  ``sms`` and
    ``blocks_per_sm`` default to the card's (which builds the library and
    adds its shared bytes, registers and spills to the plan)."""
    c = max(1, min(int(chunk), s))
    chunks = -(-s // c) if s > 0 else 0
    out = {"chunk": c, "chunks": chunks,
           "last_rows": s - (chunks - 1) * c if chunks else 0,
           "tiles": b * h * chunks, "workspace_bytes": 4 * 2 * b * h * d * d,
           "flag_words": b * h + 1}
    if sms is None or blocks_per_sm is None:
        device = torch.device(device or "cuda")
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        card = _card(dtype, d, index)
        out.update(card)
        sms = card["sms"] if sms is None else sms
        blocks_per_sm = card["blocks_per_sm"] if blocks_per_sm is None \
            else blocks_per_sm
    out["grid"] = max(1, min(out["tiles"], sms * blocks_per_sm))
    out["blocks_per_sm"] = blocks_per_sm
    return out


def wkv6_fused(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, *,
               s0: torch.Tensor | None = None, chunk: int = 128):
    """WKV6 over a whole sequence.  ``r``, ``k``, ``logw``: (B, H, S, dk);
    ``v``: (B, H, S, dv); ``u``: (H, dk); ``s0``: (B, H, dk, dv) or None
    (zero).  Chunks of ``min(chunk, S)`` tokens, the last one possibly
    shorter.  Returns (out (B, H, S, dv) float32, final state (B, H, dk,
    dv) float32).
    """
    _check(r, k, v, logw, u, s0, chunk)
    if r.device.type == "cpu":
        return wkv6_fused_plain(r, k, v, logw, u, s0=s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_fused: unsupported device {r.device}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6_fused: r, k, v dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype} (one of float32, bfloat16 for all three)")
    f32 = torch.float32
    if logw.dtype != f32 or u.dtype != f32 \
            or (s0 is not None and s0.dtype != f32):
        raise ValueError("wkv6_fused: logw, u and s0 must be float32")
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"wkv6_fused: head dims dk {dk}, dv {dv} not "
                         f"supported (dk = dv, one of {HEAD_DIMS})")
    c = max(1, min(int(chunk), s))
    if c > MAX_CHUNK:
        raise ValueError(f"wkv6_fused: chunk {c} exceeds the kernel's "
                         f"{MAX_CHUNK}")
    r, k, v, logw, u = (_build.aligned(t) for t in (r, k, v, logw, u))
    s0 = None if s0 is None else _build.aligned(s0)
    out = torch.empty((b, h, s, dv), dtype=f32, device=r.device)
    sfin = torch.empty((b, h, dk, dv), dtype=f32, device=r.device)
    if b * h == 0:
        return out, sfin
    device = r.device
    pl = plan(b, h, s, dk, c, r.dtype, device=device)
    slots = torch.empty(pl["workspace_bytes"] // 4, dtype=f32, device=device)
    stream = _build.stream_of(device)
    key = (device.index, stream.value)
    flags = _FLAGS.get(key)
    if flags is None or flags.numel() < pl["flag_words"]:
        flags = _FLAGS[key] = torch.zeros(pl["flag_words"], dtype=torch.int32,
                                          device=device)
    fn = _build.function(_LIB, f"repro_wkv6_{_build.SUFFIX[r.dtype]}", _ARGS)
    with _build.device_guard(device):
        err = fn(_build.ptr(r), _build.ptr(k), _build.ptr(v),
                 _build.ptr(logw), _build.ptr(u),
                 None if s0 is None else _build.ptr(s0), _build.ptr(out),
                 _build.ptr(sfin), _build.ptr(slots), _build.ptr(flags), b, h,
                 s, dk, c, pl["grid"], stream)
    _build.check_launch(_LIB, err, "wkv6 kernel launch")
    wkv6_fused.launches += 1
    return out, sfin


wkv6_fused.launches = 0


def _chunks(s: int, chunk: int):
    c = max(1, min(int(chunk), s))
    return [slice(t0, min(t0 + c, s)) for t0 in range(0, s, c)]


def wkv6_fused_plain(r, k, v, logw, u, *, s0=None, chunk: int = 128):
    """The kernel's algorithm as PyTorch ops: the reference's chunk loop
    (``repro/models/rwkv6.py::_wkv_chunk_inner``), in float32 (float64 when
    an operand is float64, the reference the card's checks hold the kernel
    to).  Same arguments and results as :func:`wkv6_fused`."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    cdt = torch.promote_types(torch.promote_types(r.dtype, logw.dtype),
                              torch.float32)
    state = (torch.zeros((b, h, dk, dv), dtype=cdt, device=r.device)
             if s0 is None else s0.to(cdt).clone())
    out = torch.empty((b, h, s, dv), dtype=cdt, device=r.device)
    uu = u.to(cdt)[None, :, None, :]
    for sl in _chunks(s, chunk):
        rr, kk, vv, lw = (x[:, :, sl].to(cdt) for x in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=2)
        r_in = rr * torch.exp(torch.clamp(cum - lw, -CLIP, CLIP))
        k_out = kk * torch.exp(torch.clamp(-cum, -CLIP, CLIP))
        inter = r_in @ state
        scores = torch.tril(r_in @ k_out.mT, -1)
        bonus = (rr * (uu * kk)).sum(-1, keepdim=True)
        intra = scores @ vv + bonus * vv
        wtot = cum[:, :, -1:]
        k_fwd = kk * torch.exp(torch.clamp(wtot - cum, -CLIP, CLIP))
        state = (torch.exp(torch.clamp(wtot, -CLIP, CLIP)).mT * state
                 + k_fwd.mT @ vv)
        out[:, :, sl] = inter + intra
    return out, state


def wkv6_expect(r, k, v, logw, u, *, s0=None, chunk: int = 128):
    """The plain version in float64 and the kernel's elementwise tolerance
    against it: ``(out, out_tol, s_final, s_final_tol)``.

    The kernel computes in float32 (u = 2^-24) from the same inputs.  Its
    exponent arguments come from a cumulative sum over up to n ≤ c rows,
    whose rounding error is at most (n + 8)·u·Σ|logw| (a recursive sum;
    the kernel's warp scan of each 32-row segment and its carry add take
    ⌈log₂ 32⌉ + 1 roundings and one a segment); the clip at ±80 caps what that
    error can do (an argument past the clip by more than the error is
    clipped on both sides), so the error is taken on min(Σ|logw|, 2·80).
    It reaches each factor exp(·) as a relative error, with expf's 2 ulp
    and the product's rounding: at c 128 and |cum| 80 about 6e-4, far more
    than 4·c·u.  Every term of ``out`` and of the carried state is a
    product of such factors; the bound carries, beside the values, their
    magnitudes (the same recurrence on |r|, |k|, |v|, |u|, |s0|) and a
    first-order bound on the state's error from chunk to chunk, so an old
    term's decay factors add their errors as it ages.  The dot products
    add λ·√(terms)·u of their magnitude (Higham and Mary's probabilistic
    bound, λ = 10), the final sums u.  A state dropped at a chunk boundary,
    a score mask that takes the diagonal or a tail left unwritten exceed
    the bound (the card's checks plant each, from :func:`wkv6_faults`).
    """
    f64 = torch.float64
    ue = 2.0 ** -24
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    r, k, v, logw, u = (x.to(f64) for x in (r, k, v, logw, u))
    state = (torch.zeros((b, h, dk, dv), dtype=f64, device=r.device)
             if s0 is None else s0.to(f64).clone())
    smag, serr = state.abs(), torch.zeros_like(state)
    out = torch.empty((b, h, s, dv), dtype=f64, device=r.device)
    tol = torch.empty_like(out)
    uu = u[None, :, None, :]

    def ex(x):
        return torch.exp(torch.clamp(x, -CLIP, CLIP))

    for sl in _chunks(s, chunk):
        rr, kk, vv, lw = (x[:, :, sl] for x in (r, k, v, logw))
        n = rr.shape[2]
        gd, gc = _LAMBDA * math.sqrt(dk) * ue, _LAMBDA * math.sqrt(n) * ue
        cum = torch.cumsum(lw, dim=2)
        wtot = cum[:, :, -1:]
        ea = (n + 8) * ue * torch.cumsum(lw.abs(), 2).clamp(max=2 * CLIP)
        ew = ea[:, :, -1:]
        # the factors and their relative errors
        r_in, k_out, k_fwd = rr * ex(cum - lw), kk * ex(-cum), kk * ex(
            wtot - cum)
        dec = ex(wtot).mT                                   # (B, H, dk, 1)
        e_rin = ea + ue * (cum - lw).abs().clamp(max=CLIP) + 4 * ue
        e_kout = ea + 3 * ue
        e_kfwd = ea + ew + ue * (wtot - cum).abs().clamp(max=CLIP) + 4 * ue
        e_dec = (ew + 3 * ue).mT
        ar, ak, akf, av = r_in.abs(), k_out.abs(), k_fwd.abs(), vv.abs()
        # values
        bonus = (rr * (uu * kk)).sum(-1, keepdim=True)
        scores = torch.tril(r_in @ k_out.mT, -1)
        out[:, :, sl] = r_in @ state + (scores @ vv + bonus * vv)
        # magnitudes and error bounds of inter, scores, intra
        inter_mag = ar @ smag
        inter_err = (ar * e_rin) @ smag + ar @ serr + gd * inter_mag
        sc_mag = torch.tril(ar @ ak.mT, -1)
        sc_err = torch.tril((ar * e_rin) @ ak.mT + ar @ (ak * e_kout).mT,
                            -1) + gd * sc_mag
        bon_mag = (rr.abs() * (uu.abs() * kk.abs())).sum(-1, keepdim=True)
        intra_mag = sc_mag @ av + bon_mag * av
        intra_err = sc_err @ av + gc * (sc_mag @ av) \
            + (gd + 2 * ue) * bon_mag * av
        tol[:, :, sl] = inter_err + intra_err \
            + 2 * ue * (inter_mag + intra_mag)
        # the state, its magnitude and its error
        kv_mag = akf.mT @ av
        state = dec * state + k_fwd.mT @ vv
        serr = dec * serr + e_dec * dec * smag + (akf * e_kfwd).mT @ av \
            + gc * kv_mag + ue * (dec * smag + kv_mag)
        smag = dec * smag + kv_mag
    return out, tol, state, serr + ue * smag


def wkv6_faults(r, k, v, logw, u, out, *, s0=None, chunk: int = 128,
                split_at: int):
    """Three wrong versions of ``out``, what :func:`wkv6_fused` returned for
    these inputs, which :func:`wkv6_expect`'s bound must reject:
    ``state_dropped`` (the run from ``split_at``, a chunk boundary, started
    from zero instead of the carried state), ``diagonal_in_mask`` (the
    score mask inclusive of the diagonal: each row adds
    (Σ r·k·exp(clip(cum − logw))·exp(clip(−cum)))·v, in float64) and
    ``tail_skipped`` (the last chunk, the ragged tail where S % c > 0,
    left zero)."""
    seq = r.shape[2]
    c = max(1, min(int(chunk), seq))
    rest = [x[:, :, split_at:] for x in (r, k, v, logw)]
    dropped = torch.cat([out[:, :, :split_at],
                         wkv6_fused(*rest, u, chunk=chunk)[0]], 2)
    diagonal = out.to(torch.float64, copy=True)
    for sl in _chunks(seq, chunk):
        lw = logw[:, :, sl].double()
        cum = torch.cumsum(lw, 2)
        fac = torch.exp(torch.clamp(cum - lw, -CLIP, CLIP)) \
            * torch.exp(torch.clamp(-cum, -CLIP, CLIP))
        diagonal[:, :, sl] += (r[:, :, sl].double() * k[:, :, sl] * fac).sum(
            -1, keepdim=True) * v[:, :, sl].double()
    tail = out.clone()
    tail[:, :, seq - (seq % c or c):] = 0
    return {"state_dropped": dropped, "diagonal_in_mask": diagonal,
            "tail_skipped": tail}
