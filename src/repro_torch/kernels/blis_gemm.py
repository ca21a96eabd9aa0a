"""GEMM and GEMM-accumulate: ``O = β·C + α·A·B``.

Kernel: ``csrc/gemm.cu`` (CUDA C++ for sm_90a), one kernel for both of the
reference's TPU kernels ``repro/kernels/blis_gemm.py::blis_gemm`` (β = 0)
and ``::blis_gemm_accum`` (β = 1, the DMF trailing update).  The source
note there says what bounds it on an H100 and how its design answers that.

The sum is split by K alone: K is cut into chunks of :data:`KC` terms;
chunk 0 starts from ``β·C`` and every later chunk from 0, each adds its
products in ascending k with one accumulator, and the chunks are then added
onto chunk 0 in ascending order.  For K ≤ KC that is one ascending chain.
An element's result so depends only on its row of A, its column of B, its
element of C and K, never on M, N, the tile or how the kernel maps chunks
onto blocks (:func:`plan`) — so the kernel is column- and
row-decomposable, the property that keeps every look-ahead schedule
bitwise equal to the blocked one.  The plain PyTorch version
:func:`gemm_accum_plain` runs the same chunked sum, one rank-1 term per
step; it differs from the kernel only in rounding the product before the
add (the kernel fuses them in an FMA, or in float64 a DMMA step, which
rounds as the same FMA chain).  Unlike the reference's f32 accumulator (a
limit of the TPU's matrix unit), both compute and accumulate at the input
dtype.

Wrappers take the plain version only for CPU tensors; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["KC", "gemm", "gemm_accum", "gemm_accum_plain", "plan",
           "gemm_chain"]

_LIB = "gemm"
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_f64,
         _build.c_ptr, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_f64, _build.c_ptr, _build.c_i64, _build.c_ptr,
         _build.c_i64]
#: the kernel's entry: the operands, the workspace and its size, the stream
_RUN_ARGS = _ARGS + [_build.c_ptr, _build.c_i64, _build.c_ptr]
_CHAIN_ARGS = _ARGS + [_build.c_ptr]
_PLAN_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64,
              ctypes.POINTER(ctypes.c_int64)]
#: how :func:`plan` names the kernel's mappings of chunks onto blocks
MAPPINGS = ("single", "in_block", "across")

#: Terms of K summed in one chain before the chunks are added: the
#: kernel's ``KC`` (``csrc/gemm.cu``), which the tests hold this equal to.
KC = 1024


def gemm_accum_plain(c: Optional[torch.Tensor], a: torch.Tensor,
                     b: torch.Tensor, *, alpha: float = -1.0,
                     beta: float = 1.0,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``β·C + α·A·B`` as the kernel sums it: chunks of :data:`KC` terms in
    ascending k, chunk 0 from ``β·C`` and the others from 0, then the chunks
    added in order.

    Elementwise ops only (each a single rounding), so every element is
    computed the same way whatever the shape of the call.
    """
    m, n, k = a.shape[0], b.shape[1], a.shape[1]
    if beta == 0.0:
        acc = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    else:
        acc = c * beta if beta != 1.0 else c.clone()
    for k0 in range(0, k, KC):
        part = acc if k0 == 0 else torch.zeros_like(acc)
        for p in range(k0, min(k, k0 + KC)):
            part += (a[:, p : p + 1] * alpha) * b[p : p + 1, :]
        if k0:
            acc += part
    return acc if out is None else out.copy_(acc)


def _check(c, a, b, out, beta):
    dtype = _build.kernel_dtype("gemm A", a)
    device = a.device
    m, k = a.shape if a.dim() == 2 else (None, None)
    _build.check_matrix("gemm A", a, dtype, device)
    _build.check_matrix("gemm B", b, dtype, device)
    if b.shape[0] != k:
        raise ValueError(f"gemm: A is {tuple(a.shape)} but B is "
                         f"{tuple(b.shape)}")
    shape = (m, b.shape[1])
    for what, t in (("C", c if beta != 0.0 else None), ("out", out)):
        if t is not None:
            _build.check_matrix(f"gemm {what}", t, dtype, device)
            if tuple(t.shape) != shape:
                raise ValueError(f"gemm {what} is {tuple(t.shape)}, "
                                 f"expected {shape}")
    return dtype, device, shape


def plan(m: int, n: int, k: int, dtype: torch.dtype,
         device: Optional[torch.device] = None) -> dict:
    """How the kernel runs an (m × k)·(k × n) product on a CUDA device: its
    tile, the number of K chunks, the mapping of chunks onto blocks
    (``single``: one chunk; ``in_block``: each block loops over the chunks;
    ``across``: each chunk on its own blocks, then a second kernel adds them)
    and the workspace elements ``across`` needs.  Builds the library."""
    out = (ctypes.c_int64 * 6)()
    fn = _build.function(_LIB, f"repro_gemm_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(device or torch.device("cuda")):
        err = fn(m, n, k, out)
    _build.check_launch(_LIB, err, "gemm plan")
    return {"tile": [out[0], out[1]], "chunks": out[2],
            "mapping": MAPPINGS[out[3]], "workspace": out[4], "kc": out[5]}


def _launch(c, a, b, alpha, beta, out) -> torch.Tensor:
    dtype, device, (m, n) = _check(c, a, b, out, beta)
    if out is None:
        out = torch.empty((m, n), dtype=dtype, device=device)
    if device.type == "cpu":
        return gemm_accum_plain(c, a, b, alpha=alpha, beta=beta, out=out)
    if m == 0 or n == 0:
        return out
    k = a.shape[1]
    if alpha not in (1.0, -1.0):
        # the kernel negates A or not; any other α is folded into A with the
        # plain version's rounding of α·a
        a, alpha = a * alpha, 1.0
    work = None
    if k > KC:
        need = plan(m, n, k, dtype, device)["workspace"]
        if need:
            work = torch.empty(need, dtype=dtype, device=device)
    fn = _build.function(_LIB, f"repro_gemm_{_build.SUFFIX[dtype]}",
                         _RUN_ARGS)
    src = c if beta != 0.0 else out
    with _build.device_guard(device):
        err = fn(m, n, k, alpha, _build.ptr(a), _build.ld(a),
                 _build.ptr(b), _build.ld(b), beta, _build.ptr(src),
                 _build.ld(src), _build.ptr(out), _build.ld(out),
                 None if work is None else _build.ptr(work),
                 0 if work is None else work.numel(),
                 _build.stream_of(device))
    _build.check_launch(_LIB, err, "gemm kernel launch")
    gemm_accum.launches += 1
    return out


def gemm_accum(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
               alpha: float = -1.0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``O = C + α·A·B`` — the trailing update; ``out=c`` updates in place."""
    return _launch(c, a, b, float(alpha), 1.0, out)


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C = A·B`` through the same kernel (β = 0)."""
    return _launch(None, a, b, 1.0, 0.0, out)


def gemm_chain(c: Optional[torch.Tensor], a: torch.Tensor, b: torch.Tensor,
               *, alpha: float = -1.0, beta: float = 1.0) -> torch.Tensor:
    """The kernel's contract on the card, one thread an element: the
    chunked sum of :func:`gemm_accum_plain` with each step one FMA, as the
    kernel rounds it.  A check, on no path: the tile kernel must equal it
    bitwise (in float64 that holds DMMA to the DFMA chain).  CUDA tensors
    only; launches are not counted."""
    dtype, device, (m, n) = _check(c, a, b, None, beta)
    if device.type != "cuda":
        raise ValueError("gemm_chain runs on a CUDA device only")
    out = torch.empty((m, n), dtype=dtype, device=device)
    src = c if beta != 0.0 else out
    fn = _build.function(_LIB, f"repro_gemm_chain_{_build.SUFFIX[dtype]}",
                         _CHAIN_ARGS)
    with _build.device_guard(device):
        err = fn(m, n, a.shape[1], float(alpha), _build.ptr(a), _build.ld(a),
                 _build.ptr(b), _build.ld(b), float(beta), _build.ptr(src),
                 _build.ld(src), _build.ptr(out), _build.ld(out),
                 _build.stream_of(device))
    _build.check_launch(_LIB, err, "gemm chain launch")
    return out


#: Launches of the GEMM kernel (``gemm`` and ``gemm_accum`` share it), one
#: a call, the across mapping's second kernel included.
gemm_accum.launches = 0
