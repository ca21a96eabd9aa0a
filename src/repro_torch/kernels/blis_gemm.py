"""GEMM and GEMM-accumulate: ``O = β·C + α·A·B``.

Kernel: ``csrc/gemm.cu`` (CUDA C++ for sm_90a), one kernel for both of the
reference's TPU kernels ``repro/kernels/blis_gemm.py::blis_gemm`` (β = 0)
and ``::blis_gemm_accum`` (β = 1, the DMF trailing update).  The source
note there says what bounds it on an H100 and how its design answers that.

Each output element starts from ``β·C`` and adds its K products in
ascending k with one accumulator, whatever M, N or the tile — so the
kernel is column- and row-decomposable, the property that keeps every
look-ahead schedule bitwise equal to the blocked one.  The plain PyTorch
version :func:`gemm_accum_plain` runs the same ascending-k sum, one
rank-1 term per step; it differs from the kernel only in rounding the
product before the add (the kernel fuses them in an FMA).  Unlike the
reference's f32 accumulator (a limit of the TPU's matrix unit), both
compute and accumulate at the input dtype.

Wrappers take the plain version only for CPU tensors; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["gemm", "gemm_accum", "gemm_accum_plain"]

_LIB = "gemm"
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_f64,
         _build.c_ptr, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_f64, _build.c_ptr, _build.c_i64, _build.c_ptr,
         _build.c_i64, _build.c_ptr]


def gemm_accum_plain(c: Optional[torch.Tensor], a: torch.Tensor,
                     b: torch.Tensor, *, alpha: float = -1.0,
                     beta: float = 1.0,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``β·C + α·A·B`` as the kernel sums it: ascending k, one accumulator.

    Elementwise ops only (each a single rounding), so every element is
    computed the same way whatever the shape of the call.
    """
    m, n = a.shape[0], b.shape[1]
    if beta == 0.0:
        acc = torch.zeros((m, n), dtype=a.dtype, device=a.device)
    else:
        acc = c * beta if beta != 1.0 else c.clone()
    for p in range(a.shape[1]):
        acc += (a[:, p : p + 1] * alpha) * b[p : p + 1, :]
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


def _launch(c, a, b, alpha, beta, out) -> torch.Tensor:
    dtype, device, (m, n) = _check(c, a, b, out, beta)
    if out is None:
        out = torch.empty((m, n), dtype=dtype, device=device)
    if device.type == "cpu":
        return gemm_accum_plain(c, a, b, alpha=alpha, beta=beta, out=out)
    if m == 0 or n == 0:
        return out
    fn = _build.function(_LIB, f"repro_gemm_{_build.SUFFIX[dtype]}", _ARGS)
    src = c if beta != 0.0 else out
    with torch.cuda.device(device):
        err = fn(m, n, a.shape[1], alpha, _build.ptr(a), _build.ld(a),
                 _build.ptr(b), _build.ld(b), beta, _build.ptr(src),
                 _build.ld(src), _build.ptr(out), _build.ld(out),
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


#: Launches of the GEMM kernel (``gemm`` and ``gemm_accum`` share it).
gemm_accum.launches = 0
