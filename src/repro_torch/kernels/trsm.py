"""Triangular solves (left, right transposed) and the fused small LU solve.

Kernels: ``csrc/trsm.cu`` (CUDA C++ for sm_90a).

* :func:`trsm` replaces the TPU kernel
  ``repro/kernels/trsm.py::trsm_left_lower`` (``L·X = B``, unit or not) and
  adds the upper mode (``U·X = B``) that the reference sends to its
  library solve — the back sweep of ``lu_solve_packed``.
* :func:`trsm_right_lower_t` replaces
  ``repro/kernels/trsm.py::trsm_right_lower_t`` (``X·Lᵀ = B``, the
  Cholesky L21 solve).  The reference transposes around its left kernel;
  here the same kernel reads each row of B as one right-hand side, by
  stride, with no transposed copy.
* :func:`lu_solve_small` replaces ``repro/kernels/trsm.py::lu_solve_small``:
  forward unit-lower then backward upper substitution on a packed LU
  (n ≤ 256) in one launch.

The source note in ``trsm.cu`` says what bounds them on an H100 and how
their design answers that.  All give every right-hand side to its own
thread, so they are decomposable like the GEMM.  The plain PyTorch
versions sweep the columns of the triangle (``x[j] /= T[j, j]``,
then ``x[rows] -= T[rows, j]·x[j]``), which subtracts from each row in the
same order as the kernel's row sums; the two differ only by the kernel's
FMA rounding.  Both compute at the input dtype (the reference's TPU
kernel casts to f32).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["trsm", "trsm_plain", "trsm_right_lower_t",
           "trsm_right_lower_t_plain", "lu_solve_small",
           "lu_solve_small_plain", "MAX_ROWS"]

_LIB = "trsm"
#: Largest triangle the kernels take (rows of the right-hand side).
MAX_ROWS = 256
_TRSM_ARGS = [_build.c_i64, _build.c_i64, _build.ctypes.c_int,
              _build.ctypes.c_int, _build.c_ptr, _build.c_i64, _build.c_ptr,
              _build.c_i64, _build.c_ptr, _build.c_i64, _build.c_ptr]
_RIGHT_ARGS = [_build.c_i64, _build.c_i64, _build.ctypes.c_int, _build.c_ptr,
               _build.c_i64, _build.c_ptr, _build.c_i64, _build.c_ptr,
               _build.c_i64, _build.c_ptr]
_SOLVE_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
               _build.c_ptr, _build.c_i64, _build.c_ptr, _build.c_i64,
               _build.c_ptr]


def _sweep(t: torch.Tensor, x: torch.Tensor, lower: bool,
           unit: bool) -> torch.Tensor:
    """Column sweep of ``op(T)·X = B`` on ``x`` in place."""
    n = t.shape[0]
    for j in (range(n) if lower else range(n - 1, -1, -1)):
        if not unit:
            x[j] /= t[j, j]
        rows = slice(j + 1, n) if lower else slice(0, j)
        x[rows] -= t[rows, j : j + 1] * x[j : j + 1]
    return x


def trsm_plain(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
               unit_diagonal: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``T·X = B`` (T lower or upper) by the kernel's substitution."""
    x = _sweep(t, b.clone(), lower, unit_diagonal)
    return x if out is None else out.copy_(x)


def trsm_right_lower_t_plain(l: torch.Tensor, b: torch.Tensor, *,
                             unit_diagonal: bool = False,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Solve ``X·Lᵀ = B`` (L lower) by the column sweep on ``Xᵀ``:
    ``L·Xᵀ = Bᵀ``."""
    x = _sweep(l, b.clone().mT, True, unit_diagonal).mT
    return x if out is None else out.copy_(x)


def lu_solve_small_plain(lu: torch.Tensor, b: torch.Tensor, *,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``L·U·X = B`` from the packed LU: unit-lower, then upper."""
    x = _sweep(lu, _sweep(lu, b.clone(), True, True), False, False)
    return x if out is None else out.copy_(x)


def _check(what, t, b, out, right=False):
    """Operands of ``T·X = B`` (or ``X·Tᵀ = B`` when ``right``)."""
    dtype = _build.kernel_dtype(what, b)
    device = b.device
    _build.check_matrix(f"{what} triangle", t, dtype, device)
    _build.check_matrix(f"{what} rhs", b, dtype, device)
    n = t.shape[0]
    if t.shape[1] != n or b.shape[1 if right else 0] != n:
        raise ValueError(f"{what}: triangle {tuple(t.shape)} does not match "
                         f"rhs {tuple(b.shape)}")
    if device.type == "cuda" and n > MAX_ROWS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_ROWS} rows, "
                         f"got {n}")
    if out is not None:
        _build.check_matrix(f"{what} out", out, dtype, device)
        if out.shape != b.shape:
            raise ValueError(f"{what} out is {tuple(out.shape)}, expected "
                             f"{tuple(b.shape)}")
    return dtype, device


def trsm(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
         unit_diagonal: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``T·X = B`` for lower or upper ``T`` (b ≤ 256 rows on the GPU);
    ``out=b`` solves in place."""
    dtype, device = _check("trsm", t, b, out)
    if device.type == "cpu":
        return trsm_plain(t, b, lower=lower, unit_diagonal=unit_diagonal,
                          out=out)
    if out is None:
        out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = _build.function(_LIB, f"repro_trsm_{_build.SUFFIX[dtype]}",
                         _TRSM_ARGS)
    with torch.cuda.device(device):
        err = fn(t.shape[0], b.shape[1], int(lower), int(unit_diagonal),
                 _build.ptr(t), _build.ld(t), _build.ptr(b), _build.ld(b),
                 _build.ptr(out), _build.ld(out), _build.stream_of(device))
    _build.check_launch(_LIB, err, "trsm kernel launch")
    trsm.launches += 1
    return out


def trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor, *,
                       unit_diagonal: bool = False,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``X·Lᵀ = B`` for lower ``L`` (b ≤ 256 columns of B on the
    GPU); ``out=b`` solves in place."""
    dtype, device = _check("trsm_right_lower_t", l, b, out, right=True)
    if device.type == "cpu":
        return trsm_right_lower_t_plain(l, b, unit_diagonal=unit_diagonal,
                                        out=out)
    if out is None:
        out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = _build.function(_LIB, f"repro_trsm_right_{_build.SUFFIX[dtype]}",
                         _RIGHT_ARGS)
    with torch.cuda.device(device):
        err = fn(l.shape[0], b.shape[0], int(unit_diagonal), _build.ptr(l),
                 _build.ld(l), _build.ptr(b), _build.ld(b), _build.ptr(out),
                 _build.ld(out), _build.stream_of(device))
    _build.check_launch(_LIB, err, "trsm_right_lower_t kernel launch")
    trsm_right_lower_t.launches += 1
    return out


def lu_solve_small(lu: torch.Tensor, b: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``L·U·X = B`` from a packed (already row-permuted) LU with
    n ≤ 256, both sweeps in one launch."""
    dtype, device = _check("lu_solve_small", lu, b, out)
    if device.type == "cpu":
        return lu_solve_small_plain(lu, b, out=out)
    if out is None:
        out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = _build.function(_LIB, f"repro_lu_solve_{_build.SUFFIX[dtype]}",
                         _SOLVE_ARGS)
    with torch.cuda.device(device):
        err = fn(lu.shape[0], b.shape[1], _build.ptr(lu), _build.ld(lu),
                 _build.ptr(b), _build.ld(b), _build.ptr(out), _build.ld(out),
                 _build.stream_of(device))
    _build.check_launch(_LIB, err, "lu_solve_small kernel launch")
    lu_solve_small.launches += 1
    return out


trsm.launches = 0
trsm_right_lower_t.launches = 0
lu_solve_small.launches = 0
