"""Triangular solves (left, right transposed) and the fused small LU solve.

Kernels: ``csrc/trsm.cu`` (CUDA C++ for sm_90a), one strip kernel for all
three.

* :func:`trsm` replaces the TPU kernel
  ``repro/kernels/trsm.py::trsm_left_lower`` (``L·X = B``, unit or not) and
  adds the upper mode (``U·X = B``) that the reference sends to its
  library solve — the back sweep of ``lu_solve_packed``.
* :func:`trsm_right_lower_t` replaces
  ``repro/kernels/trsm.py::trsm_right_lower_t`` (``X·Lᵀ = B``, the
  Cholesky L21 solve).  The reference transposes around its left kernel;
  here each row of B is one right-hand side, staged transposed in shared
  memory, so both modes run one kernel.
* :func:`lu_solve_small` replaces ``repro/kernels/trsm.py::lu_solve_small``:
  forward unit-lower then backward upper substitution on a packed LU in
  one launch; the solve drivers send it n ≤ :data:`SMALL_SOLVE_MAX_N`.
  The strip kernel walks the unit-lower strips top-down, then the upper
  strips bottom-up, on one x tile in shared memory: B read once, X
  written once.

What bounds them on an H100 is latency: every element of X is a chain of
up to b dependent FMAs, while the bytes (B read, X written once) take
about 5 µs at 128 × 8064 in f64.  The kernel therefore works in strips
(the note in ``trsm.cu`` gives the details): a block owns a tile of NC
right-hand sides and all b rows of them in shared memory, walks the
triangle in strips of R rows (top-down for lower, bottom-up for upper),
solves each strip's R × R diagonal block one thread a right-hand side,
then applies the strip to the rows not yet solved with every thread.
Any b runs: where the strips of all b rows would not fit shared memory
beside the tile, they are staged in segments.  :func:`plan` shows the
tile, the strip, the segment, the threads and the shared memory chosen
for a shape (the small LU solve takes the left solve's plan), and the
widest b the card takes (:func:`max_rows`; about 3400 in f64 and 7000 in
f32 on an H100), beyond which the wrappers raise.

The rounding contract is ``solve_vector`` (``csrc/dense.cuh``): each
element starts from B, takes ``fma(-T[i, j], x[j], acc)`` in ascending j
(lower) or descending j (upper), then one division unless the diagonal is
unit.  The strips keep that order term for term, so the kernel equals
:func:`trsm_chain`, the contract run one thread a right-hand side,
bitwise, and :func:`lu_solve_small` equals the unit-lower chain followed by
the upper one; that kernel is a check on no path.  Every column of X so
depends only on T and its own column of B (decomposable, like the GEMM),
and the fused panel updates, which run ``solve_vector`` themselves, stay
bitwise equal to the composed kernels.  The plain PyTorch versions sweep
the columns of the triangle (``x[j] /= T[j, j]``, then
``x[rows] -= T[rows, j]·x[j]``), which subtracts from each row in the same
order; they differ from the kernel only by its FMA rounding, and
:func:`lu_solve_small_plain` is :func:`trsm_plain`'s two sweeps.  Both
compute at the input dtype (the reference's TPU kernel casts to f32).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["trsm", "trsm_plain", "trsm_right_lower_t",
           "trsm_right_lower_t_plain", "lu_solve_small",
           "lu_solve_small_plain", "trsm_chain", "plan", "max_rows",
           "SMALL_SOLVE_MAX_N"]

_LIB = "trsm"
#: Widest system the solve drivers send to :func:`lu_solve_small` (one
#: panel of the default block); the kernel itself takes any
#: :func:`max_rows`.
SMALL_SOLVE_MAX_N = 256
_TRSM_ARGS = [_build.c_i64, _build.c_i64, _build.ctypes.c_int,
              _build.ctypes.c_int, _build.c_ptr, _build.c_i64, _build.c_ptr,
              _build.c_i64, _build.c_ptr, _build.c_i64, _build.c_ptr]
_RIGHT_ARGS = [_build.c_i64, _build.c_i64, _build.ctypes.c_int, _build.c_ptr,
               _build.c_i64, _build.c_ptr, _build.c_i64, _build.c_ptr,
               _build.c_i64, _build.c_ptr]
_CHAIN_ARGS = _TRSM_ARGS[:4] + [_build.ctypes.c_int] + _TRSM_ARGS[4:]
_PLAN_ARGS = [_build.c_i64, _build.c_i64, _build.ctypes.c_int,
              _build.ctypes.POINTER(_build.c_i64)]
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
    if device.type == "cuda" and n > _widest(dtype, right, device.index):
        raise ValueError(f"{what}: the kernel takes at most "
                         f"{_widest(dtype, right, device.index)} rows of "
                         f"{dtype} on this card (its shared memory), got "
                         f"{n}")
    if out is not None:
        _build.check_matrix(f"{what} out", out, dtype, device)
        if out.shape != b.shape:
            raise ValueError(f"{what} out is {tuple(out.shape)}, expected "
                             f"{tuple(b.shape)}")
    return dtype, device


def trsm(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
         unit_diagonal: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``T·X = B`` for lower or upper ``T`` (up to :func:`max_rows`
    rows on the GPU); ``out=b`` solves in place."""
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
    with _build.device_guard(device):
        err = fn(t.shape[0], b.shape[1], int(lower), int(unit_diagonal),
                 _build.ptr(t), _build.ld(t), _build.ptr(b), _build.ld(b),
                 _build.ptr(out), _build.ld(out), _build.stream_of(device))
    _build.check_launch(_LIB, err, "trsm kernel launch")
    trsm.launches += 1
    return out


def trsm_right_lower_t(l: torch.Tensor, b: torch.Tensor, *,
                       unit_diagonal: bool = False,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``X·Lᵀ = B`` for lower ``L`` (up to :func:`max_rows` columns
    of B on the GPU); ``out=b`` solves in place."""
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
    with _build.device_guard(device):
        err = fn(l.shape[0], b.shape[0], int(unit_diagonal), _build.ptr(l),
                 _build.ld(l), _build.ptr(b), _build.ld(b), _build.ptr(out),
                 _build.ld(out), _build.stream_of(device))
    _build.check_launch(_LIB, err, "trsm_right_lower_t kernel launch")
    trsm_right_lower_t.launches += 1
    return out


def trsm_chain(t: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
               unit_diagonal: bool = False, right: bool = False
               ) -> torch.Tensor:
    """The TRSM kernels' rounding contract on the card: ``solve_vector``
    run one thread a right-hand side (``T·X = B``, or ``X·Tᵀ = B`` for a
    lower T when ``right``).  A check, on no path: :func:`trsm` and
    :func:`trsm_right_lower_t` must equal it bitwise.  CUDA tensors only;
    launches are not counted."""
    if right and not lower:
        raise ValueError("trsm_chain: the right mode solves X·Lᵀ = B for a "
                         "lower L only")
    dtype, device = _check("trsm_chain", t, b, None, right=right)
    if device.type != "cuda":
        raise ValueError("trsm_chain runs on a CUDA device only")
    out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = _build.function(_LIB, f"repro_trsm_chain_{_build.SUFFIX[dtype]}",
                         _CHAIN_ARGS)
    with _build.device_guard(device):
        err = fn(t.shape[0], b.shape[0 if right else 1], int(lower),
                 int(unit_diagonal), int(right), _build.ptr(t), _build.ld(t),
                 _build.ptr(b), _build.ld(b), _build.ptr(out), _build.ld(out),
                 _build.stream_of(device))
    _build.check_launch(_LIB, err, "trsm chain launch")
    return out


def _index(device: Optional[torch.device]) -> int:
    device = torch.device(device or "cuda")
    return device.index if device.index is not None \
        else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _plan(rows: int, rhs: int, dtype: torch.dtype, right: bool,
          index: int) -> tuple:
    out = (_build.c_i64 * 7)()
    fn = _build.function(_LIB, f"repro_trsm_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(rows, rhs, int(right), out)
    if err and 0 < out[6] < rows:
        raise ValueError(f"trsm: the kernel takes at most {out[6]} rows of "
                         f"{dtype} on this card (its shared memory), got "
                         f"{rows}")
    _build.check_launch(_LIB, err, f"trsm plan for {rows} x {rhs}")
    return tuple(out)


def plan(rows: int, rhs: int, dtype: torch.dtype, *, right: bool = False,
         device: Optional[torch.device] = None) -> dict:
    """How the TRSM kernel solves ``rhs`` right-hand sides of ``rows``
    elements on a CUDA device: right-hand sides per block (``nc``), strip
    rows (``r``), threads and blocks, dynamic shared memory a block, the
    rows of the triangle a step stages (``segment_rows``: all of them,
    rounded up to whole strips, where they fit) and the widest triangle
    the card takes (``max_rows``).  Builds the library; cached per
    shape."""
    out = _plan(rows, rhs, dtype, bool(right), _index(device))
    return {"nc": out[0], "r": out[1], "threads": out[2],
            "smem_bytes": out[3], "blocks": out[4], "segment_rows": out[5],
            "max_rows": out[6]}


@functools.lru_cache(maxsize=None)
def _widest(dtype: torch.dtype, right: bool, index: int) -> int:
    return _plan(1, 1, dtype, right, index)[6]


def max_rows(dtype: torch.dtype, *, right: bool = False,
             device: Optional[torch.device] = None) -> int:
    """The widest triangle the TRSM kernels take on a CUDA device: an x
    tile of 8 right-hand sides and two strip buffers of one strip's
    segment in one block's shared memory."""
    return _widest(dtype, bool(right), _index(device))


def lu_solve_small(lu: torch.Tensor, b: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``L·U·X = B`` from a packed (already row-permuted) LU, both
    sweeps in one launch."""
    dtype, device = _check("lu_solve_small", lu, b, out)
    if device.type == "cpu":
        return lu_solve_small_plain(lu, b, out=out)
    if out is None:
        out = torch.empty_like(b)
    if b.numel() == 0:
        return out
    fn = _build.function(_LIB, f"repro_lu_solve_{_build.SUFFIX[dtype]}",
                         _SOLVE_ARGS)
    with _build.device_guard(device):
        err = fn(lu.shape[0], b.shape[1], _build.ptr(lu), _build.ld(lu),
                 _build.ptr(b), _build.ld(b), _build.ptr(out), _build.ld(out),
                 _build.stream_of(device))
    _build.check_launch(_LIB, err, "lu_solve_small kernel launch")
    lu_solve_small.launches += 1
    return out


trsm.launches = 0
trsm_right_lower_t.launches = 0
lu_solve_small.launches = 0
