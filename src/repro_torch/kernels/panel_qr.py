"""Householder QR panel (GEQR2 + LARFT) and its LARFT entry.

Kernel: ``csrc/panel_qr.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_qr.py::qr_panel``.  The source note there says
what bounds it on an H100 and how its design answers that: a cooperative
grid of at most one block an SM over the panel's rows (chunks of 32 rows
dealt round-robin over the blocks, so a row's block and its place there
depend on the row alone: a panel padded with zero rows sums its real rows
in the same blocks at every height, and a bucketed system's answer is the
raw one's), each block's rows kept in shared memory where they fit (the
``resident`` route, else
``streamed`` from device memory), two grid-wide barriers a column, every
cross-block sum taken over per-block partials in a fixed order (no
atomics), so a panel gives the same bits on every run.

* :func:`qr_panel` ``(panel) -> (panel, tau, T)`` factors an ``m × nb``
  view (unit stride in its last dimension; on the GPU, nb up to what a
  block's shared memory holds 19·nb elements of: 1529 in f64 and 3058 in
  f32 on an H100, a ValueError beyond) **in place** into R and the
  reflectors below the diagonal, and returns ``tau`` (length ``nb``, zero
  beyond ``min(m, nb)``) and the compact-WY ``T`` (``nb × nb``).
* :func:`larft` ``(v, tau) -> T`` runs only the LARFT part of the same
  source on an explicit V, over the same blocks and rows as the panel of
  that shape, so its T is bitwise the panel's for the same V; it is part
  of the same TPU kernel (whose body computes T), with a launch count of
  its own.
* :func:`plan` shows the route, the blocks, the rows of a chunk and of a
  block and the longest chain of terms one output element sums in turn (the ``k`` of the
  bound below).

The plain PyTorch versions are :func:`repro_torch.core.qr.qr_panel_plain`
(``qr_unblocked`` + ``larft_plain``; the reference's kernel body is
``qr_unblocked`` + ``build_t_matrix``) and ``larft_plain``.  The kernel
and the plain version sum their reductions in different groupings, so
they agree to a relative bound (4·k·eps, k from :func:`plan`), not
bitwise.  On CPU tensors the wrappers run the plain versions; on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.qr import larft_plain, qr_panel_plain
from repro_torch.kernels import _build

__all__ = ["qr_panel", "qr_panel_plain", "larft", "larft_plain", "plan"]

_LIB = "panel_qr"
_PLAN_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(_build.c_i64)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_ptr, _build.c_ptr, ctypes.c_int, ctypes.c_int,
         _build.c_i64, _build.c_ptr, _build.c_ptr]
_LARFT_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
               _build.c_ptr, _build.c_ptr, ctypes.c_int, _build.c_i64,
               _build.c_ptr, _build.c_ptr]
_WARPS = 16   # warps a block (``csrc/panel_qr.cu``), for the chain count


def _chain(grid: int, rows: int, nb: int) -> int:
    """Longest chain of terms one output element sums in turn: a Gram entry
    sums a block's ``rows``, then a lane ``⌈G/32⌉`` block partials and five
    shuffle steps, then a T entry up to ``nb − 1`` recurrence terms;
    GEQR2's sums (a warp's rows, the warps, the blocks, then the
    reflector's two operations) are shorter."""
    cross = -(-grid // 32) + 5
    return max(-(-rows // _WARPS) + _WARPS + cross + 2, rows + cross + nb - 1)


@functools.lru_cache(maxsize=None)
def _plan(m: int, nb: int, dtype: torch.dtype, index: int) -> dict:
    out = (_build.c_i64 * 9)()
    fn = _build.function(_LIB, f"repro_qr_panel_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(m, nb, out)
    if err and 0 < out[7] < nb:
        raise ValueError(f"panel_qr: the kernel takes at most {out[7]} "
                         f"columns of {dtype} on this card (its shared "
                         f"memory), got {nb}")
    _build.check_launch(_LIB, err, f"qr_panel plan for {m} x {nb}")
    return {"route": "resident" if out[1] else "streamed", "grid": out[0],
            "chunk": out[2], "smem_bytes": out[3], "larft_smem_bytes": out[4],
            "workspace": out[5], "threads": out[6], "rows": out[8],
            "chain": _chain(out[0], out[8], nb)}


def plan(m: int, nb: int, dtype: torch.dtype, *,
         device: Optional[torch.device] = None) -> dict:
    """How an ``m × nb`` panel runs on a CUDA device: ``route``
    (``resident`` or ``streamed``), ``grid`` blocks of ``threads``, the rows
    of a dealt chunk (``chunk``, 32 at every height) and of a block at most
    (``rows``), dynamic shared memory a block of the panel and of the
    larft kernel, workspace elements, and ``chain``, the k of the 4·k·eps
    bound.  Builds the library; cached per shape."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_plan(m, nb, dtype, index))


def qr_panel(panel: torch.Tensor):
    """Factor ``panel`` in place; return ``(panel, tau, T)``."""
    dtype = _build.kernel_dtype("qr_panel", panel)
    device = panel.device
    _build.check_matrix("qr_panel panel", panel, dtype, device)
    if device.type == "cpu":
        return qr_panel_plain(panel)
    m, nb = panel.shape
    if m == 0 or nb == 0:
        return (panel, torch.zeros(nb, dtype=dtype, device=device),
                torch.zeros((nb, nb), dtype=dtype, device=device))
    # the kernel writes all of tau and T
    tau = torch.empty(nb, dtype=dtype, device=device)
    t = torch.empty((nb, nb), dtype=dtype, device=device)
    p = _plan(m, nb, dtype, device.index)
    ws = torch.empty(p["workspace"], dtype=dtype, device=device)
    with _build.device_guard(device):
        err = _build.function(_LIB, f"repro_qr_panel_{_build.SUFFIX[dtype]}",
                              _ARGS)(
            m, nb, _build.ptr(panel), _build.ld(panel), _build.ptr(tau),
            _build.ptr(t), p["grid"], int(p["route"] == "resident"),
            p["smem_bytes"], _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "qr_panel kernel launch")
    qr_panel.launches += 1
    return panel, tau, t


def larft(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """T (``nb × nb``) with ``H_1…H_nb = I − V·T·Vᵀ`` from an explicit V
    (``m × nb``) and ``tau`` (``nb``)."""
    dtype = _build.kernel_dtype("larft", v)
    device = v.device
    _build.check_matrix("larft V", v, dtype, device)
    nb = v.shape[1]
    if tau.dim() != 1 or tau.shape[0] != nb or tau.dtype != dtype \
            or tau.device != device:
        raise ValueError(f"larft: tau must be a {dtype} vector of {nb} "
                         f"entries on {device}, got {tuple(tau.shape)} "
                         f"{tau.dtype} on {tau.device}")
    if device.type == "cpu":
        return larft_plain(v, tau)
    m = v.shape[0]
    if m == 0 or nb == 0:
        return torch.zeros((nb, nb), dtype=dtype, device=device)
    t = torch.empty((nb, nb), dtype=dtype, device=device)  # written whole
    tau = tau.contiguous()
    p = _plan(m, nb, dtype, device.index)
    ws = torch.empty(p["workspace"], dtype=dtype, device=device)
    with _build.device_guard(device):
        err = _build.function(_LIB, f"repro_larft_{_build.SUFFIX[dtype]}",
                              _LARFT_ARGS)(
            m, nb, _build.ptr(v), _build.ld(v), _build.ptr(tau),
            _build.ptr(t), p["grid"], p["larft_smem_bytes"], _build.ptr(ws),
            _build.stream_of(device))
    _build.check_launch(_LIB, err, "larft kernel launch")
    larft.launches += 1
    return t


qr_panel.launches = 0
larft.launches = 0
