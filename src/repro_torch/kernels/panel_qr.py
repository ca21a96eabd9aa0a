"""Householder QR panel (GEQR2 + LARFT) and its LARFT entry.

Kernel: ``csrc/panel_qr.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_qr.py::qr_panel``.  The source note there says
what bounds it on an H100 and how its design answers that: a cooperative
grid over the panel's rows, two grid-wide barriers per column, every
cross-block sum taken over per-block partials in a fixed order (no
atomics), so a panel gives the same bits on every run.

* :func:`qr_panel` ``(panel) -> (panel, tau, T)`` factors an ``m × nb``
  view (unit stride in its last dimension) **in place** into R and the
  reflectors below the diagonal, and returns ``tau`` (length ``nb``, zero
  beyond ``min(m, nb)``) and the compact-WY ``T`` (``nb × nb``).
* :func:`larft` ``(v, tau) -> T`` runs only the LARFT part of the same
  source on an explicit V; it is part of the same TPU kernel (whose body
  computes T), with a launch count of its own.

The plain PyTorch versions are :func:`repro_torch.core.qr.qr_panel_plain`
(``qr_unblocked`` + ``larft_plain``; the reference's kernel body is
``qr_unblocked`` + ``build_t_matrix``) and ``larft_plain``.  The kernel
and the plain version sum their reductions in different groupings, so
they agree to a relative bound, not bitwise.  On CPU tensors the wrappers run the plain
versions; on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qr import larft_plain, qr_panel_plain
from repro_torch.kernels import _build

__all__ = ["qr_panel", "qr_panel_plain", "larft", "larft_plain"]

_LIB = "panel_qr"
_GRID_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(ctypes.c_int)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_ptr, _build.c_ptr, ctypes.c_int, _build.c_ptr,
         _build.c_ptr]


def _grid(symbol: str, m: int, nb: int) -> int:
    grid = ctypes.c_int(0)
    err = _build.function(_LIB, symbol, _GRID_ARGS)(m, nb, ctypes.byref(grid))
    _build.check_launch(_LIB, err, f"{symbol} grid query")
    return grid.value


def _workspace(nb: int, g: int, dtype, device) -> torch.Tensor:
    """Partials of w (g·nb) and of the norm (g), of the Gram (g·P) and the
    Gram (P), P = nb·(nb − 1)/2 — the layout ``csrc/panel_qr.cu`` reads."""
    pairs = nb * (nb - 1) // 2
    return torch.empty(g * nb + g + g * pairs + pairs, dtype=dtype,
                       device=device)


def qr_panel(panel: torch.Tensor):
    """Factor ``panel`` in place; return ``(panel, tau, T)``."""
    dtype = _build.kernel_dtype("qr_panel", panel)
    device = panel.device
    _build.check_matrix("qr_panel panel", panel, dtype, device)
    if device.type == "cpu":
        return qr_panel_plain(panel)
    m, nb = panel.shape
    tau = torch.zeros(nb, dtype=dtype, device=device)
    t = torch.zeros((nb, nb), dtype=dtype, device=device)
    if m == 0 or nb == 0:
        return panel, tau, t
    sfx = _build.SUFFIX[dtype]
    with _build.device_guard(device):
        g = _grid(f"repro_qr_panel_grid_{sfx}", m, nb)
        ws = _workspace(nb, g, dtype, device)
        err = _build.function(_LIB, f"repro_qr_panel_{sfx}", _ARGS)(
            m, nb, _build.ptr(panel), _build.ld(panel), _build.ptr(tau),
            _build.ptr(t), g, _build.ptr(ws), _build.stream_of(device))
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
    t = torch.zeros((nb, nb), dtype=dtype, device=device)
    if m == 0 or nb == 0:
        return t
    tau = tau.contiguous()
    sfx = _build.SUFFIX[dtype]
    with _build.device_guard(device):
        g = _grid(f"repro_larft_grid_{sfx}", m, nb)
        ws = _workspace(nb, g, dtype, device)
        err = _build.function(_LIB, f"repro_larft_{sfx}", _ARGS)(
            m, nb, _build.ptr(v), _build.ld(v), _build.ptr(tau),
            _build.ptr(t), g, _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "larft kernel launch")
    larft.launches += 1
    return t


qr_panel.launches = 0
larft.launches = 0
