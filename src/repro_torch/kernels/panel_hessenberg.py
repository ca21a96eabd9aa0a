"""Hessenberg panel (xLAHR2): reduce columns ``k .. k+bk`` of an n × n matrix.

Kernel: ``csrc/panel_hessenberg.cu`` (CUDA C++ for sm_90a), replacing the
TPU kernel ``repro/kernels/panel_hessenberg.py::hessenberg_panel``.  The
source note there says what bounds it on an H100 (``W[:, j] = A·v_j``
streams the trailing part of the matrix once per column: the TPU kept the
matrix in VMEM, and a 512 MiB matrix cannot stay on this card's chip) and
how its design answers that: a cooperative grid over the matrix's rows,
four grid-wide barriers per column, deterministic reductions.

:func:`hessenberg_panel` ``(a, k, bk) -> (a, v, t, w, tau)`` — the
reference's contract (``repro.kernels.panels.hessenberg_panel``), with the
square matrix ``a`` (unit stride in its last dimension) updated **in
place**: only its columns ``k .. k+bk-1`` change.  ``v`` and ``w = A₀·V``
are ``n × bk``, ``t`` is the ``bk × bk`` upper-triangular LARFT factor and
``tau`` has ``bk`` entries; the columns ``kj >= n − 2`` have no rows to
reduce and get ``tau = 0``, ``v = 0``.  ``k`` is an ordinary argument of
the launch, so one build serves every panel.

The plain PyTorch version :func:`hessenberg_panel_plain` is the
reference's sweep (``repro/kernels/panels.py::_hessenberg_sweep``) as a
loop of PyTorch ops: the right update through the running W, the left
compact-WY apply, the reflector, the T column and the GEMV
``W[:, j] = A·v_j`` over the columns right of ``kj`` (``v_j`` is zero at
``kj`` and before, so column ``kj``, already overwritten, is never read).
Its reductions group differently from the kernel's, so the two agree to a
relative bound.  On CPU tensors the wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises, whatever the size.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qr import householder_vector
from repro_torch.kernels import _build

__all__ = ["hessenberg_panel", "hessenberg_panel_plain"]

_LIB = "panel_hessenberg"
_GRID_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(ctypes.c_int)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_ptr,
         _build.c_i64, _build.c_ptr, _build.c_ptr, _build.c_ptr,
         _build.c_ptr, ctypes.c_int, _build.c_ptr, _build.c_ptr]


def _outputs(a: torch.Tensor, bk: int):
    n = a.shape[0]
    kw = dict(dtype=a.dtype, device=a.device)
    return (torch.zeros((n, bk), **kw), torch.zeros((bk, bk), **kw),
            torch.zeros((n, bk), **kw), torch.zeros(bk, **kw))


def hessenberg_panel_plain(a: torch.Tensor, k: int, bk: int):
    """The xLAHR2 sweep as PyTorch ops, in place; ``(a, v, t, w, tau)``."""
    n = a.shape[0]
    v, t, w, tau = _outputs(a, bk)
    rows = torch.arange(n, device=a.device)
    for j in range(bk):
        kj = k + j
        # right update: col −= W·(T·V[kj, :]ᵀ), then the left compact-WY
        # apply: col −= V·Tᵀ·(Vᵀ·col); columns ≥ j of W, T, V are zero
        col = a[:, kj] - w[:, :j] @ (t[:j, :j] @ v[kj, :j])
        col = col - v[:, :j] @ (t[:j, :j].mT @ (v[:, :j].mT @ col))
        if kj >= n - 2:           # no rows below kj+1 to reduce
            a[:, kj] = col
            continue
        vj, tau_j, beta = householder_vector(col, kj + 1)
        newcol = torch.where(rows > kj + 1, vj, col)
        newcol[kj + 1] = beta
        a[:, kj] = newcol
        v[:, j] = vj
        tau[j] = tau_j
        t[:j, j] = -tau_j * (t[:j, :j] @ (v[:, :j].mT @ vj))
        t[j, j] = tau_j
        # W column j = A₀·v_j: columns ≥ kj+1 are untouched so far
        w[:, j] = a[:, kj + 1 :] @ vj[kj + 1 :]
    return a, v, t, w, tau


def _grid(sfx: str, n: int, bk: int) -> int:
    """The cooperative grid the kernel takes for an ``n``-row matrix."""
    grid = ctypes.c_int(0)
    err = _build.function(_LIB, f"repro_hessenberg_panel_grid_{sfx}",
                          _GRID_ARGS)(n, bk, ctypes.byref(grid))
    _build.check_launch(_LIB, err, "hessenberg_panel grid query")
    return grid.value


def hessenberg_panel(a: torch.Tensor, k: int, bk: int):
    """xLAHR2 over columns ``k .. k+bk`` of ``a`` in place;
    ``(a, v, t, w, tau)``."""
    dtype = _build.kernel_dtype("hessenberg_panel", a)
    device = a.device
    _build.check_matrix("hessenberg_panel A", a, dtype, device)
    n = a.shape[0]
    if a.shape[1] != n:
        raise ValueError(f"hessenberg_panel: A must be square, got "
                         f"{tuple(a.shape)}")
    if not (0 <= k and 0 <= bk and k + bk <= n):
        raise ValueError(f"hessenberg_panel: columns [{k}, {k + bk}) "
                         f"outside [0, {n})")
    if device.type == "cpu":
        return hessenberg_panel_plain(a, k, bk)
    v, t, w, tau = _outputs(a, bk)
    if bk == 0:
        return a, v, t, w, tau
    sfx = _build.SUFFIX[dtype]
    with _build.device_guard(device):
        g = _grid(sfx, n, bk)
        # the column (n), v_j (n), partials of Vᵀ·col and Vᵀ·v_j (2·g·bk)
        # and of the norm (g) — the layout ``csrc/panel_hessenberg.cu`` reads
        ws = torch.empty(2 * n + 2 * g * bk + g, dtype=dtype, device=device)
        err = _build.function(_LIB, f"repro_hessenberg_panel_{sfx}", _ARGS)(
            n, k, bk, _build.ptr(a), _build.ld(a), _build.ptr(v),
            _build.ptr(t), _build.ptr(w), _build.ptr(tau), g,
            _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "hessenberg_panel kernel launch")
    hessenberg_panel.launches += 1
    return a, v, t, w, tau


hessenberg_panel.launches = 0
