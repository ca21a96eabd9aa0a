"""GETF2 panel factorization with partial pivoting.

Kernel: ``csrc/panel_lu.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_lu.py::lu_panel``.  The source note there says
what bounds it on an H100 and how its design answers that: the panel stays
in device memory and a cooperative grid factors it with one grid-wide
barrier per column, since a main-path panel (8192 × 128) is far larger than
one block's shared memory.  Every panel size goes to the kernel; there is
no size at which a GPU panel takes another path.

The plain PyTorch version is :func:`repro_torch.core.lu.lu_unblocked` —
as in the reference, where the TPU kernel's body is ``lu_unblocked``.
Its update rounds each product and difference once, as the kernel does, so
on the same inputs the two agree bit for bit, pivots included.

Semantics: the panel (an ``m × nb`` view, unit stride in its last
dimension) is factored **in place** into the packed L\\U; the function
returns the panel-relative int32 pivots (rows ``j`` and ``piv[j]`` were
interchanged at step ``j``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lu import lu_unblocked as lu_panel_plain
from repro_torch.kernels import _build

__all__ = ["lu_panel", "lu_panel_plain"]

_LIB = "panel_lu"
_GRID_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(ctypes.c_int)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_ptr, ctypes.c_int, _build.c_ptr, _build.c_ptr,
         _build.c_ptr, _build.c_ptr, _build.c_ptr]


def lu_panel(panel: torch.Tensor) -> torch.Tensor:
    """Factor ``panel`` in place; return its int32 panel-relative pivots."""
    dtype = _build.kernel_dtype("lu_panel", panel)
    device = panel.device
    _build.check_matrix("lu_panel panel", panel, dtype, device)
    if device.type == "cpu":
        return lu_panel_plain(panel)
    m, nb = panel.shape
    piv = torch.empty(min(m, nb), dtype=torch.int32, device=device)
    if piv.numel() == 0:
        return piv
    sfx = _build.SUFFIX[dtype]
    grid = ctypes.c_int(0)
    with _build.device_guard(device):
        err = _build.function(_LIB, f"repro_panel_lu_grid_{sfx}",
                              _GRID_ARGS)(m, nb, ctypes.byref(grid))
        _build.check_launch(_LIB, err, "lu_panel grid query")
        g = grid.value
        cand = torch.empty(2 * g * nb, dtype=dtype, device=device)
        rowj = torch.empty(2 * nb, dtype=dtype, device=device)
        pval = torch.empty(2 * g, dtype=dtype, device=device)
        pidx = torch.empty(2 * g, dtype=torch.int64, device=device)
        err = _build.function(_LIB, f"repro_panel_lu_{sfx}", _ARGS)(
            m, nb, _build.ptr(panel), _build.ld(panel), _build.ptr(piv), g,
            _build.ptr(cand), _build.ptr(rowj), _build.ptr(pval),
            _build.ptr(pidx), _build.stream_of(device))
    _build.check_launch(_LIB, err, "lu_panel kernel launch")
    lu_panel.launches += 1
    return piv


lu_panel.launches = 0
