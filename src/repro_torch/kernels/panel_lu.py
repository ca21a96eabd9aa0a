"""GETF2 panel factorization with partial pivoting.

Kernel: ``csrc/panel_lu.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_lu.py::lu_panel``.  The source note there says
what bounds it on an H100 and how its design answers that: a cooperative
grid of at most one block an SM over the panel's rows, each block's rows
kept in shared memory where they fit (the ``resident`` route, 8192 × 128
in f64 and up to about 27000 rows at nb 128 on an H100), else
``streamed`` from device memory, and one grid barrier a column: each
block publishes its pivot candidate (value, row and a copy of the row),
and after the barrier every block reduces the published candidates in the
same order and reads the winner's row once.
:func:`plan` shows the route, the blocks, the rows a block, the shared
memory and the workspace for a shape; every shape runs, there is no size
at which a GPU panel takes another path.

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
import functools
from typing import Optional

import torch

from repro_torch.core.lu import lu_unblocked as lu_panel_plain
from repro_torch.kernels import _build

__all__ = ["lu_panel", "lu_panel_plain", "plan"]

_LIB = "panel_lu"
_PLAN_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(_build.c_i64)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_ptr, _build.c_i64,
         _build.c_ptr, ctypes.c_int, ctypes.c_int, _build.c_i64,
         _build.c_ptr, _build.c_ptr]


@functools.lru_cache(maxsize=None)
def _plan(m: int, nb: int, dtype: torch.dtype, index: int) -> dict:
    out = (_build.c_i64 * 6)()
    fn = _build.function(_LIB, f"repro_panel_lu_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(m, nb, out)
    _build.check_launch(_LIB, err, f"lu_panel plan for {m} x {nb}")
    return {"route": "resident" if out[1] else "streamed", "grid": out[0],
            "chunk": out[2], "smem_bytes": out[3],
            "workspace_bytes": out[4], "threads": out[5]}


def plan(m: int, nb: int, dtype: torch.dtype, *,
         device: Optional[torch.device] = None) -> dict:
    """How an ``m × nb`` panel runs on a CUDA device: ``route``
    (``resident`` or ``streamed``), ``grid`` blocks of ``threads``, rows a
    block (``chunk``), dynamic shared memory a block and the workspace
    bytes of the published candidates.  Builds the library; cached per
    shape."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_plan(m, nb, dtype, index))


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
    p = _plan(m, nb, dtype, device.index)
    ws = torch.empty(p["workspace_bytes"], dtype=torch.uint8, device=device)
    with _build.device_guard(device):
        err = _build.function(_LIB, f"repro_panel_lu_{_build.SUFFIX[dtype]}",
                              _ARGS)(
            m, nb, _build.ptr(panel), _build.ld(panel), _build.ptr(piv),
            p["grid"], int(p["route"] == "resident"), p["smem_bytes"],
            _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "lu_panel kernel launch")
    lu_panel.launches += 1
    return piv


lu_panel.launches = 0
