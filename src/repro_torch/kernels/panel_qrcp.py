"""QR panel with column pivoting (xLAQPS), global and windowed.

Kernel: ``csrc/panel_qrcp.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_qrcp.py::qrcp_panel``.  The source note there
says what bounds it on an H100 (the per-step pass over the block: the TPU
kept the block in VMEM, and a 512 MiB block cannot stay on this card's
chip) and how its design answers that: a cooperative grid over the block's
rows, three grid-wide barriers per step, deterministic reductions.

:func:`qrcp_panel` ``(block, steps) -> (block, v, f, tau, piv)`` — the
reference's contract (``repro.kernels.panels.qrcp_panel``), with the block
(an ``r × c`` view, unit stride in its last dimension) updated **in
place**.  ``v`` is ``r × steps``; ``f`` is ``c × steps`` but stored as
``Fᵀ`` (``f`` is the transposed view of a contiguous ``steps × c``
tensor), so the trailing update's ``Fᵀ`` operand has the unit stride the
GEMM kernel needs without a copy; ``piv`` holds panel-relative int32
column interchanges.  Global QRCP hands it the whole trailing block,
``qrcp_local`` the bare ``steps``-column window — the same entry.

The plain PyTorch version :func:`qrcp_panel_plain` is the reference's
sweep (``repro/kernels/panels.py::_qrcp_sweep``) as a loop of PyTorch ops:
greedy pivot (first index on ties, as ``jnp.argmax``), the column swap of
B, F and the norms, column j brought current, the reflector, the
incremental F, the pivot-row update and the exact norm downdate.  Its
reductions group differently from the kernel's, so the two agree to a
relative bound with equal pivots.  On CPU tensors the wrapper runs the
plain version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.qr import _reflector
from repro_torch.kernels import _build

__all__ = ["qrcp_panel", "qrcp_panel_plain"]

_LIB = "panel_qrcp"
_GRID_ARGS = [_build.c_i64, _build.c_i64, ctypes.POINTER(ctypes.c_int)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_ptr,
         _build.c_i64, _build.c_ptr, _build.c_ptr, _build.c_ptr,
         _build.c_ptr, ctypes.c_int, _build.c_ptr, _build.c_ptr]


def _outputs(block: torch.Tensor, steps: int):
    r, c = block.shape
    kw = dict(dtype=block.dtype, device=block.device)
    return (torch.zeros((r, steps), **kw), torch.zeros((steps, c), **kw),
            torch.zeros(steps, **kw),
            torch.zeros(steps, dtype=torch.int32, device=block.device))


def qrcp_panel_plain(block: torch.Tensor, steps: int):
    """The xLAQPS sweep as PyTorch ops, in place; ``(block, v, f, tau,
    piv)`` with ``f = Fᵀ.mT`` as the kernel returns it."""
    v, ft, tau, piv = _outputs(block, steps)
    vn = (block * block).sum(0)
    for j in range(steps):
        # greedy pivot: the first largest remaining partial norm
        p = j + int(torch.argmax(vn[j:]))
        piv[j] = p
        if p != j:
            for t in (block, ft):
                t[:, [j, p]] = t[:, [p, j]]
            vn[[j, p]] = vn[[p, j]]
        # bring column j current: rows j: get reflectors 0..j-1
        col = block[j:, j] - v[j:, :j] @ ft[:j, j]
        # reflector j
        t, beta, denom = _reflector(col, col[0])
        vj = col / denom
        vj[0] = 1.0
        v[j:, j] = vj
        tau[j] = t
        block[j + 1 :, j] = vj[1:]
        block[j, j] = beta
        # F[:, j] = tau·(Bᵀ·v − F·(Vᵀ·v))
        ft[j] = t * (vj @ block[j:] - (vj @ v[j:, :j]) @ ft[:j])
        # pivot row j of every trailing column, then the exact downdate
        rowj = block[j, j + 1 :] - v[j, : j + 1] @ ft[: j + 1, j + 1 :]
        block[j, j + 1 :] = rowj
        vn[j + 1 :] = torch.clamp(vn[j + 1 :] - rowj * rowj, min=0.0)
        vn[: j + 1] = 0.0
    return block, v, ft.mT, tau, piv


def _grid(sfx: str, r: int, steps: int) -> int:
    """The cooperative grid the kernel takes for ``r`` rows."""
    grid = ctypes.c_int(0)
    err = _build.function(_LIB, f"repro_qrcp_panel_grid_{sfx}", _GRID_ARGS)(
        r, steps, ctypes.byref(grid))
    _build.check_launch(_LIB, err, "qrcp_panel grid query")
    return grid.value


def qrcp_panel(block: torch.Tensor, steps: int):
    """xLAQPS over ``block`` in place; ``(block, v, f, tau, piv)``."""
    dtype = _build.kernel_dtype("qrcp_panel", block)
    device = block.device
    _build.check_matrix("qrcp_panel block", block, dtype, device)
    r, c = block.shape
    if not 0 <= steps <= min(r, c):
        raise ValueError(f"qrcp_panel: steps={steps} outside "
                         f"[0, min{tuple(block.shape)}]")
    if device.type == "cpu":
        return qrcp_panel_plain(block, steps)
    v, ft, tau, piv = _outputs(block, steps)
    if steps == 0:
        return block, v, ft.mT, tau, piv
    sfx = _build.SUFFIX[dtype]
    with _build.device_guard(device):
        g = _grid(sfx, r, steps)
        # norms (2c), partials of Bᵀv (g·c), of Vᵀv (g·steps), of the norm (g)
        ws = torch.empty(2 * c + g * c + g * steps + g, dtype=dtype,
                         device=device)
        err = _build.function(_LIB, f"repro_qrcp_panel_{sfx}", _ARGS)(
            r, c, steps, _build.ptr(block), _build.ld(block), _build.ptr(v),
            _build.ptr(ft), _build.ptr(tau), _build.ptr(piv), g,
            _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "qrcp_panel kernel launch")
    qrcp_panel.launches += 1
    return block, v, ft.mT, tau, piv


qrcp_panel.launches = 0
