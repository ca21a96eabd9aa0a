"""QR panel with column pivoting (xLAQPS), global and windowed.

Kernel: ``csrc/panel_qrcp.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernel ``repro/kernels/panel_qrcp.py::qrcp_panel``.  The source note there
says what bounds it on an H100 (the global path's per-step pass over a
block no on-chip memory holds; a ``qrcp_local`` window's chain of
dependent steps) and how its design answers that: a cooperative grid of at
most one block an SM over the block's rows, each block's rows kept in
shared memory where they fit (the ``resident`` route, e.g. the 16384 × 128
window) else ``streamed`` from device memory (the 16384 × 4096 global
block), the rows in chunks of 32 dealt round-robin over the blocks and one
chain a column sum, so a padded block gives its real part the
raw block's bits and pivots at every height, the columns owned by the
first blocks, two grid barriers a step,
every cross-block sum a warp's in a fixed order, so a block gives the same
bits and the same pivots on every run.

:func:`qrcp_panel` ``(block, steps) -> (block, v, f, tau, piv)`` — the
reference's contract (``repro.kernels.panels.qrcp_panel``), with the block
(an ``r × c`` view, unit stride in its last dimension) updated **in
place**.  ``v`` is ``r × steps``; ``f`` is ``c × steps`` but stored as
``Fᵀ`` (``f`` is the transposed view of a contiguous ``steps × c``
tensor), so the trailing update's ``Fᵀ`` operand has the unit stride the
GEMM kernel needs without a copy; ``piv`` holds panel-relative int32
column interchanges.  Global QRCP hands it the whole trailing block,
``qrcp_local`` the bare ``steps``-column window — the same entry.
:func:`plan` shows how a shape runs: the route, the grid, the rows a
block at most, the owner blocks, the workspace and ``chain``, the longest chain of
terms one element's value is summed through in a step (the ``c`` of the
kernel's 4·c·eps bound against the plain version); a shape whose shared
memory cannot fit (more than about 4700 steps in f64) is refused with a
ValueError before any launch.

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
import functools
from typing import Optional

import torch

from repro_torch.core.qr import _reflector, pairwise_sum
from repro_torch.kernels import _build

__all__ = ["qrcp_panel", "qrcp_panel_plain", "plan"]

_LIB = "panel_qrcp"
_PLAN_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64,
              ctypes.POINTER(_build.c_i64)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_ptr,
         _build.c_i64, _build.c_ptr, _build.c_ptr, _build.c_ptr,
         _build.c_ptr, ctypes.c_int, ctypes.c_int, _build.c_i64,
         ctypes.c_int, ctypes.c_int, _build.c_ptr, _build.c_ptr]


def _outputs(block: torch.Tensor, steps: int):
    r, c = block.shape
    kw = dict(dtype=block.dtype, device=block.device)
    return (torch.zeros((r, steps), **kw), torch.zeros((steps, c), **kw),
            torch.zeros(steps, **kw),
            torch.zeros(steps, dtype=torch.int32, device=block.device))


def qrcp_panel_plain(block: torch.Tensor, steps: int):
    """The xLAQPS sweep as PyTorch ops, in place; ``(block, v, f, tau,
    piv)`` with ``f = Fᵀ.mT`` as the kernel returns it.  Every sum is
    :func:`~repro_torch.core.qr.pairwise_sum`'s over elementwise products,
    so an element's value depends only on its own terms, never on how many
    rows or columns the block has."""
    v, ft, tau, piv = _outputs(block, steps)
    vn = pairwise_sum(block * block)
    for j in range(steps):
        # greedy pivot: the first largest remaining partial norm
        p = j + int(torch.argmax(vn[j:]))
        piv[j] = p
        if p != j:
            for t in (block, ft):
                t[:, [j, p]] = t[:, [p, j]]
            vn[[j, p]] = vn[[p, j]]
        # bring column j current: rows j: get reflectors 0..j-1
        col = block[j:, j] - pairwise_sum(v[j:, :j] * ft[:j, j][None, :], 1)
        # reflector j
        t, beta, denom = _reflector(col, col[0])
        vj = col / denom
        vj[0] = 1.0
        v[j:, j] = vj
        tau[j] = t
        block[j + 1 :, j] = vj[1:]
        block[j, j] = beta
        # F[:, j] = tau·(Bᵀ·v − F·(Vᵀ·v))
        vtv = pairwise_sum(vj[:, None] * v[j:, :j])
        ft[j] = t * (pairwise_sum(vj[:, None] * block[j:])
                     - pairwise_sum(vtv[:, None] * ft[:j]))
        # pivot row j of every trailing column, then the exact downdate
        rowj = block[j, j + 1 :] - pairwise_sum(
            v[j, : j + 1, None] * ft[: j + 1, j + 1 :])
        block[j, j + 1 :] = rowj
        vn[j + 1 :] = torch.clamp(vn[j + 1 :] - rowj * rowj, min=0.0)
        vn[: j + 1] = 0.0
    return block, v, ft.mT, tau, piv


def _tree(terms: int, lanes: int) -> int:
    """Shuffle steps of a butterfly over ``lanes`` lanes that add a term:
    lanes beyond ``terms`` hold zeros, whose additions are exact."""
    return max(min(terms, lanes) - 1, 0).bit_length()


def _chain(grid: int, rows: int, steps: int, lg: int) -> int:
    """Longest chain of terms one element's value is summed through in a
    step: column j brought current (up to ``steps − 1`` terms over 2^lg
    lanes, the butterfly, the subtraction), the block's column sum (one
    chain over its ``rows``), the cross-block sum (⌈G/32⌉ block partials a
    lane, the butterfly), w (two operations) and the F recurrence (up to
    ``steps − 1`` terms over 32 lanes, the butterfly, two operations)."""
    t = steps - 1
    bring = -(-t // (1 << lg)) + _tree(t, 1 << lg) + 1
    cross = -(-grid // 32) + _tree(grid, 32)
    return bring + rows + cross + 2 + (-(-t // 32) + _tree(t, 32) + 2)


@functools.lru_cache(maxsize=None)
def _plan(r: int, c: int, steps: int, dtype: torch.dtype, index: int) -> dict:
    out = (_build.c_i64 * 11)()
    fn = _build.function(_LIB, f"repro_qrcp_panel_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(r, c, steps, out)
    if err and 0 < out[8] < steps:
        raise ValueError(f"panel_qrcp: the kernel takes at most {out[8]} "
                         f"steps of {dtype} on this card (its shared "
                         f"memory), got {steps}")
    if err == _build.NO_FIT:
        raise ValueError(f"panel_qrcp: {r} x {c} with {steps} steps of "
                         f"{dtype} runs no block an SM on this card")
    _build.check_launch(_LIB, err, f"qrcp_panel plan for {r} x {c}, "
                                   f"{steps} steps")
    return {"route": "resident" if out[1] else "streamed", "grid": out[0],
            "chunk": out[2], "smem_bytes": out[3], "workspace_bytes": out[4],
            "threads": out[5], "owners": out[6], "v_rows_shared": bool(out[9]),
            "rows": out[10], "chain": _chain(out[0], out[10], steps, out[7])}


def plan(r: int, c: int, steps: int, dtype: torch.dtype, *,
         device: Optional[torch.device] = None) -> dict:
    """How ``steps`` steps over an ``r × c`` block run on a CUDA device:
    ``route`` (``resident`` or ``streamed``), ``grid`` blocks of
    ``threads`` (at most one an SM), the rows of a dealt chunk (``chunk``,
    32 at every height) and of a block at most (``rows``), the blocks that
    own columns (``owners``), dynamic shared memory a block, whether a
    streamed block keeps V's rows in it (``v_rows_shared``), workspace
    bytes, and ``chain``, the c of the 4·c·eps bound.  Builds the library;
    cached per shape; a ValueError where the steps' shared memory cannot
    fit."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_plan(r, c, steps, dtype, index))


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
    p = _plan(r, c, steps, dtype, device.index)
    ws = torch.empty(p["workspace_bytes"], dtype=torch.uint8, device=device)
    with _build.device_guard(device):
        err = _build.function(
            _LIB, f"repro_qrcp_panel_{_build.SUFFIX[dtype]}", _ARGS)(
            r, c, steps, _build.ptr(block), _build.ld(block), _build.ptr(v),
            _build.ptr(ft), _build.ptr(tau), _build.ptr(piv), p["grid"],
            int(p["route"] == "resident"), p["smem_bytes"], p["owners"],
            int(p["v_rows_shared"]), _build.ptr(ws), _build.stream_of(device))
    _build.check_launch(_LIB, err, "qrcp_panel kernel launch")
    qrcp_panel.launches += 1
    return block, v, ft.mT, tau, piv


qrcp_panel.launches = 0
