"""Hessenberg panel (xLAHR2): reduce columns ``k .. k+bk`` of an n × n matrix.

Kernel: ``csrc/panel_hessenberg.cu`` (CUDA C++ for sm_90a), replacing the
TPU kernel ``repro/kernels/panel_hessenberg.py::hessenberg_panel``.  The
source note there says what bounds it on an H100 (``W[:, j] = A·v_j``
streams the trailing part of the matrix once a column: the TPU kept the
matrix in VMEM, and a 512 MiB matrix cannot stay on this card's chip) and
how its design answers that: a cooperative grid of one block an SM over
the matrix's rows, T, the block's rows of V and W and the column the GEMV
multiplies by kept in shared memory where they fit, two grid barriers a
column (none after the GEMV), every cross-block sum a warp's in a fixed
order.

:func:`hessenberg_panel` ``(a, k, bk) -> (a, v, t, w, tau)`` — the
reference's contract (``repro.kernels.panels.hessenberg_panel``), with the
square matrix ``a`` (unit stride in its last dimension) updated **in
place**: only its columns ``k .. k+bk-1`` change.  ``v`` and ``w = A₀·V``
are ``n × bk``, ``t`` is the ``bk × bk`` upper-triangular LARFT factor and
``tau`` has ``bk`` entries; the columns ``kj >= n − 2`` have no rows to
reduce and get ``tau = 0``, ``v = 0``.  ``k`` is an ordinary argument of
the launch, so one build serves every panel.  :func:`plan` shows how a
panel runs: the grid, the rows a block, what each block keeps in shared
memory, the workspace and ``chain``, the longest chain of terms one
element of W is summed through in a column (the ``c`` of the kernel's
4·c·eps bound against the plain version); a panel too wide for a block's
shared memory (about 9500 columns in f64) is refused with a ValueError
before any launch.

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
import functools
from typing import Optional

import torch

from repro_torch.core.qr import householder_vector
from repro_torch.kernels import _build
from repro_torch.kernels.panel_qrcp import _tree

__all__ = ["hessenberg_panel", "hessenberg_panel_plain", "plan"]

_LIB = "panel_hessenberg"
_PLAN_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64,
              ctypes.POINTER(_build.c_i64)]
_ARGS = [_build.c_i64, _build.c_i64, _build.c_i64, _build.c_ptr,
         _build.c_i64, _build.c_ptr, _build.c_ptr, _build.c_ptr,
         _build.c_ptr, ctypes.c_int, _build.c_i64,
         ctypes.POINTER(_build.c_i64), _build.c_ptr, _build.c_ptr]
_THREADS, _GROUPS = 512, 16   # threads a block; row groups a column sum at most


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


def _chain(n: int, k: int, bk: int, grid: int, chunk: int, lgr: int,
           lgt: int, segs: int) -> int:
    """Longest chain of terms one element of W is summed through in a
    column, along what it depends on: the right update of its row's column
    entry (up to ``bk − 1`` terms over 2^lgr lanes, the butterfly, the
    subtraction), the block's column sum of Vᵀcol (⌈chunk/g⌉ rows a row
    group, then the groups, at the worst g over the column counts), the
    cross-block sum (⌈G/32⌉ block partials a lane, the butterfly), Tᵀu (up
    to ``bk − 1`` terms over 2^lgt lanes, the butterfly), the left update
    (as the right), the norm (⌈chunk/32⌉ rows a lane, the butterfly, then
    the cross-block sum), the reflector's two operations and the GEMV (the
    ``n − k − 2`` columns past kj+1 over 32·segs lanes, the butterfly, the
    segments in order, the scaling and the first column's term)."""
    t = bk - 1
    upd = -(-t // (1 << lgr)) + _tree(t, 1 << lgr) + 1
    cross = -(-grid // 32) + _tree(grid, 32)
    groups = {min(_THREADS // min(nc, _THREADS), _GROUPS)
              for nc in range(1, bk + 1)}
    colsum = max(-(-chunk // g) + min(g, chunk) - 1 for g in groups)
    tri = -(-t // (1 << lgt)) + _tree(t, 1 << lgt)
    norm = -(-chunk // 32) + _tree(chunk, 32) + cross
    cols = max(n - k - 2, 0)
    gemv = -(-cols // (32 * segs)) + _tree(cols, 32) + segs - 1 + 2
    return upd + colsum + cross + tri + upd + norm + 2 + gemv


@functools.lru_cache(maxsize=None)
def _plan(n: int, k: int, bk: int, dtype: torch.dtype, index: int) -> dict:
    out = (_build.c_i64 * 13)()
    fn = _build.function(
        _LIB, f"repro_hessenberg_panel_plan_{_build.SUFFIX[dtype]}",
        _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(n, k, bk, out)
    if err and 0 < out[12] < bk:
        raise ValueError(f"panel_hessenberg: the kernel takes at most "
                         f"{out[12]} columns of {dtype} at n = {n} on this "
                         f"card (its shared memory), got {bk}")
    if err == _build.NO_FIT:
        raise ValueError(f"panel_hessenberg: n = {n}, {bk} columns of "
                         f"{dtype} run no block an SM on this card")
    _build.check_launch(_LIB, err, f"hessenberg_panel plan for n = {n}, "
                                   f"k = {k}, bk = {bk}")
    layout = (_build.c_i64 * 4)(*out[4:8])
    return {"grid": out[0], "chunk": out[1], "smem_bytes": out[2],
            "workspace": out[3], "threads": out[8],
            "shared": {"t": out[4] >= 0, "v_rows": out[5] >= 0,
                       "w_rows": out[6] >= 0, "x": out[7] >= 0},
            "chain": _chain(n, k, bk, out[0], out[1], out[9], out[10],
                            out[11]),
            "layout": layout}


def plan(n: int, k: int, bk: int, dtype: torch.dtype, *,
         device: Optional[torch.device] = None) -> dict:
    """How the panel of columns ``k .. k+bk`` of an ``n × n`` matrix runs
    on a CUDA device: ``grid`` blocks of ``threads`` (one an SM), rows a
    block (``chunk``), dynamic shared memory a block, what each block keeps
    in it (``shared``: T, its rows of V and W, and ``x``, the column below
    kj+1 the GEMV multiplies by, v_j unscaled; the rest in device memory),
    workspace elements, and ``chain``, the c of the 4·c·eps bound.  Builds the library; cached per shape; a ValueError where the
    panel's shared memory cannot fit."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    p = dict(_plan(n, k, bk, dtype, index))
    del p["layout"]
    p["shared"] = dict(p["shared"])
    return p


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
    p = _plan(n, k, bk, dtype, device.index)
    ws = torch.empty(p["workspace"], dtype=dtype, device=device)
    with _build.device_guard(device):
        err = _build.function(
            _LIB, f"repro_hessenberg_panel_{_build.SUFFIX[dtype]}", _ARGS)(
            n, k, bk, _build.ptr(a), _build.ld(a), _build.ptr(v),
            _build.ptr(t), _build.ptr(w), _build.ptr(tau), p["grid"],
            p["smem_bytes"], p["layout"], _build.ptr(ws),
            _build.stream_of(device))
    _build.check_launch(_LIB, err, "hessenberg_panel kernel launch")
    hessenberg_panel.launches += 1
    return a, v, t, w, tau


hessenberg_panel.launches = 0
