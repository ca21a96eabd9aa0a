"""Fused panel updates — the LA_MB (malleable-BLAS) panel step in one kernel.

Kernels: ``csrc/fused_pu.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernels ``repro/kernels/fused_panel_update.py::fused_lu_panel_update`` and
``::fused_cholesky_panel_update``.  In the look-ahead loop, PU(k+1) is the
narrow update of the next panel's columns followed by that panel's
factorization; composed, it is three kernels for LU (TRSM, GEMM, GETF2)
and a GEMM plus the Cholesky panel for Cholesky.  Each wrapper here runs
it as one cooperative launch.  The source note in ``fused_pu.cu`` says
what bounds them on an H100 and how their design answers that.

Unlike the reference, there is no size at which a GPU call leaves its
kernel: the reference falls back to composed code when the panel does not
fit its VMEM budget, while these kernels take every panel height (the
panel stays in device memory).  And they compute at the input dtype, where
the TPU kernels compute in f32.

The plain PyTorch versions are literally the composition they replace —
the plain versions of the TRSM, GEMM-accumulate and GETF2 kernels for LU;
the GEMM-accumulate's plain version and
:func:`repro_torch.core.cholesky.cholesky_panel` (with the right TRSM's
plain version) for Cholesky — so on the CPU ``la_mb`` equals ``la`` and
``mtb`` bit for bit by construction.  On the card each kernel phase runs
the same device routines as the kernel it replaces, so there too.

Semantics: both write their results into the operand views in place —
the port's engine updates one working copy of the matrix.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cholesky import cholesky_unblocked
from repro_torch.core.lu import lu_unblocked
from repro_torch.kernels import _build
from repro_torch.kernels.blis_gemm import gemm_accum_plain
from repro_torch.kernels.trsm import (MAX_ROWS, trsm_plain,
                                      trsm_right_lower_t_plain)

__all__ = ["fused_lu_panel_update", "fused_lu_panel_update_plain",
           "fused_cholesky_panel_update", "fused_cholesky_panel_update_plain"]

_LIB = "fused_pu"
_c = _build
_LU_GRID_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, ctypes.POINTER(ctypes.c_int)]
_LU_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
            _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
            ctypes.c_int, _c.c_ptr, _c.c_ptr, _c.c_ptr, _c.c_ptr, _c.c_ptr]
_CHOL_GRID_ARGS = [_c.c_i64, _c.c_i64, ctypes.POINTER(ctypes.c_int)]
_CHOL_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
              _c.c_i64, _c.c_ptr, _c.c_i64, ctypes.c_int, _c.c_ptr]
#: Shared memory one block may use on an H100 (227 KB); the Cholesky kernel
#: keeps the bn × bn diagonal block and one column there.
_CHOL_SMEM_BYTES = 232448


# ---------------------------------------------------------------------------
# Plain versions: the composed path.
# ---------------------------------------------------------------------------
def fused_lu_panel_update_plain(l11, l21, a1l, a2l):
    """U12 = L11⁻¹·A1L into ``a1l``, A2L − L21·U12 into ``a2l``, then GETF2
    on ``a2l``; returns ``(a1l, a2l, piv)``."""
    trsm_plain(l11, a1l, lower=True, unit_diagonal=True, out=a1l)
    gemm_accum_plain(a2l, l21, a1l, alpha=-1.0, out=a2l)
    return a1l, a2l, lu_unblocked(a2l)


def fused_cholesky_panel_update_plain(lrow, l21, panel):
    """``panel −= L21·lrowᵀ``, then the Cholesky panel factorization of
    ``panel`` in place; returns ``panel``."""
    gemm_accum_plain(panel, l21, lrow.mT.contiguous(), alpha=-1.0, out=panel)
    bn = lrow.shape[0]
    l11 = cholesky_unblocked(panel[:bn])
    if panel.shape[0] > bn:
        trsm_right_lower_t_plain(l11, panel[bn:], out=panel[bn:])
    return panel


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU one.
# ---------------------------------------------------------------------------
def _check(what, shapes, tensors):
    dtype = _build.kernel_dtype(what, tensors[0])
    device = tensors[0].device
    for (name, shape), t in zip(shapes, tensors):
        _build.check_matrix(f"{what} {name}", t, dtype, device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)}, expected "
                             f"{shape}")
    return dtype, device


def _grid(symbol, argtypes, *sizes) -> int:
    grid = ctypes.c_int(0)
    err = _build.function(_LIB, symbol, argtypes)(*sizes, ctypes.byref(grid))
    _build.check_launch(_LIB, err, f"{symbol} grid query")
    return grid.value


def fused_lu_panel_update(l11: torch.Tensor, l21: torch.Tensor,
                          a1l: torch.Tensor, a2l: torch.Tensor):
    """PU(k+1) of LU: l11 (b, b) unit lower, l21 (m, b), a1l (b, bn),
    a2l (m, bn).  Writes U12 into ``a1l`` and the packed panel into ``a2l``;
    returns ``(a1l, a2l, piv)`` with int32 panel-relative pivots."""
    b = l11.shape[0] if l11.dim() == 2 else -1
    m, bn = a2l.shape if a2l.dim() == 2 else (-1, -1)
    dtype, device = _check(
        "fused_lu_panel_update",
        [("l11", (b, b)), ("l21", (m, b)), ("a1l", (b, bn)), ("a2l", (m, bn))],
        [l11, l21, a1l, a2l])
    if device.type == "cpu":
        return fused_lu_panel_update_plain(l11, l21, a1l, a2l)
    if b > MAX_ROWS:
        raise ValueError(f"fused_lu_panel_update: the kernel takes L11 of at "
                         f"most {MAX_ROWS} rows, got {b}")
    piv = torch.empty(min(m, bn), dtype=torch.int32, device=device)
    if piv.numel() == 0:
        return a1l, a2l, piv
    sfx = _build.SUFFIX[dtype]
    with torch.cuda.device(device):
        g = _grid(f"repro_fused_lu_grid_{sfx}", _LU_GRID_ARGS, b, m, bn)
        cand = torch.empty(2 * g * bn, dtype=dtype, device=device)
        rowj = torch.empty(2 * bn, dtype=dtype, device=device)
        pval = torch.empty(2 * g, dtype=dtype, device=device)
        pidx = torch.empty(2 * g, dtype=torch.int64, device=device)
        p = _build.ptr
        err = _build.function(_LIB, f"repro_fused_lu_{sfx}", _LU_ARGS)(
            b, m, bn, p(l11), _build.ld(l11), p(l21), _build.ld(l21), p(a1l),
            _build.ld(a1l), p(a2l), _build.ld(a2l), p(piv), g, p(cand),
            p(rowj), p(pval), p(pidx), _build.stream_of(device))
    _build.check_launch(_LIB, err, "fused_lu_panel_update kernel launch")
    fused_lu_panel_update.launches += 1
    return a1l, a2l, piv


def fused_cholesky_panel_update(lrow: torch.Tensor, l21: torch.Tensor,
                                panel: torch.Tensor) -> torch.Tensor:
    """PU(k+1) of Cholesky: lrow (bn, b) — the rows of L in the next block
    column, l21 (m, b), panel (m, bn) with m ≥ bn.  Factors ``panel`` in
    place (lower; upper triangle of its top block zeroed) and returns it."""
    bn, b = lrow.shape if lrow.dim() == 2 else (-1, -1)
    m = panel.shape[0] if panel.dim() == 2 else -1
    dtype, device = _check(
        "fused_cholesky_panel_update",
        [("lrow", (bn, b)), ("l21", (m, b)), ("panel", (m, bn))],
        [lrow, l21, panel])
    if m < bn:
        raise ValueError(f"fused_cholesky_panel_update: panel has {m} rows, "
                         f"fewer than its {bn} columns")
    if device.type == "cpu":
        return fused_cholesky_panel_update_plain(lrow, l21, panel)
    if bn * (bn + 1) * panel.element_size() > _CHOL_SMEM_BYTES:
        raise ValueError(f"fused_cholesky_panel_update: a {bn} x {bn} "
                         f"{dtype} diagonal block does not fit one block's "
                         f"shared memory")
    if panel.numel() == 0:
        return panel
    sfx = _build.SUFFIX[dtype]
    with torch.cuda.device(device):
        g = _grid(f"repro_fused_chol_grid_{sfx}", _CHOL_GRID_ARGS, m, bn)
        p = _build.ptr
        err = _build.function(_LIB, f"repro_fused_chol_{sfx}", _CHOL_ARGS)(
            b, m, bn, p(lrow), _build.ld(lrow), p(l21), _build.ld(l21),
            p(panel), _build.ld(panel), g, _build.stream_of(device))
    _build.check_launch(_LIB, err, "fused_cholesky_panel_update kernel launch")
    fused_cholesky_panel_update.launches += 1
    return panel


fused_lu_panel_update.launches = 0
fused_cholesky_panel_update.launches = 0
