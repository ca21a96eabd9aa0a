"""Fused panel updates — the LA_MB (malleable-BLAS) panel step in one kernel
— and the Cholesky panel kernel.

Kernels: ``csrc/fused_pu.cu`` (CUDA C++ for sm_90a), replacing the TPU
kernels ``repro/kernels/fused_panel_update.py::fused_lu_panel_update``
and ``::fused_cholesky_panel_update``.  In the look-ahead loop, PU(k+1) is
the narrow update of the next panel's columns followed by that panel's
factorization; composed, it is three kernels for LU (TRSM, GEMM, GETF2)
and a GEMM plus the Cholesky panel for Cholesky.  Each wrapper here runs
it as one cooperative launch.  The source note in ``fused_pu.cu`` says
what bounds them on an H100 and how their design answers that.

:func:`cholesky_panel` is the Cholesky kernel launched with no update
terms: the panel factorization (PF) alone, POTF2 of the diagonal block and
the solve of the rows below it.  ``ops.PANEL_KERNELS["cholesky"]`` is this
wrapper, so every scheduling variant's Cholesky PF runs it.  No TPU kernel
computes that panel: the reference traces it as jnp ops
(``repro/core/cholesky.py::cholesky_panel``).

Unlike the reference, there is no size at which a GPU call leaves its
kernel: the reference falls back to composed code when the panel does not
fit its VMEM budget, while these kernels take every panel height (each
block's rows in shared memory where they fit, else in device memory;
:func:`plan` and :func:`cholesky_plan` show which) and every block the
TRSM kernel takes (L11 up to ``trsm.max_rows``; the Cholesky kernel's
diagonal block up to the plan's ``max_bn``, about 3100 in f64, and its
POTF2 in registers up to 128 columns, in device memory past that, where
the other blocks apply its rank-16 updates).  And
they compute at the input dtype, where the TPU kernels compute in f32.

The plain PyTorch versions are literally the composition they replace —
the plain versions of the TRSM, GEMM-accumulate and GETF2 kernels for LU;
the GEMM-accumulate's plain version, :func:`cholesky_unblocked` and the
right TRSM's plain version for Cholesky (the panel alone: the last two) —
so on the CPU ``la_mb`` equals ``la`` and ``mtb`` bit for bit by
construction.  On the card each kernel phase runs the same device
routines as the kernel it replaces, or repeats the PyTorch ops' roundings
(POTF2), so there too.

Semantics: all write their results into the operand views in place —
the port's engine updates one working copy of the matrix.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.cholesky import cholesky_unblocked
from repro_torch.core.lu import lu_unblocked
from repro_torch.kernels import _build
from repro_torch.kernels.blis_gemm import gemm_accum_plain
from repro_torch.kernels.trsm import trsm_plain, trsm_right_lower_t_plain

__all__ = ["fused_lu_panel_update", "fused_lu_panel_update_plain",
           "fused_cholesky_panel_update", "fused_cholesky_panel_update_plain",
           "cholesky_panel", "cholesky_panel_plain", "plan", "cholesky_plan"]

_LIB = "fused_pu"
_c = _build
_PLAN_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, ctypes.POINTER(_c.c_i64)]
_LU_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
            _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
            ctypes.c_int, ctypes.c_int, _c.c_i64, _c.c_i64, ctypes.c_int,
            _c.c_ptr, _c.c_ptr]
_CHOL_ARGS = [_c.c_i64, _c.c_i64, _c.c_i64, _c.c_ptr, _c.c_i64, _c.c_ptr,
              _c.c_i64, _c.c_ptr, _c.c_i64, ctypes.c_int, ctypes.c_int,
              _c.c_i64, _c.c_i64, _c.c_i64, ctypes.c_int, _c.c_ptr, _c.c_ptr,
              _c.c_ptr]

#: (device index, raw stream) -> the Cholesky kernel's int32 flags (3, and
#: one a 16-column block of a wide diagonal block): zeroed when allocated,
#: and left at 0 by every launch (its last block resets them)
_FLAGS: dict = {}


# ---------------------------------------------------------------------------
# Plain versions: the composed path.
# ---------------------------------------------------------------------------
def fused_lu_panel_update_plain(l11, l21, a1l, a2l):
    """U12 = L11⁻¹·A1L into ``a1l``, A2L − L21·U12 into ``a2l``, then GETF2
    on ``a2l``; returns ``(a1l, a2l, piv)``."""
    trsm_plain(l11, a1l, lower=True, unit_diagonal=True, out=a1l)
    gemm_accum_plain(a2l, l21, a1l, alpha=-1.0, out=a2l)
    return a1l, a2l, lu_unblocked(a2l)


def cholesky_panel_plain(panel, nb):
    """The Cholesky panel factorization of the ``m × nb`` panel in place:
    :func:`cholesky_unblocked` of its top block, then ``X·L11ᵀ = A21`` for
    the rows below; returns ``panel``."""
    l11 = cholesky_unblocked(panel[:nb])
    if panel.shape[0] > nb:
        trsm_right_lower_t_plain(l11, panel[nb:], out=panel[nb:])
    return panel


def fused_cholesky_panel_update_plain(lrow, l21, panel):
    """``panel −= L21·lrowᵀ``, then the Cholesky panel factorization of
    ``panel`` in place; returns ``panel``."""
    gemm_accum_plain(panel, l21, lrow.mT.contiguous(), alpha=-1.0, out=panel)
    return cholesky_panel_plain(panel, lrow.shape[0])


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


@functools.lru_cache(maxsize=None)
def _lu_plan(b: int, m: int, bn: int, dtype: torch.dtype, index: int) -> dict:
    out = (_c.c_i64 * 9)()
    fn = _build.function(_LIB, f"repro_fused_lu_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(b, m, bn, out)
    if err and 0 < out[7] < b:
        raise ValueError(f"fused_lu_panel_update: the kernel takes L11 of at "
                         f"most {out[7]} rows of {dtype} on this card (its "
                         f"shared memory), got {b}")
    _build.check_launch(_LIB, err, f"fused_lu_panel_update plan for b {b}, "
                        f"{m} x {bn}")
    return {"route": "resident" if out[1] else "streamed", "grid": out[0],
            "chunk": out[2], "smem_bytes": out[3], "workspace_bytes": out[4],
            "threads": out[5], "segment_rows": out[6], "max_rows": out[7],
            "update_terms": out[8]}


def plan(b: int, m: int, bn: int, dtype: torch.dtype, *,
         device: Optional[torch.device] = None) -> dict:
    """How the fused LU panel update runs for a ``b × b`` L11 and an
    ``m × bn`` panel on a CUDA device: ``route`` (the panel's rows
    ``resident`` in shared memory or ``streamed``), ``grid`` blocks of
    ``threads``, rows a block (``chunk``), dynamic shared memory a block,
    workspace bytes, the rows of L11 its U12 solve stages a step
    (``segment_rows``), the widest L11 the card takes (``max_rows``) and
    the terms of k its update stages at once (``update_terms``: fewer where
    more would push the rows out of shared memory).
    Builds the library; cached per shape."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_lu_plan(b, m, bn, dtype, index))


@functools.lru_cache(maxsize=None)
def _chol_plan(b: int, m: int, bn: int, dtype: torch.dtype,
               index: int) -> dict:
    out = (_c.c_i64 * 13)()
    fn = _build.function(_LIB,
                         f"repro_fused_chol_plan_{_build.SUFFIX[dtype]}",
                         _PLAN_ARGS)
    with torch.cuda.device(index):
        err = fn(b, m, bn, out)
    if err and 0 < out[8] < bn:
        raise ValueError(f"fused_pu: the Cholesky kernel takes a diagonal "
                         f"block of at most {out[8]} columns of {dtype} on "
                         f"this card (its shared memory), got {bn}")
    if err == _build.NO_FIT:
        raise ValueError(f"fused_pu: the Cholesky kernel runs no block an SM "
                         f"for b {b}, {m} x {bn} of {dtype} on this card")
    _build.check_launch(_LIB, err, f"Cholesky kernel plan for b {b}, "
                        f"{m} x {bn}")
    return {"route": "resident" if out[1] else "streamed", "grid": out[0],
            "chunk": out[2], "smem_bytes": out[3], "threads": out[4],
            "segment_rows": out[5],
            "potf2": "registers" if out[6] else "device",
            "potf2_cols": "shared" if out[10] else "device",
            "workspace_bytes": out[11], "flag_words": out[12],
            "update_terms": out[7], "max_bn": out[8]}


def cholesky_plan(m: int, bn: int, dtype: torch.dtype, *, b: int = 0,
                  device: Optional[torch.device] = None) -> dict:
    """How the Cholesky kernel runs on an ``m × bn`` panel with ``b`` terms
    of update (0: :func:`cholesky_panel`; the fused update's L21 width
    otherwise) on a CUDA device: ``route`` (the rows below the diagonal
    block ``resident`` in shared memory or ``streamed``), ``grid`` blocks
    of ``threads`` (block 0 the diagonal block, one a chunk of ``chunk``
    rows below it, at most one an SM), dynamic shared memory a block, the
    rows of L11 a solve step stages (``segment_rows``), where POTF2 keeps
    the diagonal block (``potf2``: ``registers`` up to 128 columns, else
    ``device`` memory, where the other blocks apply its rank-16 updates),
    where it keeps the column block it works on (``potf2_cols``:
    ``shared`` memory, else a ``device``-memory workspace of
    ``workspace_bytes``, past about 1700 columns in f64), the int32 flags
    it needs (``flag_words``), the terms of k an update stage holds and the
    widest diagonal block the card takes (``max_bn``).  Builds the library; cached
    per shape; a ValueError, before any launch, where the panel cannot
    run."""
    device = torch.device(device or "cuda")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return dict(_chol_plan(b, m, bn, dtype, index))


def _launch_cholesky(b, m, bn, lrow, ldr, l21, ld21, panel, dtype, device):
    """The Cholesky kernel on ``panel`` (``m × bn``, in place), with ``b``
    terms of update from ``l21`` and ``lrow`` (b = 0: none)."""
    pl = _chol_plan(b, m, bn, dtype, device.index)
    stream = _build.stream_of(device)
    # the flags through which the blocks publish L11's finished columns
    # and the diagonal block's updated tiles, one buffer a stream
    key = (device.index, stream.value)
    flag = _FLAGS.get(key)
    if flag is None or flag.numel() < pl["flag_words"]:
        flag = _FLAGS[key] = torch.zeros(max(pl["flag_words"], 16),
                                         dtype=torch.int32, device=device)
    cols = (torch.empty(pl["workspace_bytes"], dtype=torch.uint8,
                        device=device) if pl["workspace_bytes"] else None)
    with _build.device_guard(device):
        err = _build.function(
            _LIB, f"repro_fused_chol_{_build.SUFFIX[dtype]}", _CHOL_ARGS)(
            b, m, bn, lrow, ldr, l21, ld21, _build.ptr(panel),
            _build.ld(panel), pl["grid"], int(pl["route"] == "resident"),
            pl["chunk"], pl["smem_bytes"], pl["segment_rows"],
            pl["update_terms"], None if cols is None else _build.ptr(cols),
            _build.ptr(flag), stream)
    _build.check_launch(_LIB, err, "Cholesky kernel launch")


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
    piv = torch.empty(min(m, bn), dtype=torch.int32, device=device)
    if piv.numel() == 0:
        return a1l, a2l, piv
    pl = _lu_plan(b, m, bn, dtype, device.index)
    ws = torch.empty(pl["workspace_bytes"], dtype=torch.uint8, device=device)
    with _build.device_guard(device):
        p = _build.ptr
        err = _build.function(_LIB, f"repro_fused_lu_{_build.SUFFIX[dtype]}",
                              _LU_ARGS)(
            b, m, bn, p(l11), _build.ld(l11), p(l21), _build.ld(l21), p(a1l),
            _build.ld(a1l), p(a2l), _build.ld(a2l), p(piv), pl["grid"],
            int(pl["route"] == "resident"), pl["smem_bytes"],
            pl["segment_rows"], pl["update_terms"], p(ws),
            _build.stream_of(device))
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
    if panel.numel() == 0:
        return panel
    p = _build.ptr
    _launch_cholesky(b, m, bn, p(lrow), _build.ld(lrow), p(l21),
                     _build.ld(l21), panel, dtype, device)
    fused_cholesky_panel_update.launches += 1
    return panel


def cholesky_panel(panel: torch.Tensor, nb: int, backend=None) -> torch.Tensor:
    """PF for Cholesky: factor the ``m × nb`` panel (``m ≥ nb``) in place —
    POTF2 of its top block (lower; the upper triangle zeroed), then
    ``X·L11ᵀ = A21`` for the rows below — and return it.  The Cholesky
    kernel with no update terms; the signature of
    ``repro_torch.core.cholesky.cholesky_panel`` (``backend`` is not
    read: this is the ``"cuda"`` backend's panel)."""
    dtype = _build.kernel_dtype("cholesky_panel", panel)
    device = panel.device
    _build.check_matrix("cholesky_panel panel", panel, dtype, device)
    m, cols = panel.shape
    if cols != nb or m < nb:
        raise ValueError(f"cholesky_panel: panel is {tuple(panel.shape)}, "
                         f"expected m x {nb} with m >= {nb}")
    if device.type == "cpu":
        return cholesky_panel_plain(panel, nb)
    if panel.numel() == 0:
        return panel
    _launch_cholesky(0, m, nb, None, 0, None, 0, panel, dtype, device)
    cholesky_panel.launches += 1
    return panel


fused_lu_panel_update.launches = 0
fused_cholesky_panel_update.launches = 0
cholesky_panel.launches = 0
