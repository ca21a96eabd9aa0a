"""The ``"cuda"`` backend: the hand-written kernels behind the
:class:`~repro_torch.core.backend.Backend` vtable.

The port of :mod:`repro.kernels.ops`'s ``PALLAS_BACKEND``:

* ``gemm``   → the GEMM kernel (β = 0);
* ``update`` → the same kernel as GEMM-accumulate, ``C -= A·B`` in place —
  the trailing update, which the reference's backend never sent to its
  fused kernel;
* ``trsm``   → the TRSM kernel for left, non-transposed solves, lower or
  upper, and for the right, lower, transposed solve of the Cholesky panel;
  every other case goes to the library solve, as the reference sends it
  to ``trsm_jnp``;
* ``panel_fns`` = :data:`PANEL_KERNELS` → the GETF2 panel kernel (LU),
  the GEQR2+LARFT panel kernel (QR), the xLAQPS panel kernel (global
  QRCP and ``qrcp_local``) and the xLAHR2 panel kernel (Hessenberg) for
  every scheduling variant;
* ``larft`` → the LARFT entry of the QR panel kernel, which
  :func:`repro_torch.core.qr.build_t_matrix` takes on CUDA tensors;
* ``fused_pu`` = :data:`FUSED_PU` → the fused panel-update kernels of
  ``la_mb`` for LU and Cholesky;
* ``lu_solve_small`` → the fused small solve, taken by
  :func:`repro_torch.solve.triangular.lu_solve_packed`.

The flash-attention kernel of the serving path is not a slot of the
:class:`Backend` (no factorization calls it): it is registered here only
in :data:`KERNELS`, so its launches are counted and reset with the rest;
:func:`repro_torch.models.layers.chunked_attention` calls it.

On CPU tensors every wrapper runs its kernel's plain PyTorch version; on
CUDA tensors it launches the kernel or raises.  There is no size at which
a GPU call leaves its kernel for the plain version.
"""
from __future__ import annotations

from repro_torch.core.backend import Backend, trsm_torch
from repro_torch.kernels import attention as _attn
from repro_torch.kernels import blis_gemm as _bg
from repro_torch.kernels import fused_panel_update as _fpu
from repro_torch.kernels import panel_hessenberg as _phess
from repro_torch.kernels import panel_lu as _plu
from repro_torch.kernels import panel_qr as _pqr
from repro_torch.kernels import panel_qrcp as _pqrcp
from repro_torch.kernels import trsm as _tr

__all__ = ["CUDA_BACKEND", "PANEL_KERNELS", "FUSED_PU", "KERNELS",
           "SMALL_SOLVE_MAX_N", "gemm", "update", "trsm", "lu_panel",
           "qr_panel", "larft", "qrcp_panel", "hessenberg_panel",
           "lu_solve_small",
           "fused_lu_panel_update", "fused_cholesky_panel_update",
           "launches", "reset_launches"]

gemm = _bg.gemm
lu_panel = _plu.lu_panel
qr_panel = _pqr.qr_panel
larft = _pqr.larft
qrcp_panel = _pqrcp.qrcp_panel
hessenberg_panel = _phess.hessenberg_panel
lu_solve_small = _tr.lu_solve_small
fused_lu_panel_update = _fpu.fused_lu_panel_update
fused_cholesky_panel_update = _fpu.fused_cholesky_panel_update
SMALL_SOLVE_MAX_N = _tr.MAX_ROWS


def update(c, a, b):
    """``c -= a·b`` in place through the GEMM-accumulate kernel."""
    return _bg.gemm_accum(c, a, b, alpha=-1.0, out=c)


def trsm(t, b, *, side="left", lower=True, trans=False, unit_diagonal=False,
         out=None):
    """Backend TRSM: the kernels for left non-transposed solves and for
    right, lower, transposed ones."""
    if side == "left" and not trans:
        return _tr.trsm(t, b, lower=lower, unit_diagonal=unit_diagonal,
                        out=out)
    if side == "right" and lower and trans:
        return _tr.trsm_right_lower_t(t, b, unit_diagonal=unit_diagonal,
                                      out=out)
    return trsm_torch(t, b, side=side, lower=lower, trans=trans,
                      unit_diagonal=unit_diagonal, out=out)


PANEL_KERNELS = {"lu": lu_panel, "qr": qr_panel, "qrcp": qrcp_panel,
                 "qrcp_local": qrcp_panel, "hessenberg": hessenberg_panel}

#: The fused panel updates that ``get_variant(dmf, "la_mb")`` plugs in; the
#: engine fuses PU(k+1) and issues deeper narrow updates as regular ones.
#: QR has none (nor has the reference), so its ``la_mb`` is ``la``.
FUSED_PU = {
    "lu": fused_lu_panel_update,
    "cholesky": fused_cholesky_panel_update,
}

CUDA_BACKEND = Backend(name="cuda", gemm=gemm, trsm=trsm, update=update,
                       panel_fns=PANEL_KERNELS, fused_pu=FUSED_PU)

#: Every kernel wrapper, by the name its launch count goes under (``gemm``
#: and ``update`` share the GEMM kernel's count); all but the last are the
#: backend's.
KERNELS = {
    "gemm_accum": _bg.gemm_accum,
    "trsm": _tr.trsm,
    "lu_panel": _plu.lu_panel,
    "qr_panel": _pqr.qr_panel,
    "larft": _pqr.larft,
    "qrcp_panel": _pqrcp.qrcp_panel,
    "hessenberg_panel": _phess.hessenberg_panel,
    "lu_solve_small": _tr.lu_solve_small,
    "trsm_right_lower_t": _tr.trsm_right_lower_t,
    "fused_lu_panel_update": _fpu.fused_lu_panel_update,
    "fused_cholesky_panel_update": _fpu.fused_cholesky_panel_update,
    "flash_attention": _attn.flash_attention,
}


def launches() -> dict[str, int]:
    """Launch count of every kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
