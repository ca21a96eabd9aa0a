"""Compute backend used by the factorization drivers.

The port of :mod:`repro.core.backend`.  The paper builds its DMFs on a
cache-aware BLAS; here that role is a small vtable with two
implementations:

* ``"torch"`` (:data:`TORCH_BACKEND`) — library calls at the input dtype:
  ``torch.matmul``/``addmm_`` and ``torch.linalg.solve_triangular``.  The
  analogue of the reference's ``JNP_BACKEND`` and the baseline.
* ``"cuda"`` (:data:`repro_torch.kernels.ops.CUDA_BACKEND`) — the
  hand-written CUDA kernels; on CPU tensors their plain PyTorch versions.
  It is the default of every port entry point.

One rule holds for every factorization: its panel kernel (and the
``larft`` kernel a panel's T comes from) is taken only from the backend's
``panel_fns``, so under ``"torch"`` the whole factorization runs as plain
PyTorch ops, on a CUDA tensor too.

In-place contract.  The reference is functional (``c - gemm(a, b)`` and
``.at[].set``); the port updates views of one working copy of the matrix
in place.  ``update(c, a, b)`` overwrites the view ``c`` with
``c - a·b`` and returns it, and ``trsm(..., out=x)`` writes the solution
into ``x`` (which may be the right-hand side itself).  ``update`` is a
vtable slot rather than a hard-coded ``c - gemm(a, b)``, so the CUDA
backend routes it to the fused GEMM-accumulate kernel.

TF32.  A float32 product on the GPU may run in TF32 (about three decimal
digits) when ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is set.  Every library-backend call
clears both flags first (:func:`no_tf32`), so the baseline computes at the
input dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

__all__ = ["Backend", "TORCH_BACKEND", "get_backend", "resolve_backend",
           "no_tf32", "gemm_torch", "trsm_torch", "update_torch"]


def no_tf32() -> None:
    """Keep float32 library products in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def gemm_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B through the library."""
    no_tf32()
    return torch.matmul(a, b)


def update_torch(c: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """``c -= a·b`` in place through the library; returns ``c``."""
    no_tf32()
    return c.addmm_(a, b, alpha=-1)


def trsm_torch(t: torch.Tensor, b: torch.Tensor, *, side: str = "left",
               lower: bool = True, trans: bool = False,
               unit_diagonal: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve ``op(T)·X = B`` (side=left) or ``X·op(T) = B`` (side=right).

    Every side/lower/trans/unit case of the reference's ``_trsm_impl``;
    only the triangle of ``T`` named by ``lower`` is read.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be left/right, got {side}")
    no_tf32()
    # op(T) = Tᵀ turns a lower triangle into an upper one and vice versa
    x = torch.linalg.solve_triangular(
        t.mT if trans else t, b, upper=(lower == trans),
        left=(side == "left"), unitriangular=unit_diagonal)
    return x if out is None else out.copy_(x)


@dataclasses.dataclass(frozen=True)
class Backend:
    """BLAS-like vtable the DMF drivers are written against.

    ``panel_fns`` is an optional per-DMF panel-kernel registry keyed by
    ``StepOps.name``: when set, :func:`repro_torch.core.pipeline.factorize`
    takes its default ``panel_fn=`` from it (this is how ``"cuda"`` routes
    every variant through the GETF2 kernel).  ``fused_pu`` is the per-DMF
    registry of fused panel-update kernels that ``la_mb`` takes when the
    caller passes none (``"cuda"`` fills it).
    """

    name: str
    gemm: Callable[..., torch.Tensor]
    trsm: Callable[..., torch.Tensor]
    update: Callable[..., torch.Tensor]
    panel_fns: Optional[Mapping[str, Callable]] = None
    fused_pu: Optional[Mapping[str, Callable]] = None


TORCH_BACKEND = Backend(name="torch", gemm=gemm_torch, trsm=trsm_torch,
                        update=update_torch)


def get_backend(name: str = "cuda") -> Backend:
    if name == "torch":
        return TORCH_BACKEND
    if name == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.CUDA_BACKEND
    raise ValueError(f"unknown backend {name!r} (expected 'cuda' or 'torch')")


def resolve_backend(backend) -> Backend:
    """A :class:`Backend` from a name or an instance."""
    return get_backend(backend) if isinstance(backend, str) else backend
