"""Factorization-result objects — factor once, solve many.

The port of :class:`repro.solve.factors.LUFactors`: the packed GETRF
output with the block size and backend it was built with, and the
operations LAPACK derives from it (``solve``, transposed ``solve``,
``logdet``).

Carrying a factored system across the two packages: this system has no
weights, so what moves between the reference and the port is a factored
matrix.  :meth:`LUFactors.from_numpy` takes the reference's ``lu`` and
``ipiv`` arrays (as NumPy) and recomputes ``perm``; :meth:`LUFactors.to_numpy`
gives back ``(lu, ipiv, perm)``, which the reference's
``LUFactors.from_packed(lu, ipiv)`` accepts.  So a system factored by one
package can be solved by the other.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.blocking import BlockSpec
from repro_torch.core.lu import permutation_from_pivots
from repro_torch.device import resolve_device, working_copy
from repro_torch.solve.triangular import lu_solve_packed, trsm_blocked

__all__ = ["LUFactors"]


@dataclasses.dataclass(frozen=True)
class LUFactors:
    """Packed GETRF output: ``P·A = L·U`` with global 0-based int32 ``ipiv``.

    ``perm`` (int64) is the row-permutation vector derived from ``ipiv``,
    stored at factor time so the solve-many phase does not re-derive it.
    """

    lu: torch.Tensor
    ipiv: torch.Tensor
    perm: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_packed(cls, lu: torch.Tensor, ipiv: torch.Tensor, *,
                    block: BlockSpec = 128,
                    backend: Union[str, Backend] = "cuda") -> "LUFactors":
        return cls(lu=lu, ipiv=ipiv,
                   perm=permutation_from_pivots(ipiv, lu.shape[0]),
                   block=block, backend=resolve_backend(backend))

    @classmethod
    def from_numpy(cls, lu, ipiv, *, block: BlockSpec = 128, device=None,
                   backend: Union[str, Backend] = "cuda") -> "LUFactors":
        """Factors from NumPy arrays (e.g. the reference's), on ``device``
        (None = the GPU)."""
        dev = resolve_device(device)
        return cls.from_packed(working_copy(lu, dev),
                               working_copy(np.asarray(ipiv), dev,
                                            torch.int32),
                               block=block, backend=backend)

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(lu, ipiv, perm)`` as NumPy arrays."""
        return (self.lu.cpu().numpy(), self.ipiv.cpu().numpy(),
                self.perm.cpu().numpy())

    @property
    def n(self) -> int:
        return self.lu.shape[0]

    def solve(self, b, *, trans: bool = False) -> torch.Tensor:
        """Solve ``A·X = B`` (or ``Aᵀ·X = B``); ``b`` may be a vector, a
        matrix or a NumPy array, and is not modified."""
        b = torch.as_tensor(b).to(device=self.lu.device, dtype=self.lu.dtype)
        was_vec = b.dim() == 1
        if was_vec:
            b = b[:, None]
        if b.shape[0] != self.n:
            raise ValueError(f"rhs rows {b.shape[0]} != system size {self.n}")
        if not trans:
            # A = Pᵀ·L·U  ⇒  L·U·X = P·B
            x = lu_solve_packed(self.lu, b[self.perm], block=self.block,
                                backend=self.backend)
        else:
            # Aᵀ = Uᵀ·Lᵀ·P  ⇒  Uᵀ·y = B, Lᵀ·z = y, X = Pᵀ·z
            y = trsm_blocked(self.lu, b, lower=False, trans=True,
                             block=self.block, backend=self.backend)
            z = trsm_blocked(self.lu, y, lower=True, trans=True,
                             unit_diagonal=True, block=self.block,
                             backend=self.backend)
            x = torch.empty_like(z)
            x[self.perm] = z
        return x[:, 0] if was_vec else x

    def logdet(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(sign, log|det A|)`` — slogdet semantics."""
        d = torch.diagonal(self.lu)
        swaps = int((self.ipiv != torch.arange(
            self.ipiv.shape[0], device=self.ipiv.device)).sum())
        sign = (-1.0 if swaps % 2 else 1.0) * torch.prod(torch.sign(d))
        return sign, torch.sum(torch.log(torch.abs(d)))
