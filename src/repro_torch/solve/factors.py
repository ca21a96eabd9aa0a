"""Factorization-result objects — factor once, solve many.

The port of :class:`repro.solve.factors.LUFactors`,
:class:`~repro.solve.factors.CholeskyFactors`,
:class:`~repro.solve.factors.LDLTFactors`,
:class:`~repro.solve.factors.QRFactors`,
:class:`~repro.solve.factors.QRCPFactors`,
:class:`~repro.solve.factors.HessenbergFactors` and
:class:`~repro.solve.factors.TiledQRFactors`: the packed GETRF / POTRF /
unpivoted LDLᵀ / GEQRF / GEQP3 / GEHRD output (and the tile-DAG QR's
:class:`~repro_torch.core.tiles.TileQR`) with the block size and backend
it was built with, and the operations LAPACK derives from it (``solve``,
transposed ``solve``, ``logdet``, ``inverse``; for GEHRD ``h``, ``q``,
``reconstruct``, ``similarity``, ``eigvals``).

Carrying a factored system across the two packages: this system has no
weights, so what moves between the reference and the port is a factored
matrix.  :meth:`LUFactors.from_numpy` takes the reference's ``lu`` and
``ipiv`` arrays (as NumPy) and recomputes ``perm``; :meth:`LUFactors.to_numpy`
gives back ``(lu, ipiv, perm)``, which the reference's
``LUFactors.from_packed(lu, ipiv)`` accepts.  :class:`CholeskyFactors`
carries its lower factor ``l`` the same way, :class:`LDLTFactors` its
``packed`` factor, :class:`QRFactors` its
``(packed, taus)``, :class:`QRCPFactors` its ``(packed, taus, jpvt)``
and :class:`HessenbergFactors` its ``(packed, taus)``.  So a system
factored by one package can be solved, or reduced further, by the other.

Batches.  The reference gets a batch of factored systems by stacking its
factor pytrees (a leading batch axis on every leaf).  Here
:func:`stack_factors` makes one factor object whose tensors carry that
axis (``lu (B, n, n)``, ``ipiv``/``perm (B, n)``; ``l (B, n, n)``) and
:func:`factors_at` takes system ``i`` back out;
:func:`repro_torch.solve.batched.solve_batched` solves such a batch.
``LUFactors.from_numpy`` and ``CholeskyFactors.from_numpy`` accept the
reference's batched arrays as they are, and ``to_numpy`` returns them
batched, so a batch factored by either package is solved by the other.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core.backend import Backend, resolve_backend
from repro_torch.core.blocking import BlockSpec, panel_steps
from repro_torch.core.hessenberg import form_q_hess, unpack_hessenberg
from repro_torch.core.lu import permutation_from_pivots
from repro_torch.core.qr import Panel, _pad_tau, apply_qt_blocked, \
    build_t_matrix, unpack_v
from repro_torch.core.tiles import TileQR, qr_apply_qt
from repro_torch.device import resolve_device, working_copy
from repro_torch.solve.triangular import lu_solve_packed, trsm_blocked

__all__ = ["LUFactors", "CholeskyFactors", "LDLTFactors", "QRFactors",
           "QRCPFactors", "HessenbergFactors", "TiledQRFactors",
           "stack_factors", "factors_at", "batch_size"]


def _rhs(b, like: torch.Tensor, n: int) -> tuple[torch.Tensor, bool]:
    """``b`` as a matrix on ``like``'s device and dtype, and whether it was
    a vector."""
    if like.dim() != 2:
        raise ValueError("these factors hold a batch of systems: solve them "
                         "with solve_batched, or take one with factors_at")
    b = torch.as_tensor(b).to(device=like.device, dtype=like.dtype)
    was_vec = b.dim() == 1
    if was_vec:
        b = b[:, None]
    if b.shape[0] != n:
        raise ValueError(f"rhs rows {b.shape[0]} != system size {n}")
    return b, was_vec


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
        """Factors from ``lu`` and ``ipiv``, one system or a batch
        (``lu (B, n, n)``, ``ipiv (B, n)``)."""
        n = lu.shape[-1]
        perm = permutation_from_pivots(ipiv, n) if lu.dim() == 2 else \
            torch.stack([permutation_from_pivots(p, n) for p in ipiv])
        return cls(lu=lu, ipiv=ipiv, perm=perm, block=block,
                   backend=resolve_backend(backend))

    @classmethod
    def from_numpy(cls, lu, ipiv, *, block: BlockSpec = 128, device=None,
                   backend: Union[str, Backend] = "cuda") -> "LUFactors":
        """Factors from NumPy arrays (e.g. the reference's, batched or
        not), on ``device`` (None = the GPU)."""
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
        return self.lu.shape[-1]

    def solve(self, b, *, trans: bool = False) -> torch.Tensor:
        """Solve ``A·X = B`` (or ``Aᵀ·X = B``); ``b`` may be a vector, a
        matrix or a NumPy array, and is not modified."""
        b, was_vec = _rhs(b, self.lu, self.n)
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

    def inverse(self) -> torch.Tensor:
        """``A⁻¹`` via n simultaneous solves (GETRI semantics)."""
        return self.solve(torch.eye(self.n, dtype=self.lu.dtype,
                                    device=self.lu.device))


@dataclasses.dataclass(frozen=True)
class CholeskyFactors:
    """POTRF output: ``A = L·Lᵀ`` with L lower triangular."""

    l: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_numpy(cls, l, *, block: BlockSpec = 128, device=None,
                   backend: Union[str, Backend] = "cuda") -> "CholeskyFactors":
        """Factors from a NumPy array (e.g. the reference's ``l``, batched
        or not), on ``device`` (None = the GPU)."""
        return cls(l=working_copy(l, resolve_device(device)), block=block,
                   backend=resolve_backend(backend))

    def to_numpy(self) -> np.ndarray:
        """``l`` as a NumPy array."""
        return self.l.cpu().numpy()

    @property
    def n(self) -> int:
        return self.l.shape[-1]

    def solve(self, b, *, trans: bool = False) -> torch.Tensor:
        """Solve ``A·X = B`` (A is symmetric, so ``trans`` changes nothing):
        ``L·y = B``, then ``Lᵀ·X = y``."""
        del trans
        b, was_vec = _rhs(b, self.l, self.n)
        y = trsm_blocked(self.l, b, lower=True, block=self.block,
                         backend=self.backend)
        x = trsm_blocked(self.l, y, lower=True, trans=True, block=self.block,
                         backend=self.backend)
        return x[:, 0] if was_vec else x

    def logdet(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(sign, log det A)``: sign 1, ``2·Σ log L[i, i]``."""
        d = torch.diagonal(self.l)
        return torch.ones((), dtype=d.dtype, device=d.device), \
            2.0 * torch.sum(torch.log(d))

    def inverse(self) -> torch.Tensor:
        """``A⁻¹`` via n simultaneous solves."""
        return self.solve(torch.eye(self.n, dtype=self.l.dtype,
                                    device=self.l.device))


@dataclasses.dataclass(frozen=True)
class LDLTFactors:
    """Unpivoted LDLᵀ: unit-lower L strictly below the diagonal, D on it."""

    packed: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_numpy(cls, packed, *, block: BlockSpec = 128, device=None,
                   backend: Union[str, Backend] = "cuda") -> "LDLTFactors":
        """Factors from a NumPy array (e.g. the reference's ``packed``), on
        ``device`` (None = the GPU)."""
        return cls(packed=working_copy(packed, resolve_device(device)),
                   block=block, backend=resolve_backend(backend))

    def to_numpy(self) -> np.ndarray:
        """``packed`` as a NumPy array."""
        return self.packed.cpu().numpy()

    @property
    def n(self) -> int:
        return self.packed.shape[0]

    def solve(self, b, *, trans: bool = False) -> torch.Tensor:
        """Solve ``A·X = B`` (A is symmetric, so ``trans`` changes nothing):
        ``L·y = B`` (the unit-lower TRSM), ``z = D⁻¹·y``, then
        ``Lᵀ·X = z``."""
        del trans
        b, was_vec = _rhs(b, self.packed, self.n)
        y = trsm_blocked(self.packed, b, lower=True, unit_diagonal=True,
                         block=self.block, backend=self.backend)
        y /= torch.diagonal(self.packed)[:, None]
        x = trsm_blocked(self.packed, y, lower=True, trans=True,
                         unit_diagonal=True, block=self.block,
                         backend=self.backend)
        return x[:, 0] if was_vec else x

    def logdet(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(sign, log|det A|)``: the product of D's signs and
        ``Σ log|d_i|``."""
        d = torch.diagonal(self.packed)
        return torch.prod(torch.sign(d)), torch.sum(torch.log(torch.abs(d)))

    def inverse(self) -> torch.Tensor:
        """``A⁻¹`` via n simultaneous solves."""
        return self.solve(torch.eye(self.n, dtype=self.packed.dtype,
                                    device=self.packed.device))


@dataclasses.dataclass(frozen=True)
class QRFactors:
    """GEQRF output: R on/above the diagonal, the reflectors V below it,
    ``taus`` of length ``min(m, n)``."""

    packed: torch.Tensor
    taus: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_numpy(cls, packed, taus, *, block: BlockSpec = 128,
                   device=None,
                   backend: Union[str, Backend] = "cuda") -> "QRFactors":
        """Factors from NumPy arrays (e.g. the reference's), on ``device``
        (None = the GPU)."""
        dev = resolve_device(device)
        return cls(packed=working_copy(packed, dev),
                   taus=working_copy(taus, dev), block=block,
                   backend=resolve_backend(backend))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """``(packed, taus)`` as NumPy arrays."""
        return self.packed.cpu().numpy(), self.taus.cpu().numpy()

    @property
    def m(self) -> int:
        return self.packed.shape[0]

    @property
    def n(self) -> int:
        return self.packed.shape[1]

    def apply_qt(self, c) -> torch.Tensor:
        """``Qᵀ·C`` panel by panel (ORMQR analogue); T of each panel from
        :func:`~repro_torch.core.qr.build_t_matrix` (one ``larft`` launch
        on the card).  Returns a new tensor."""
        c = torch.as_tensor(c).to(device=self.packed.device,
                                  dtype=self.packed.dtype).clone()
        if c.shape[0] != self.m:
            raise ValueError(f"rows {c.shape[0]} != m = {self.m}")
        m, n = self.m, self.n
        for st in panel_steps(n, self.block):
            k, bk = st.k, st.bk
            if k >= m:
                break
            v = unpack_v(self.packed[k:, k : k + bk], bk)
            t = build_t_matrix(v, _pad_tau(self.taus[k : k + bk], bk))
            apply_qt_blocked(Panel.of(v, t), c[k:], self.backend)
        return c

    def _r_solve(self, qtb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return trsm_blocked(r, qtb, lower=False, block=self.block,
                            backend=self.backend)

    def solve(self, b) -> torch.Tensor:
        """Least-squares solution ``argmin‖A·X − B‖₂`` (m ≥ n)."""
        if self.m < self.n:
            raise ValueError("QRFactors.solve requires m >= n "
                             "(underdetermined systems need LQ)")
        b, was_vec = _rhs(b, self.packed, self.m)
        qtb = self.apply_qt(b)
        x = self._r_solve(qtb[: self.n], torch.triu(self.packed[: self.n]))
        return x[:, 0] if was_vec else x

    def logdet(self) -> tuple[torch.Tensor, torch.Tensor]:
        """slogdet of a square A: each reflector with ``tau != 0`` has
        determinant −1, so ``det A = (−1)^#{tau != 0}·Π r_jj``."""
        if self.m != self.n:
            raise ValueError("logdet requires a square matrix")
        d = torch.diagonal(self.packed)
        flips = int((self.taus != 0).sum())
        sign = (-1.0 if flips % 2 else 1.0) * torch.prod(torch.sign(d))
        return sign, torch.sum(torch.log(torch.abs(d)))

    def inverse(self) -> torch.Tensor:
        """``A⁻¹`` of a square A via n simultaneous solves."""
        if self.m != self.n:
            raise ValueError("inverse requires a square matrix")
        return self.solve(torch.eye(self.n, dtype=self.packed.dtype,
                                    device=self.packed.device))


@dataclasses.dataclass(frozen=True)
class TiledQRFactors:
    """Tile-DAG QR output (``variant="tiled"``): the explicit R and the
    GEQRT/TSQRT reflector chain of a :class:`~repro_torch.core.tiles.TileQR`.

    The TSQRT chain couples tile rows pairwise, so its reflectors have no
    GEQRF packed form: ``Qᵀ·C`` goes through
    :func:`~repro_torch.core.tiles.qr_apply_qt`, and the triangular solve
    after it is :class:`QRFactors`'s.
    """

    tqr: TileQR
    backend: Backend
    block: BlockSpec = 128

    @property
    def m(self) -> int:
        return self.tqr.r.shape[0]

    @property
    def n(self) -> int:
        return self.tqr.r.shape[1]

    def apply_qt(self, c) -> torch.Tensor:
        """``Qᵀ·C`` through the tile reflectors; returns a new tensor."""
        return qr_apply_qt(self.tqr, c, backend=self.backend)

    def solve(self, b) -> torch.Tensor:
        """Least-squares solution ``argmin‖A·X − B‖₂`` (m ≥ n)."""
        if self.m < self.n:
            raise ValueError("TiledQRFactors.solve requires m >= n "
                             "(underdetermined systems need LQ)")
        b, was_vec = _rhs(b, self.tqr.r, self.m)
        qtb = self.apply_qt(b)
        x = trsm_blocked(self.tqr.r[: self.n], qtb[: self.n], lower=False,
                         block=self.block, backend=self.backend)
        return x[:, 0] if was_vec else x

    def logdet(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(0, log|det A|)`` of a square A: the reflectors with nonzero
        tau are spread over the GEQRT and TSQRT contexts, so det Q's sign
        is not kept, and the sign reads 0 (unknown), as in the reference."""
        if self.m != self.n:
            raise ValueError("logdet requires a square matrix")
        d = torch.diagonal(self.tqr.r)
        return torch.zeros((), dtype=d.dtype, device=d.device), \
            torch.sum(torch.log(torch.abs(d)))


@dataclasses.dataclass(frozen=True)
class QRCPFactors:
    """Pivoted-QR output: ``A[:, jpvt] = Q·R`` (GEQP3 or ``qrcp_local``).

    :meth:`rank` and :meth:`solve` truncate per column, ``|r_jj| >
    rcond·max|r_jj|`` (diagonal-aware): under global pivoting that is the
    first ``rank()`` columns; under windowed pivoting it also drops
    deficient columns inside early windows.
    """

    packed: torch.Tensor
    taus: torch.Tensor
    jpvt: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_numpy(cls, packed, taus, jpvt, *, block: BlockSpec = 128,
                   device=None,
                   backend: Union[str, Backend] = "cuda") -> "QRCPFactors":
        """Factors from NumPy arrays (e.g. the reference's), on ``device``
        (None = the GPU)."""
        dev = resolve_device(device)
        return cls(packed=working_copy(packed, dev),
                   taus=working_copy(taus, dev),
                   jpvt=working_copy(np.asarray(jpvt), dev, torch.int32),
                   block=block, backend=resolve_backend(backend))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(packed, taus, jpvt)`` as NumPy arrays."""
        return (self.packed.cpu().numpy(), self.taus.cpu().numpy(),
                self.jpvt.cpu().numpy())

    @property
    def m(self) -> int:
        return self.packed.shape[0]

    @property
    def n(self) -> int:
        return self.packed.shape[1]

    def _qr(self) -> QRFactors:
        return QRFactors(packed=self.packed, taus=self.taus,
                         block=self.block, backend=self.backend)

    def apply_qt(self, c) -> torch.Tensor:
        return self._qr().apply_qt(c)

    def _keep(self, rcond) -> torch.Tensor:
        d = torch.abs(torch.diagonal(self.packed))
        if rcond is None:
            rcond = max(self.m, self.n) * torch.finfo(self.packed.dtype).eps
        return d > rcond * torch.max(d)

    def rank(self, rcond=None) -> int:
        """Numerical rank: #{j : |r_jj| > rcond·max|r_jj|}."""
        return int(self._keep(rcond).sum())

    def solve(self, b, *, rcond=None) -> torch.Tensor:
        """Rank-truncated basic solution of ``min‖A·X − B‖₂`` (m ≥ n):
        columns below the cutoff are masked out of the triangular solve
        (diagonal 1, coupling 0), then ``x[jpvt] = y``."""
        if self.m < self.n:
            raise ValueError("QRCPFactors.solve requires m >= n "
                             "(underdetermined systems need LQ)")
        b, was_vec = _rhs(b, self.packed, self.m)
        n = self.n
        keep = self._keep(rcond)
        qtb = torch.where(keep[:, None], self.apply_qt(b)[:n], 0.0)
        eye = torch.eye(n, dtype=self.packed.dtype, device=self.packed.device)
        rmod = torch.where(keep[:, None] & keep[None, :],
                           torch.triu(self.packed[:n]), eye)
        y = self._qr()._r_solve(qtb, rmod)
        x = torch.empty_like(y)
        x[self.jpvt.long()] = y
        return x[:, 0] if was_vec else x


@dataclasses.dataclass(frozen=True)
class HessenbergFactors:
    """GEHRD output: the similarity transform ``A = Q·H·Qᵀ``.

    ``packed`` carries H on/above the first subdiagonal and the reflectors
    below it; :attr:`h` and :meth:`q` recover the ``(H, Q)`` pair, and
    :meth:`eigvals` runs the eigenvalue stage on the reduced form (the same
    spectrum as A).
    """

    packed: torch.Tensor
    taus: torch.Tensor
    backend: Backend
    block: BlockSpec = 128

    @classmethod
    def from_numpy(cls, packed, taus, *, block: BlockSpec = 128,
                   device=None,
                   backend: Union[str, Backend] = "cuda") -> "HessenbergFactors":
        """A reduction from NumPy arrays (e.g. the reference's), on
        ``device`` (None = the GPU)."""
        dev = resolve_device(device)
        return cls(packed=working_copy(packed, dev),
                   taus=working_copy(taus, dev), block=block,
                   backend=resolve_backend(backend))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """``(packed, taus)`` as NumPy arrays."""
        return self.packed.cpu().numpy(), self.taus.cpu().numpy()

    @property
    def n(self) -> int:
        return self.packed.shape[0]

    @property
    def h(self) -> torch.Tensor:
        """H — exactly zero below the first subdiagonal."""
        return unpack_hessenberg(self.packed)

    def q(self) -> torch.Tensor:
        """Q explicitly (ORGHR analogue)."""
        return form_q_hess(self.packed, self.taus, self.block,
                           backend=self.backend)

    def reconstruct(self) -> torch.Tensor:
        """``Q·H·Qᵀ`` — A to roundoff."""
        q = self.q()
        return self.backend.gemm(self.backend.gemm(q, self.h),
                                 q.mT.contiguous())

    def similarity(self, b) -> torch.Tensor:
        """``Qᵀ·B·Q`` — another matrix carried into the reduced basis."""
        q = self.q()
        b = torch.as_tensor(b).to(device=q.device, dtype=q.dtype)
        return self.backend.gemm(self.backend.gemm(q.mT.contiguous(), b), q)

    def eigvals(self) -> torch.Tensor:
        """Eigenvalues of A (complex), from the Hessenberg form, on the
        device that holds it; raises where the installed PyTorch has no
        eigenvalue solver for that device."""
        return torch.linalg.eigvals(self.h)


def _tensor_fields(f) -> list[str]:
    """Names of the tensor fields of a factor object (the ones a batch
    stacks); raises for a factor type with none."""
    names = [fl.name for fl in dataclasses.fields(f)
             if isinstance(getattr(f, fl.name), torch.Tensor)]
    if not names:
        raise TypeError(f"{type(f).__name__} holds no tensors to batch")
    return names


def stack_factors(items) -> "LUFactors | CholeskyFactors":
    """One factor object whose tensors carry a leading batch axis, from
    factor objects of one type, block and backend (slot ``i`` = ``items[i]``;
    the tensors are copied once)."""
    items = list(items)
    if not items:
        raise ValueError("stack_factors needs at least one factor object")
    first = items[0]
    for f in items[1:]:
        if type(f) is not type(first) or f.block != first.block \
                or f.backend is not first.backend:
            raise ValueError("stack_factors: every item must share the "
                             "factor type, block and backend")
    return dataclasses.replace(first, **{
        name: torch.stack([getattr(f, name) for f in items])
        for name in _tensor_fields(first)})


def factors_at(batched, i: int):
    """System ``i`` of a batched factor object (views, no copy)."""
    return dataclasses.replace(batched, **{
        name: getattr(batched, name)[i] for name in _tensor_fields(batched)})


def batch_size(batched) -> int:
    """The number of systems of a batched factor object; raises for one
    that holds a single system."""
    lead = getattr(batched, _tensor_fields(batched)[0])
    if lead.dim() != 3:
        raise ValueError(f"{type(batched).__name__} holds one system, not a "
                         f"batch (its {tuple(lead.shape)} factor has no batch "
                         f"axis)")
    return lead.shape[0]
