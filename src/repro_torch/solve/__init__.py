"""LAPACK-style solve layer of the port: ``lu_factor``, ``gesv``,
``cholesky_factor``, ``posv``, ``ldlt_factor``, ``qr_factor``, ``geqp3``,
``gels``, ``gehrd``, ``getri``, ``gecon``, their factor objects, the
batched drivers (:mod:`.batched`) and the blocked triangular solves
(:mod:`.triangular`)."""
from repro_torch.solve.batched import (cholesky_factor_batched, gesv_batched,
                                       lu_factor_batched, posv_batched,
                                       solve_batched)
from repro_torch.solve.drivers import (cholesky_factor, gecon, gehrd, geqp3,
                                       gels, gesv, getri, ldlt_factor,
                                       lu_factor, posv, qr_factor)
from repro_torch.solve.factors import (CholeskyFactors, HessenbergFactors,
                                       LDLTFactors, LUFactors, QRCPFactors,
                                       QRFactors, TiledQRFactors, factors_at,
                                       stack_factors)
from repro_torch.solve.triangular import lu_solve_packed, trsm_blocked

__all__ = ["gesv", "lu_factor", "posv", "cholesky_factor", "ldlt_factor",
           "gels", "qr_factor", "geqp3", "gehrd", "getri", "gecon",
           "LUFactors", "CholeskyFactors", "LDLTFactors", "QRFactors",
           "QRCPFactors", "HessenbergFactors", "TiledQRFactors",
           "stack_factors", "factors_at",
           "gesv_batched", "posv_batched", "lu_factor_batched",
           "cholesky_factor_batched", "solve_batched",
           "trsm_blocked", "lu_solve_packed"]
