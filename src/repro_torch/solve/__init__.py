"""LAPACK-style solve layer of the port: ``lu_factor``, ``gesv``,
``cholesky_factor``, ``posv``, ``ldlt_factor``, ``qr_factor``, ``geqp3``,
``gels``, ``gehrd``, ``getri``, ``gecon`` and their factor objects."""
from repro_torch.solve.drivers import (cholesky_factor, gecon, gehrd, geqp3,
                                       gels, gesv, getri, ldlt_factor,
                                       lu_factor, posv, qr_factor)
from repro_torch.solve.factors import (CholeskyFactors, HessenbergFactors,
                                       LDLTFactors, LUFactors, QRCPFactors,
                                       QRFactors, TiledQRFactors)

__all__ = ["gesv", "lu_factor", "posv", "cholesky_factor", "ldlt_factor",
           "gels", "qr_factor", "geqp3", "gehrd", "getri", "gecon",
           "LUFactors", "CholeskyFactors", "LDLTFactors", "QRFactors",
           "QRCPFactors", "HessenbergFactors", "TiledQRFactors"]
