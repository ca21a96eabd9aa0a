"""LAPACK-style solve layer of the port: ``lu_factor``, ``gesv``,
``cholesky_factor``, ``posv``, ``qr_factor``, ``geqp3``, ``gels`` and their
factor objects."""
from repro_torch.solve.drivers import (cholesky_factor, geqp3, gels, gesv,
                                       lu_factor, posv, qr_factor)
from repro_torch.solve.factors import (CholeskyFactors, LUFactors,
                                       QRCPFactors, QRFactors)

__all__ = ["gesv", "lu_factor", "posv", "cholesky_factor", "gels",
           "qr_factor", "geqp3", "LUFactors", "CholeskyFactors", "QRFactors",
           "QRCPFactors"]
