"""LAPACK-style solve layer of the port: ``lu_factor``, ``gesv``,
``cholesky_factor``, ``posv`` and their factor objects."""
from repro_torch.solve.drivers import cholesky_factor, gesv, lu_factor, posv
from repro_torch.solve.factors import CholeskyFactors, LUFactors

__all__ = ["gesv", "lu_factor", "posv", "cholesky_factor", "LUFactors",
           "CholeskyFactors"]
