"""LAPACK-style solve layer of the port: ``lu_factor``, ``gesv`` and
:class:`LUFactors`."""
from repro_torch.solve.drivers import gesv, lu_factor
from repro_torch.solve.factors import LUFactors

__all__ = ["gesv", "lu_factor", "LUFactors"]
