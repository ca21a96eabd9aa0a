"""Factorization core of the port: blocking, backend vtable, the look-ahead
engine, the nine DMFs (LU, Cholesky, QR, LDLᵀ, Gauss–Jordan inversion,
band reduction, QRCP, windowed QRCP, Hessenberg) and the variant registry
(:func:`repro_torch.core.lookahead.get_variant`)."""
from repro_torch.core.band_reduction import (band_reduction_blocked,
                                             band_reduction_lookahead,
                                             check_uniform_tiling)
from repro_torch.core.gauss_jordan import (GAUSS_JORDAN_OPS,
                                           gj_inverse_blocked,
                                           gj_inverse_lookahead,
                                           gj_inverse_unblocked)
from repro_torch.core.ldlt import (LDLT_OPS, ldlt_blocked, ldlt_lookahead,
                                   ldlt_panel, ldlt_unblocked, unpack_ldlt)

__all__ = ["LDLT_OPS", "ldlt_blocked", "ldlt_lookahead", "ldlt_panel",
           "ldlt_unblocked", "unpack_ldlt", "GAUSS_JORDAN_OPS",
           "gj_inverse_blocked", "gj_inverse_lookahead",
           "gj_inverse_unblocked", "band_reduction_blocked",
           "band_reduction_lookahead", "check_uniform_tiling"]
