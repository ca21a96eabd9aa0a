"""Factorization core of the port: blocking, backend vtable, the look-ahead
engine, the DMFs (LU, Cholesky, QR, QRCP, Hessenberg) and the variant
registry."""
