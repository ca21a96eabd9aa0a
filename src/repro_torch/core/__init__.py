"""Factorization core of the port: blocking, backend vtable, the look-ahead
engine, LU and the variant registry."""
