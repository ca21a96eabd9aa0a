"""Gradient compression for the collective term, with error feedback.

The port of :mod:`repro.optim.compression`.  Two compressors, both with an
error-feedback residual so the compression noise does not bias the
trajectory:

* ``bf16`` — 2× volume; the residual keeps the rounding error.
* ``int8`` — 4× volume; per-tensor absmax scaling, rounding to nearest
  (half to even), or stochastic rounding when a ``torch.Generator`` is
  given (the reference takes a PRNG key there; the trainer passes none).

The math simulates the quantize → reduce → dequantize path on one device,
as the reference's does; the residual is a float32 tree beside the params.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["GradCompression"]


@dataclasses.dataclass(frozen=True)
class GradCompression:
    mode: str = "none"             # none | bf16 | int8
    error_feedback: bool = True

    def init(self, params):
        if self.mode == "none" or not self.error_feedback:
            return None
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def compress(self, grads, residual,
                 generator: Optional[torch.Generator] = None):
        """Returns (compressed-then-dequantized grads, new residual)."""
        if self.mode == "none":
            return grads, residual

        def one(g, r):
            gf = g.float()
            if r is not None:
                gf = gf + r
            if self.mode == "bf16":
                q = gf.to(torch.bfloat16).float()
            elif self.mode == "int8":
                scale = torch.max(torch.abs(gf)) / 127.0 + 1e-30
                x = gf / scale
                if generator is not None:      # stochastic rounding
                    x = x + (torch.rand(x.shape, generator=generator,
                                        device=x.device) - 0.5)
                q = torch.clamp(torch.round(x), -127, 127) * scale
            else:
                raise ValueError(self.mode)
            return q.to(g.dtype), (gf - q) if r is not None else None

        g_leaves = leaves(grads)
        r_leaves = leaves(residual) if residual is not None \
            else [None] * len(g_leaves)
        out, new_res = zip(*[one(g, r) for g, r in zip(g_leaves, r_leaves)])
        return unflatten(grads, out), (unflatten(residual, new_res)
                                       if residual is not None else None)
