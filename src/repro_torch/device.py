"""The default-device rule and the one input copy every driver makes."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "working_copy"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; the CPU only when asked for by name.

    Raises ``RuntimeError`` when no device was named and no GPU is
    present: the port never falls back to the CPU on its own.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def working_copy(x, device: torch.device,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` (tensor, NumPy array or nested
    list) on ``device``.  The drivers update this copy in place and never
    touch the caller's array."""
    src = x if isinstance(x, torch.Tensor) else torch.tensor(x)
    out = torch.empty(src.shape, dtype=dtype or src.dtype, device=device)
    return out.copy_(src)
