"""PyTorch + CUDA port of :mod:`repro` for one NVIDIA H100.

The JAX package ``repro`` stays in the repository as the reference; this
package is its port and imports nothing of it (nor of JAX).  Module names
mirror the reference (``core/``, ``kernels/``, ``solve/``, ``obs/``) so each
counterpart is easy to find.  The kernels that the reference wrote in
Pallas for the TPU are hand-written CUDA C++ here
(``repro_torch/kernels/csrc``), each beside a plain PyTorch version of the
same algorithm.

Device rule: every entry point (``lu_factor``, ``gesv``, the
``get_variant`` drivers) takes ``device=None``, which means the GPU.  The
CPU runs only when the caller asks for it with ``device="cpu"``; with no
GPU and no explicit device the entry points raise ``RuntimeError``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
