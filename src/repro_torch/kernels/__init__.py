"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions and wrappers; :mod:`.ops` assembles them into the ``"cuda"``
backend.  Nothing is built or loaded at import time."""
