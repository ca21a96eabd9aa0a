"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
``build/repro_torch/lib<name>-<hash>.so`` at the repository root, at first
use; the hash covers the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source rebuilds and an unchanged one loads at once.
All sources that need a build compile together, one ``nvcc`` process each.

The libraries have a plain C interface: pointers, ``int64`` sizes and row
strides, scalars as ``double`` and the CUDA stream, each function returning
its ``cudaError_t``.  They include no PyTorch header, which keeps a build at
seconds rather than minutes.

This module also holds the checks every kernel wrapper runs before it
passes pointers to C: device, dtype, rank and a unit stride in the last
dimension.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: dtypes the kernels are instantiated for, with their C symbol suffix
#: (bfloat16 only by the flash-attention kernel)
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
#: dtypes of the dense linear-algebra kernels (every one but attention)
DENSE_DTYPES = (torch.float32, torch.float64)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

c_ptr = ctypes.c_void_p
c_i64 = ctypes.c_int64
c_f64 = ctypes.c_double


def nvcc() -> str:
    """``nvcc`` from ``PATH``, else from the toolkit under ``CUDA_HOME``
    (by default its standard install location)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing; return the
    ``nvcc -Xptxas -v`` log of each source (name -> text)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in sources():
        target = _target(name)
        if not target.exists():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            pending[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: _target(name).with_suffix(".log").read_text()
            for name in sources()}


_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                         r"(?:, (\d+) bytes smem)?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_summary(log: str) -> list[dict]:
    """Registers, static shared memory and spills per kernel, from a
    ``-Xptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["smem_bytes"] = int(m.group(2) or 0)
    return out


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_MMA = re.compile(r"\b(HGMMA|HMMA|DMMA)\.")


def sass_mma_counts(name: str) -> dict[str, int]:
    """Tensor-core instructions (``HGMMA``, ``HMMA``, ``DMMA``) in the SASS
    of each kernel of the built ``csrc/<name>.cu``, by mangled kernel name,
    from ``cuobjdump -sass`` (beside ``nvcc``)."""
    cuobjdump = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = _SASS_FN.search(line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur is not None and _SASS_MMA.search(line):
            out[cur] += 1
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
        return lib


_FUNCTIONS: dict[tuple[str, str], object] = {}


def function(lib: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of ``lib`` with its argument types set
    (kept after the first call: a wrapper's host work is part of every
    launch)."""
    fn = _FUNCTIONS.get((lib, symbol))
    if fn is None:
        fn = getattr(library(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[lib, symbol] = fn
    return fn


def check_launch(lib: str, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = library(lib).repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` as a raw handle (PyTorch's
    ``_cuda_getCurrentRawStream``: ``torch.cuda.current_stream`` builds a
    ``Stream`` under a device guard, several µs a launch)."""
    return c_ptr(torch._C._cuda_getCurrentRawStream(device.index))


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` unless ``device`` is already the
    current one, where entering it would only cost host time."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return c_ptr(t.data_ptr())


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (for 16-byte vector loads and TMA):
    a copy of a view that is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# Operand checks shared by the wrappers.
# ---------------------------------------------------------------------------
def check_matrix(what: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device) -> None:
    """2-D, ``dtype``, on ``device``, unit stride in the last dimension."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{what} must be a 2-D tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{what} needs unit stride in its last dimension, "
                         f"got strides {t.stride()}")
    if t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{what} rows overlap (strides {t.stride()})")


def kernel_dtype(what: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in DENSE_DTYPES:
        raise ValueError(f"{what}: dtype {t.dtype} not supported "
                         f"(float32 or float64)")
    return t.dtype


def ld(t: torch.Tensor) -> int:
    """Row stride (leading dimension) of a row-major matrix view."""
    return max(t.stride(0), t.shape[1], 1)
