"""Time the TRSM strip kernel at one tile width against the other.

``csrc/trsm.cu`` picks the right-hand sides a block owns by the width of
the solve: ``NC_NARROW`` (8) while its tiles run in one wave, else
``NC_WIDE`` (32).  This script builds two copies of the source with both
constants set to 8 and to 32, so one width runs at every shape, and times
them beside the library as shipped on the TRSM shapes of the main paths,
each variant checked bitwise against the shipped kernel.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/trsm_tile_width.py

Prints the card's name and power limit, then one JSON object a shape and
dtype: card ms on a busy card (median CUDA-event time of one launch queued
behind a sleep kernel) for ``shipped`` (with the NC it chose), ``nc8`` and
``nc32``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build, trsm  # noqa: E402

WIDTHS = "constexpr int NC_WIDE = 32, NC_NARROW = 8;"
#: (rows of the triangle, right-hand sides, lower, unit, right)
SHAPES = [(128, 8064, True, True, False), (128, 8064, False, False, False),
          (128, 8064, True, False, True), (128, 4096, True, True, False),
          (128, 2560, True, True, False), (128, 2048, True, True, False),
          (128, 1024, True, True, False), (128, 16, True, True, False),
          (128, 16, False, False, False)]


def build_variants() -> dict[str, ctypes.CDLL]:
    """The TRSM library with one tile width everywhere, by name."""
    src = (_build.CSRC / "trsm.cu").read_text()
    if WIDTHS not in src:
        raise SystemExit(f"trsm.cu no longer declares {WIDTHS!r}")
    out_dir = _build.BUILD_DIR / "trsm_tile_width"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for nc in (8, 32):
        cu = out_dir / f"trsm_nc{nc}.cu"
        cu.write_text(src.replace(
            WIDTHS, f"constexpr int NC_WIDE = {nc}, NC_NARROW = {nc};"))
        so = cu.with_suffix(".so")
        procs[f"nc{nc}"] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib: ctypes.CDLL, dtype: torch.dtype, right: bool):
    suffix = _build.SUFFIX[dtype]
    fn = getattr(lib, f"repro_trsm_right_{suffix}" if right
                 else f"repro_trsm_{suffix}")
    fn.argtypes = trsm._RIGHT_ARGS if right else trsm._TRSM_ARGS
    fn.restype = ctypes.c_int
    return fn


def queued_ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    libs = {"shipped": _build.library("trsm"), **build_variants()}
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        for b, n, lower, unit, right in SHAPES:
            tri = torch.randn(b, b, generator=gen, dtype=torch.float64)
            tri = (tri.tril() if lower else tri.triu()) / b
            tri.diagonal().add_(2.0)
            rhs = torch.randn(*((n, b) if right else (b, n)), generator=gen,
                              dtype=torch.float64)
            tri, rhs = tri.to(dev, dtype), rhs.to(dev, dtype)
            stream = _build.stream_of(dev)
            outs, calls = {}, {}
            for name, lib in libs.items():
                fn, out = entry(lib, dtype, right), torch.empty_like(rhs)
                head = (b, n, int(unit)) if right else (
                    b, n, int(lower), int(unit))
                args = (*head, _build.ptr(tri), _build.ld(tri),
                        _build.ptr(rhs), _build.ld(rhs), _build.ptr(out),
                        _build.ld(out), stream)

                def call(fn=fn, args=args):
                    _build.check_launch("trsm", fn(*args), "trsm")
                call()
                outs[name], calls[name] = out, call
            torch.cuda.synchronize()
            rec = {"dtype": str(dtype).removeprefix("torch."), "b": b,
                   "n": n, "lower": lower, "unit": unit, "right": right,
                   "shipped_nc": trsm.plan(b, n, dtype, right=right)["nc"],
                   "bitwise": all(torch.equal(o, outs["shipped"])
                                  for o in outs.values())}
            rounds = {name: [] for name in libs}
            for _ in range(3):  # interleaved, so drift hits every variant
                for name, call in calls.items():
                    rounds[name].append(queued_ms(call))
            rec.update({f"{name}_ms": statistics.median(v)
                        for name, v in rounds.items()})
            print(json.dumps(rec), flush=True)
            if not rec["bitwise"]:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
