"""Time the GETF2 panel and the fused LU panel update of one source tree.

Runs ``lu_panel`` on the main path's 8192 x 128 panel and
``fused_lu_panel_update`` on its first PU (L11 128 x 128, an 8064 x 128
panel), float64 and float32, from the ``repro_torch`` package under
``--src`` (by default this repository's ``src``), so that two trees can be
timed in turns on one card:

    python3 tools/lu_panel_timing.py                  # this tree
    python3 tools/lu_panel_timing.py --src OTHER/src  # another checkout

Both kernels factor in place, so each run starts from a fresh copy of its
operands and the copy's own time is subtracted.  Prints the card's name
and power limit, then one JSON object: for each dtype and kernel, the
median card ms on a busy card (``ms``: one call queued behind a sleep
kernel, CUDA events) and of one call from an idle card (``call_ms``: host
work included), and the `src` path it ran.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

N, BLOCK, SEED = 8192, 128, 0


def time_ms(fn, reps: int, busy: bool) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(5_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def both(run, copy, reps=20) -> dict:
    return {"ms": time_ms(run, reps, True) - time_ms(copy, reps, True),
            "call_ms": time_ms(run, reps, False) - time_ms(copy, reps, False)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lu_panel_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build, panel_lu
    from repro_torch.kernels import fused_panel_update as fpu

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda")
    res = {"src": args.src}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        panel0 = randn(N, BLOCK)
        work = torch.empty_like(panel0)
        row = {"lu_panel": both(
            lambda: panel_lu.lu_panel(work.copy_(panel0)),
            lambda: work.copy_(panel0))}
        m = N - BLOCK
        l11 = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
        l21, a1l0, a2l0 = randn(m, BLOCK), randn(BLOCK, BLOCK), randn(m, BLOCK)
        a1l, a2l = torch.empty_like(a1l0), torch.empty_like(a2l0)

        def fresh():
            a1l.copy_(a1l0)
            a2l.copy_(a2l0)

        def fused():
            fresh()
            fpu.fused_lu_panel_update(l11, l21, a1l, a2l)

        row["fused_lu_panel_update"] = both(fused, fresh)
        res[str(dtype).replace("torch.", "")] = row
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
