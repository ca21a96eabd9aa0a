"""Time the hand-written panel kernels of one source tree on the card.

Runs, float64 and float32, from the ``repro_torch`` package under ``--src``
(by default this repository's ``src``), so that two trees can be timed in
turns on one card:

* ``lu``: ``lu_panel`` on the main path's 8192 x 128 panel and
  ``fused_lu_panel_update`` on its first PU (L11 128 x 128, an 8064 x 128
  panel);
* ``cholesky``: ``fused_cholesky_panel_update`` on ``posv``'s first PU
  (lrow 128 x 128, an 8064 x 128 panel) and at block 384 (a 7808 x 384
  panel), and the Cholesky panel kernel ``cholesky_panel`` on the first
  panel (8192 x 128, and 8192 x 384) where the tree has it;
* ``cholesky_wide``: the Cholesky panel at blocks whose POTF2 column
  array leaves shared memory (8192 x 2048 float64, 8192 x 4096 float32):
  the PyTorch-op panel (``core.cholesky.cholesky_panel``: PyTorch ops,
  then the right TRSM kernel) and the ``cholesky_panel`` kernel where the
  tree has it, 3 calls each;
* ``qr``: ``qr_panel`` on the ``gels`` path's first panel (16384 x 128,
  rows resident in shared memory) and on a 65536 x 128 panel (streamed),
  and its ``larft`` entry on a 16384 x 128 V;
* ``qrcp``: ``qrcp_panel`` on a ``qrcp_local`` window (16384 x 128) and on
  the global path's first block (16384 x 4096), 128 steps each;
* ``hessenberg``: ``hessenberg_panel`` on ``gehrd``'s first panel at
  n 8192 (k 0), its middle one (k 4096) and the first at n 2048, 128
  columns each;
* ``wkv``: ``wkv6_fused`` (bfloat16 and float32 r, k, v; chunk 128, head
  dim 64, 64 heads) at the serving shape (batch 4, 1024 tokens), at
  prefill_32k (batch 1, 32768 tokens) and on 1000 tokens from a state
  (batch 4, s0 ~ N(0, 1)), r, k, v, logw and u drawn as ``chip_smoke.py``
  draws them.

    python3 tools/panel_timing.py                       # this tree, all
    python3 tools/panel_timing.py --src OTHER/src       # another checkout
    python3 tools/panel_timing.py --only cholesky
    python3 tools/panel_timing.py --only wkv
    python3 tools/panel_timing.py --only qr,qrcp

The panel kernels work in place, so each run starts from a fresh copy of
its operands and the copy's own time is subtracted (``wkv6_fused`` does
not: its calls are timed as they are).  Prints the card's name
and power limit, then one JSON object: for each dtype and kernel shape,
the median card ms on a busy card (``ms``: one call queued behind a sleep
kernel, CUDA events) and of one call from an idle card (``call_ms``: host
work included), and the ``src`` path it ran.
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
QR_M, QR_N, HESS_SMALL = 16384, 4096, 2048
QR_STREAMED_M = 65536
#: wkv: (key, batch, tokens, from a state, repetitions); 64 heads of 64
WKV_SHAPES = (("serve", 4, 1024, False, 20),
              ("prefill_32k", 1, 32768, False, 5),
              ("ragged", 4, 1000, True, 20))
WKV_HEADS, WKV_DIM, WKV_CHUNK = 64, 64, 128


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


def in_place(kernel, operand0: torch.Tensor, reps: int) -> dict:
    """``both`` of ``kernel(work)`` on a fresh copy of ``operand0``."""
    work = torch.empty_like(operand0)
    row = both(lambda: kernel(work.copy_(operand0)),
               lambda: work.copy_(operand0), reps)
    del work
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--only", default="lu,cholesky,qrcp,hessenberg,wkv",
                    help="comma-separated groups: lu, cholesky, "
                         "cholesky_wide, qr, qrcp, hessenberg, wkv")
    args = ap.parse_args()
    groups = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("panel_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.core.qr import unpack_v
    from repro_torch.kernels import _build, panel_hessenberg, panel_lu, \
        panel_qr, panel_qrcp
    from repro_torch.core.cholesky import cholesky_panel as op_panel
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

        row = {}
        if "lu" in groups:
            row["lu_panel"] = in_place(panel_lu.lu_panel, randn(N, BLOCK), 20)
            m = N - BLOCK
            l11 = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
            l21, a1l0, a2l0 = randn(m, BLOCK), randn(BLOCK, BLOCK), \
                randn(m, BLOCK)
            a1l, a2l = torch.empty_like(a1l0), torch.empty_like(a2l0)

            def fresh():
                a1l.copy_(a1l0)
                a2l.copy_(a2l0)

            def fused():
                fresh()
                fpu.fused_lu_panel_update(l11, l21, a1l, a2l)

            row["fused_lu_panel_update"] = both(fused, fresh)
            del l11, l21, a1l0, a2l0, a1l, a2l
        if "cholesky" in groups:
            def spd(n):
                g = randn(n, n)
                return g @ g.mT / n + torch.eye(n, dtype=dtype, device=dev)

            for bb in (BLOCK, 3 * BLOCK):
                sfx = "" if bb == BLOCK else f"_b{bb}"
                m = N - bb
                l21 = 0.1 * randn(m, bb)
                panel = 0.1 * randn(m, bb)
                panel[:bb] = l21[:bb] @ l21[:bb].mT + spd(bb)
                row["fused_cholesky_panel_update" + sfx] = in_place(
                    lambda p: fpu.fused_cholesky_panel_update(l21[:bb], l21, p),
                    panel, 20)
                if hasattr(fpu, "cholesky_panel"):
                    first = 0.1 * randn(N, bb)
                    first[:bb] = spd(bb)
                    row["cholesky_panel" + sfx] = in_place(
                        lambda p: fpu.cholesky_panel(p, bb), first, 20)
                    del first
                del l21, panel
        if "cholesky_wide" in groups:
            bw = 2048 if dtype == torch.float64 else 4096
            g = randn(bw, bw)
            first = 0.1 * randn(N, bw)
            first[:bw] = g @ g.mT / bw + torch.eye(bw, dtype=dtype, device=dev)
            del g
            row[f"pytorch_op_panel_b{bw}"] = in_place(
                lambda p: op_panel(p, bw, "cuda"), first, 3)
            if hasattr(fpu, "cholesky_panel"):
                row[f"cholesky_panel_b{bw}"] = in_place(
                    lambda p: fpu.cholesky_panel(p, bw), first, 3)
            del first
        if "qr" in groups:
            for key, m in (("qr_panel", QR_M),
                           ("qr_panel_streamed", QR_STREAMED_M)):
                row[key] = in_place(panel_qr.qr_panel, randn(m, BLOCK), 20)
            v = randn(QR_M, BLOCK)
            _, tau, _ = panel_qr.qr_panel(v)
            v = unpack_v(v, BLOCK)
            row["larft"] = both(lambda: panel_qr.larft(v, tau), lambda: None)
            del v, tau
        if "qrcp" in groups:
            for key, cols, reps in (("qrcp_panel_window", BLOCK, 20),
                                    ("qrcp_panel_global", QR_N, 10)):
                row[key] = in_place(
                    lambda blk: panel_qrcp.qrcp_panel(blk, BLOCK),
                    randn(QR_M, cols), reps)
        if "hessenberg" in groups:
            for key, n, k in (("hessenberg_panel_n8192_k0", N, 0),
                              ("hessenberg_panel_n8192_k4096", N, N // 2),
                              ("hessenberg_panel_n2048_k0", HESS_SMALL, 0)):
                row[key] = in_place(
                    lambda a, k=k: panel_hessenberg.hessenberg_panel(
                        a, k, BLOCK), randn(n, n), 10 if n == N else 20)
        if row:
            res[str(dtype).replace("torch.", "")] = row
        torch.cuda.empty_cache()
    if "wkv" in groups:
        from repro_torch.kernels import wkv6
        for dtype in (torch.bfloat16, torch.float32):
            row = {}
            for key, bsz, seq, from_state, reps in WKV_SHAPES:
                gen = torch.Generator(device=dev).manual_seed(SEED + 10)

                def randn(*shape):
                    return torch.randn(shape, generator=gen, device=dev)

                shape = (bsz, WKV_HEADS, seq, WKV_DIM)
                r, k, v = (randn(*shape).to(dtype) for _ in range(3))
                logw = -torch.exp(-0.6 + 0.42 * randn(*shape))
                u = 0.5 * randn(WKV_HEADS, WKV_DIM)
                s0 = randn(bsz, WKV_HEADS, WKV_DIM, WKV_DIM) if from_state \
                    else None

                def run():
                    return wkv6.wkv6_fused(r, k, v, logw, u, s0=s0,
                                           chunk=WKV_CHUNK)

                row[key] = {"ms": time_ms(run, reps, True),
                            "call_ms": time_ms(run, reps, False)}
                del r, k, v, logw, u, s0
            res["wkv_" + str(dtype).replace("torch.", "")] = row
            torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
