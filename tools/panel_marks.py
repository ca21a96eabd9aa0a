"""Per-phase times of the QRCP, Hessenberg and Cholesky panel kernels and
of the WKV6 kernel on the card.

Copies the kernel sources into ``build/panel_marks/`` (the sources in the
package stay as they are), inserts marks at the phase boundaries, builds
the copies with the package's flags and runs the package's wrappers on
them, float64 and float32:

* ``qrcp``: ``clock64()`` marks in ``csrc/panel_qrcp.cu`` (block 0,
  thread 0, one row of marks a step in a ``__device__`` array);
  ``qrcp_panel`` on a ``qrcp_local`` window (16384 x 128) and on the
  global path's first block (16384 x 4096), 128 steps;
* ``hessenberg``: the same in ``csrc/panel_hessenberg.cu``;
  ``hessenberg_panel`` on ``gehrd``'s first panel at n 2048 and n 8192;
* ``cholesky``: ``%globaltimer`` marks (ns) in ``csrc/fused_pu.cu`` at the
  Cholesky kernel's phase boundaries for its first two blocks and at the
  start of each 16-column block of block 0's POTF2; the panel entry
  (``cholesky_panel``) on an 8192 x bn panel and the fused update on its
  first PU (L21 (8192 - bn) x bn), bn 128 and 384;
* ``wkv``: ``clock64()`` marks in ``csrc/wkv6.cu`` (block 0, thread 0, one
  row of marks a tile); ``wkv6_fused`` at the serving shape (4 x 64 heads
  x 1024 tokens) and at prefill_32k (1 x 64 x 32768), head dim 64, chunk
  128, bfloat16 and float32.

    python3 tools/panel_marks.py [--only qrcp,hessenberg,cholesky,wkv]

Prints the card's name and power limit, then one JSON line a shape.  QRCP
and Hessenberg: the mean cycles a step or column of each phase (the phases
named as in the kernels' notes; a barrier's phase includes the wait for
the slowest block) and the median ms of one call on a busy card (CUDA
events, the marks included); a phase is block 0's, so phases that depend
on a block's rows (the row owning j, the rows below j) read as block 0's
share.  Cholesky, in µs from block 0's start: block 0's update (or its
wait for the blocks that update the diagonal block's tiles), its POTF2 and
the zeroing of the upper triangle; block 1's own update done, its solve
done (the waits for published columns included) and its write-back done;
and the µs of each 16-column block of POTF2.  WKV: the mean cycles a
tile of each phase as thread 0 sees it (a barrier's phase includes the
wait for the slowest warp; the scores, scores x v, r_in x S_in and output
phases are warp 0's) and the median ms of one call on a busy card.
Raises if an anchor is no longer in a source.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "panel_marks"

CHOL_N = 8192

HEADER = '''
__device__ unsigned long long g_marks[1 << 16];
#define MARK(id) \\
  do { \\
    if (blockIdx.x == 0 && threadIdx.x == 0) g_marks[(j) * 16 + (id)] = clock64(); \\
  } while (0)
extern "C" int repro_marks_read(void* out) {
  return cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
'''

CHOL_HEADER = r'''
__device__ unsigned long long g_marks[1024];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define MARK(id) \
  do { if (blockIdx.x < 2 && threadIdx.x == 0) g_marks[blockIdx.x * 16 + (id)] = gtime(); } while (0)
#define BMARK(k) \
  do { if (blockIdx.x == 0 && threadIdx.x == 0) g_marks[64 + (k)] = gtime(); } while (0)
extern "C" int repro_marks_read(void* out) {
  return cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
'''

# (text in the source, mark before it (True) or after it, phase ending at
# the mark); the first mark of a step starts it, the last ends it
QRCP_MARKS = [
    ("    // A. the pivot: the owners' first largest norm", True, "start"),
    ("    const int p = static_cast<int>(*s_p);", True, "pivot"),
    ("    // swap columns j and p of the rows >= j; bring column j current:",
     True, "F[p, :j] read"),
    ("    if (D.owns(j)) {  // row j as the pass finds it", True,
     "swap, bring-current"),
    ("    flat_col_sums<T, false, !RESIDENT>(row_at,", True, "row j published"),
    ("    grid.sync();\n\n    // B. warp 0", True, "pass"),
    ("    // B. warp 0 sums |x|^2 below row j and reads alpha;", True,
     "barrier 1"),
    ("    const T alpha = sc[0], s2 = sc[1];", True,
     "reflector's sums, owners' sums"),
    ("    // the block's rows of v (row j keeps beta) and of V", True,
     "owners' columns"),
    ("    if (j + 1 < steps) grid.sync();", True, "v scaled"),
    ("    if (j + 1 < steps) grid.sync();", False, "barrier 2"),
]
HESS_MARKS = [
    ("    const bool valid = kj < n - 2;  // rows kj+2.. exist: reduce them",
     False, "start"),
    ("    group_sums<T>(\n        nr, lgr,", True, "s = T V[kj, :]^T"),
    ("    if (lay.v >= 0)\n      block_col_sums<T, false>(vs, ldv, xc, 1, 0,",
     True, "right update"),
    ("    // 2. u = V^T col", True, "V^T col sums, barrier 1"),
    ("    group_sums<T>(\n        j, lgt, [](int) { return 0; }", True,
     "u all-reduce"),
    ("    const int lk = static_cast<int>", True, "z = T^T u"),
    ("    const int lo1 = static_cast<int>", True, "left update"),
    ("    // 3. warp 0 sums the norm and reads alpha;", True,
     "norm and V^T x sums, barrier 2"),
    ("    T* tcol = ts + ", True, "reflector, V^T x all-reduce"),
    ("      cp_async_wait<0>();", True, "T's column"),
    ("    // the block's rows of A[:, kj] below kj and of V[:, j]", True,
     "x copied"),
    ("    if (!valid) continue;  // W[:, j] stays zero", False,
     "A and V written"),
]


# (text in the source, mark before it (True) or after it, the mark)
CHOL_MARKS = [
    ("  // 1. the block's rows -= L21[rows] lrow^T; the diagonal block's 64-row",
     True, "MARK(0);"),
    ("    auto done = [&](int k) {\n      if (tid == 0) flag_release", True,
     "MARK(1);"),
    ("    for (int e = tid; e < bn * bn; e += CHOL_THREADS) {\n"
     "      const int r = e / bn, c = e % bn;\n      if (c > r)", True,
     "MARK(2);"),
    ("  if (blockIdx.x > 0 && n > 0) {", True, "MARK(3);"),
    ("      for (int e = tid; e < n * bn; e += CHOL_THREADS) {\n"
     "        const int rr = e / bn, c = e % bn;\n        p[(r0 + rr)", True,
     "MARK(4);"),
    ("  // the last block to finish sets the flags back to 0", True,
     "MARK(5);"),
    ("    const int w = min(S, bn - k0);  // the block's columns", False,
     "BMARK(k0 / S);"),
]

WKV_HEADER = '''
__device__ unsigned long long g_marks[1 << 16];
#define MARK(id) \\
  do { \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && mark_it < 4096) \\
      g_marks[mark_it * 16 + (id)] = clock64(); \\
  } while (0)
extern "C" int repro_marks_read(void* out) {
  return cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
extern "C" int repro_marks_clear() {
  static unsigned long long zero[1 << 16];
  return cudaMemcpyToSymbol(g_marks, zero, sizeof(g_marks));
}
'''

# (text in the source, mark before it (True) or after it, inserted text);
# the phases end at marks 1 .. 8
WKV_MARKS = [
    ("  if (tid == 0) s_tk[0] = take_ticket(ticket, total);", True,
     "int mark_it = -1;"),
    ("  for (;; buf ^= 1) {", False, "if (mark_it >= 0) MARK(8);"),
    ("    if (tk >= total) break;", False, "++mark_it;\nMARK(0);"),
    ("    // the next tile's rows into L2, a 128-byte line a thread", True,
     "MARK(1);"),
    ("    // 2. k_fwd^T v: this part's rows, in order", True, "MARK(2);"),
    ("    // 3. the state chain: wait for S_in, publish S_out", True,
     "MARK(3);"),
    ("    {\n      // every thread 4 consecutive entries of S at a time", True,
     "MARK(4);"),
    ("    if (tid == 0) {\n      if (!last)", True, "MARK(5);"),
    ("      // scores x v: half h of the warp", True, "MARK(6);"),
    ("#pragma unroll\n      for (int x = 0; x < 8; ++x) {\n"
     "        const int t = x < 4 ? 4 * q1 + x : 4 * q2 + x - 4;\n"
     "        if (t >= n", True, "MARK(7);"),
]
WKV_PHASES = ["loads", "prefetch, scan and factors", "k_fwd^T v",
              "partials and chain wait", "state published",
              "score rows and r_in x S_in", "scores x v", "out written"]

TAIL = {"panel_qrcp": "to the next step",
        "panel_hessenberg": "GEMV, to the next column"}


def instrument(path: Path, include: str, header: str, inserts) -> None:
    """Insert ``header`` after ``include`` and each (anchor, before, text)
    of ``inserts`` into the source at ``path``."""
    s = path.read_text()
    s = s.replace(include, include + header, 1)
    for anchor, before, text in inserts:
        at = s.index(anchor)
        if not before:
            at += len(anchor)
        s = s[:at] + ("" if before else "\n") + text + "\n" + s[at:]
    path.write_text(s)


def instrument_steps(path: Path, marks) -> list[str]:
    """The clock64 step marks into the source at ``path``; the phase
    names."""
    instrument(path, '#include "dense.cuh"\n', HEADER,
               [(a, b, f"MARK({mid});") for mid, (a, b, _) in enumerate(marks)])
    return [m[2] for m in marks[1:]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="qrcp,hessenberg,cholesky,wkv",
                    help="comma-separated kernels to mark")
    only = set(ap.parse_args().only.split(","))
    if not torch.cuda.is_available():
        print("panel_marks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_panel_update as fpu
    from repro_torch.kernels import panel_hessenberg as ph
    from repro_torch.kernels import panel_qrcp as pq
    from repro_torch.kernels import wkv6

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = OUT / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    names = {}
    if "qrcp" in only:
        names["panel_qrcp"] = instrument_steps(src / "panel_qrcp.cu",
                                               QRCP_MARKS)
    if "hessenberg" in only:
        names["panel_hessenberg"] = instrument_steps(
            src / "panel_hessenberg.cu", HESS_MARKS)
    libs = list(names)
    if "cholesky" in only:
        instrument(src / "fused_pu.cu", '#include "strip.cuh"\n', CHOL_HEADER,
                   CHOL_MARKS)
        libs.append("fused_pu")
    if "wkv" in only:
        instrument(src / "wkv6.cu", '#include "common.cuh"\n', WKV_HEADER,
                   WKV_MARKS)
        libs.append("wkv6")
    _build.CSRC, _build.BUILD_DIR = src, OUT / "lib"
    _build.sources = lambda: libs
    _build.build_all()

    def read(lib: str, size: int) -> np.ndarray:
        buf = (ctypes.c_ulonglong * size)()
        fn = _build.library(lib).repro_marks_read
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        if fn(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("panel_marks: reading the marks failed")
        return np.frombuffer(buf, dtype=np.uint64).astype(np.int64)

    def marks(lib: str, rows: int) -> np.ndarray:
        a = read(lib, 1 << 16).reshape(-1, 16)
        return a[:rows, : len(names[lib]) + 1]

    def busy_ms(fn, reps=5) -> float:
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

    def cholesky(dtype, gen):
        for bn in (128, 384):
            g = torch.randn(bn, bn, generator=gen, device=dev, dtype=dtype)
            spd = g @ g.mT / bn + torch.eye(bn, device=dev, dtype=dtype)
            l21 = 0.1 * torch.randn(CHOL_N - bn, bn, generator=gen,
                                    device=dev, dtype=dtype)
            cases = {"cholesky_panel": (
                         CHOL_N, lambda w: fpu.cholesky_panel(w, bn)),
                     "fused_cholesky_panel_update": (
                         CHOL_N - bn,
                         lambda w: fpu.fused_cholesky_panel_update(l21[:bn],
                                                                   l21, w))}
            for name, (m, run) in cases.items():
                panel = 0.1 * torch.randn(m, bn, generator=gen, device=dev,
                                          dtype=dtype)
                panel[:bn] = spd + (l21[:bn] @ l21[:bn].mT
                                    if m < CHOL_N else 0)
                work = torch.empty_like(panel)
                for _ in range(3):
                    run(work.copy_(panel))
                torch.cuda.synchronize()
                a = read("fused_pu", 1024)
                b0, b1, t0 = a[0:16], a[16:32], a[0]
                blocks = a[64:64 + (bn + 15) // 16]
                us = lambda x: round(float(x - t0) / 1e3, 3)   # noqa: E731
                print(json.dumps({
                    "kernel": name, "dtype": str(dtype), "shape": [m, bn],
                    "block0_us": {"update_or_wait_done": us(b0[1]),
                                  "potf2_done": us(b0[2]),
                                  "zeroed": us(b0[3])},
                    "block1_us": {"own_update_done": us(b1[3]),
                                  "solve_done": us(b1[4]),
                                  "written_back": us(b1[5])},
                    "potf2_block_us": [round(float(v) / 1e3, 3) for v in
                                       np.diff(np.append(blocks, b0[2]))]}),
                      flush=True)
                del panel, work

    def wkv():
        for dtype in (torch.bfloat16, torch.float32):
            for what, bsz, seq in (("serve", 4, 1024),
                                   ("prefill_32k", 1, 32768)):
                gen = torch.Generator(device=dev).manual_seed(10)
                shape = (bsz, 64, seq, 64)
                r, k, v = (torch.randn(shape, generator=gen, device=dev)
                           .to(dtype) for _ in range(3))
                logw = -torch.exp(-0.6 + 0.42 * torch.randn(
                    shape, generator=gen, device=dev))
                u = 0.5 * torch.randn(64, 64, generator=gen, device=dev)
                ms = busy_ms(lambda: wkv6.wkv6_fused(r, k, v, logw, u))
                if _build.library("wkv6").repro_marks_clear() != 0:
                    raise RuntimeError("panel_marks: clearing the marks "
                                       "failed")
                wkv6.wkv6_fused(r, k, v, logw, u)
                torch.cuda.synchronize()
                a = read("wkv6", 1 << 16).reshape(-1, 16)
                a = a[: int((a[:, 0] > 0).sum()), :9]
                phases = np.diff(a, axis=1)[1:].mean(0)   # tile 0 left out
                tail = (a[1:, 0] - a[:-1, 8]).mean()
                row = dict(zip(WKV_PHASES,
                               (round(float(p)) for p in phases)))
                row["to the next tile"] = round(float(tail))
                print(json.dumps({"kernel": f"wkv6_fused {what}",
                                  "dtype": str(dtype), "tiles": len(a),
                                  "ms": ms, "cycles": row}), flush=True)
                del r, k, v, logw, u

    dev = torch.device("cuda")
    if "wkv" in only:
        wkv()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = []
        if "panel_qrcp" in names:
            cases += [("panel_qrcp", f"qrcp {r} x {c}", (r, c),
                       lambda x: pq.qrcp_panel(x, 128))
                      for r, c in ((16384, 128), (16384, 4096))]
        if "panel_hessenberg" in names:
            cases += [("panel_hessenberg", f"hessenberg n {n} k 0", (n, n),
                       lambda x: ph.hessenberg_panel(x, 0, 128))
                      for n in (2048, 8192)]
        for lib, what, shape, run in cases:
            x0 = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            work = torch.empty_like(x0)
            ms = busy_ms(lambda: run(work.copy_(x0))) \
                - busy_ms(lambda: work.copy_(x0))
            a = marks(lib, 128)
            phases = np.diff(a, axis=1)[1:].mean(0)   # step 0 left out
            tail = (a[1:, 0] - a[:-1, -1]).mean()     # to the next step
            row = dict(zip(names[lib], (round(float(p)) for p in phases)))
            row[TAIL[lib]] = round(float(tail))
            print(json.dumps({"kernel": what, "dtype": str(dtype), "ms": ms,
                              "cycles": row}), flush=True)
            del x0, work
        if "cholesky" in only:
            cholesky(dtype, gen)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
