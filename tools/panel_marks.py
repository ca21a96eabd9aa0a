"""Per-phase cycle counts of the QRCP and Hessenberg panel kernels on the card.

Copies the kernel sources into ``build/panel_marks/`` (the sources in the
package stay as they are), inserts a ``clock64()`` mark at each phase
boundary of ``csrc/panel_qrcp.cu`` and ``csrc/panel_hessenberg.cu`` (block
0, thread 0, one row of marks a step or column in a ``__device__`` array),
builds the two copies with the package's flags and runs the package's
wrappers on them: ``qrcp_panel`` on a ``qrcp_local`` window (16384 x 128)
and on the global path's first block (16384 x 4096), 128 steps, and
``hessenberg_panel`` on ``gehrd``'s first panel at n 2048 and n 8192,
float64 and float32.

    python3 tools/panel_marks.py

Prints the card's name and power limit, then one JSON line a shape: the
mean cycles a step or column of each phase (the phases named as in the
kernels' notes; a barrier's phase includes the wait for the slowest block)
and the median ms of one call on a busy card (CUDA events, the marks
included).  A phase is block 0's, so phases that depend on a block's rows
(the row owning j, the rows below j) read as block 0's share.  Raises if
an anchor is no longer in a source.
"""
from __future__ import annotations

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

# (text in the source, mark before it (True) or after it, phase ending at
# the mark); the first mark of a step starts it, the last ends it
QRCP_MARKS = [
    ("    // A. the pivot: the owners' first largest norm", True, "start"),
    ("    const int p = static_cast<int>(*s_p);", True, "pivot"),
    ("    // swap columns j and p of the rows >= j; bring column j current:",
     True, "F[p, :j] read"),
    ("    if (j >= r0 && j < r1) {  // row j as the pass finds it", True,
     "swap, bring-current"),
    ("    block_col_sums<T, false, !RESIDENT>(", True, "row j published"),
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


TAIL = {"panel_qrcp": "to the next step",
        "panel_hessenberg": "GEMV, to the next column"}


def instrument(path: Path, marks) -> list[str]:
    """Insert the marks into the source at ``path``; the phase names."""
    s = path.read_text()
    s = s.replace('#include "dense.cuh"\n', '#include "dense.cuh"\n' + HEADER, 1)
    for mid, (anchor, before, _) in enumerate(marks):
        at = s.index(anchor)
        if not before:
            at += len(anchor)
        s = s[:at] + ("" if before else "\n") + f"MARK({mid});\n" + s[at:]
    path.write_text(s)
    return [m[2] for m in marks[1:]]


def main() -> int:
    if not torch.cuda.is_available():
        print("panel_marks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import panel_hessenberg as ph
    from repro_torch.kernels import panel_qrcp as pq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = OUT / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    names = {"panel_qrcp": instrument(src / "panel_qrcp.cu", QRCP_MARKS),
             "panel_hessenberg": instrument(src / "panel_hessenberg.cu",
                                            HESS_MARKS)}
    _build.CSRC, _build.BUILD_DIR = src, OUT / "lib"
    _build.sources = lambda: ["panel_qrcp", "panel_hessenberg"]
    _build.build_all()

    def marks(lib: str, rows: int) -> np.ndarray:
        buf = (ctypes.c_ulonglong * (1 << 16))()
        fn = _build.library(lib).repro_marks_read
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        if fn(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("panel_marks: reading the marks failed")
        a = np.frombuffer(buf, dtype=np.uint64).reshape(-1, 16)
        return a[:rows, : len(names[lib]) + 1].astype(np.int64)

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

    dev = torch.device("cuda")
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = [("panel_qrcp", f"qrcp {r} x {c}", (r, c),
                  lambda x: pq.qrcp_panel(x, 128))
                 for r, c in ((16384, 128), (16384, 4096))]
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
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
