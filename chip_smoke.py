#!/usr/bin/env python3
"""Smoke run of the port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; one GPU

1. device: the card, its power limit, the torch/CUDA versions; TF32 off.
2. build:  the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, and what ``-Xptxas -v`` says of each (registers, smem, spills).
3. kernels: every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes (n = 8192, b = 128, in
   float64 and float32), with its time, the plain version's, one library
   call's and the bound (bytes or operations) for the same work.
4. main path: ``gesv`` (LU with partial pivoting, then the solves) through
   the port's entry points, under ``mtb``/``la``/``la2`` at n = 8192 and
   ``rtm`` at n = 2048, plus n = 128 with block 128 (the fused small
   solve): scaled residuals, look-ahead factors bitwise equal to ``mtb``'s,
   launch counts, wall times, the cuSOLVER baseline and the tracer's
   PF/TU/PU/SWAP shares.

Each phase prints one JSON line and raises on failure (non-zero exit).
Then come the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero before printing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, BLOCK, NRHS = 8192, 128, 16   # the main path
RTM_N = 2048                     # rtm's per-tile launches grow as (n/b)^3
SMALL_N = 128                    # one panel: the fused small solve
SEED = 0
#: Peaks of one H100 SXM: 67 TFLOP/s for float32 outside the tensor cores
#: and for float64 through them (NVIDIA data sheet); 3.35 TB/s of HBM3.
PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
RESIDUAL_LIMIT = 100.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.backend import no_tf32
    from repro_torch.kernels import _build, blis_gemm, ops, panel_lu, trsm
    from repro_torch.obs import tracer
    from repro_torch.solve import gesv, lu_factor

    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps: int) -> float:
        """Median of ``reps`` CUDA-event timings after one warm-up call."""
        fn()
        sync()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    def tolerance(dtype, k) -> float:
        """Kernel vs plain version: both sum ``k`` terms per element in the
        same order and differ by FMA rounding only (measured: under 16 eps
        relative).  A kernel that dropped one 8-wide slice of K or one row
        of a triangle would be off by a few per cent."""
        return 4.0 * k * torch.finfo(dtype).eps

    def compare(x, ref):
        d = (x.double() - ref.double())
        return (float(d.norm() / max(float(ref.double().norm()), 1e-300)),
                float(d.abs().max()))

    def bound(flops: float, nbytes: float):
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    # ---- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    no_tf32()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: _build.ptxas_summary(log)
                    for name, log in logs.items()}})

    # ---- 3. kernels against their plain versions ---------------------------
    m = N - BLOCK
    rows = {}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        size = torch.finfo(dtype).bits // 8
        res = {}

        # GEMM-accumulate: the first trailing update, 8064x128 . 128x8064
        c, a, b = randn(m, m), randn(m, BLOCK), randn(BLOCK, m)
        out, lib_out = torch.empty_like(c), torch.empty_like(c)
        got = blis_gemm.gemm_accum(c, a, b, out=out)
        sync()
        err, mx = compare(got, blis_gemm.gemm_accum_plain(c, a, b))
        res["gemm_accum"] = dict(
            shape=[m, BLOCK, m], rel_err=err, max_abs_err=mx,
            tol=tolerance(dtype, BLOCK),
            ms=time_ms(lambda: blis_gemm.gemm_accum(c, a, b, out=out), 10),
            plain_ms=time_ms(lambda: blis_gemm.gemm_accum_plain(c, a, b), 3),
            library_ms=time_ms(
                lambda: torch.addmm(c, a, b, alpha=-1, out=lib_out), 10),
            bound=bound(2.0 * m * m * BLOCK,
                        (2 * m * BLOCK + 2 * m * m) * size))
        # the same kernel with beta = 0: plain GEMM (not on the LU path)
        got = blis_gemm.gemm(a, b, out=out)
        sync()
        err, mx = compare(got, blis_gemm.gemm_accum_plain(
            None, a, b, alpha=1.0, beta=0.0))
        res["gemm"] = dict(
            shape=[m, BLOCK, m], rel_err=err, max_abs_err=mx,
            tol=tolerance(dtype, BLOCK),
            ms=time_ms(lambda: blis_gemm.gemm(a, b, out=out), 10),
            plain_ms=time_ms(lambda: blis_gemm.gemm_accum_plain(
                None, a, b, alpha=1.0, beta=0.0), 3),
            library_ms=time_ms(lambda: torch.matmul(a, b, out=lib_out), 10),
            bound=bound(2.0 * m * m * BLOCK,
                        (2 * m * BLOCK + m * m) * size))
        del c, a, b, out, lib_out, got

        # TRSM: lower unit (U12 = L11^-1 A12) and upper non-unit, 128 x 8064
        lu_t = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
        rhs = randn(BLOCK, m)
        xout = torch.empty_like(rhs)
        tri = BLOCK * (BLOCK + 1) // 2
        for lower, unit in ((True, True), (False, False)):
            got = trsm.trsm(lu_t, rhs, lower=lower, unit_diagonal=unit,
                            out=xout)
            sync()
            err, mx = compare(got, trsm.trsm_plain(
                lu_t, rhs, lower=lower, unit_diagonal=unit))
            flops = m * BLOCK * (BLOCK - 1) + (0 if unit else m * BLOCK)
            res["trsm" if lower else "trsm_upper"] = dict(
                shape=[BLOCK, m], lower=lower, unit=unit, rel_err=err,
                max_abs_err=mx, tol=tolerance(dtype, BLOCK),
                ms=time_ms(lambda: trsm.trsm(
                    lu_t, rhs, lower=lower, unit_diagonal=unit, out=xout), 10),
                plain_ms=time_ms(lambda: trsm.trsm_plain(
                    lu_t, rhs, lower=lower, unit_diagonal=unit), 3),
                library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                    lu_t, rhs, upper=not lower, unitriangular=unit), 10),
                bound=bound(flops, (tri + 2 * BLOCK * m) * size))

        # GETF2 panel, 8192 x 128, in place (timed on a fresh copy; the
        # copy's own time is subtracted).  Bitwise equal to its plain
        # version by design: one rounding per product and per difference.
        panel0 = randn(N, BLOCK)
        pk, pp = panel0.clone(), panel0.clone()
        piv_k = panel_lu.lu_panel(pk)
        piv_p = panel_lu.lu_panel_plain(pp)
        sync()
        check(torch.equal(piv_k, piv_p), f"lu_panel {dtype}: pivots differ")
        check(torch.equal(pk, pp), f"lu_panel {dtype}: factors not bitwise "
              "equal to the plain version's")
        err, mx = compare(pk, pp)
        work = torch.empty_like(panel0)
        copy_ms = time_ms(lambda: work.copy_(panel0), 10)
        flops = sum((N - j - 1) * (1 + 2 * (BLOCK - j - 1))
                    for j in range(BLOCK))
        res["lu_panel"] = dict(
            shape=[N, BLOCK], pivots_equal=True, bitwise_equal=True,
            rel_err=err, max_abs_err=mx, tol=0.0,
            ms=time_ms(lambda: panel_lu.lu_panel(work.copy_(panel0)), 10)
            - copy_ms,
            plain_ms=time_ms(
                lambda: panel_lu.lu_panel_plain(work.copy_(panel0)), 3)
            - copy_ms,
            library_ms=time_ms(lambda: torch.linalg.lu_factor(panel0), 10),
            bound=bound(flops, 2 * N * BLOCK * size + 4 * BLOCK))
        del panel0, pk, pp, work

        # fused small solve: packed 128 x 128 LU, 16 right-hand sides
        lu_s = torch.linalg.lu_factor(randn(SMALL_N, SMALL_N)).LU.contiguous()
        rhs_s = randn(SMALL_N, NRHS)
        ident = torch.arange(1, SMALL_N + 1, dtype=torch.int32, device=dev)
        sout = torch.empty_like(rhs_s)
        got = trsm.lu_solve_small(lu_s, rhs_s, out=sout)
        sync()
        err, mx = compare(got, trsm.lu_solve_small_plain(lu_s, rhs_s))
        res["lu_solve_small"] = dict(
            shape=[SMALL_N, NRHS], rel_err=err, max_abs_err=mx,
            tol=tolerance(dtype, 2 * SMALL_N),   # two sweeps
            ms=time_ms(lambda: trsm.lu_solve_small(lu_s, rhs_s, out=sout), 20),
            plain_ms=time_ms(lambda: trsm.lu_solve_small_plain(lu_s, rhs_s), 3),
            library_ms=time_ms(
                lambda: torch.linalg.lu_solve(lu_s, ident, rhs_s), 20),
            bound=bound(2.0 * SMALL_N * SMALL_N * NRHS,
                        (SMALL_N * SMALL_N + 2 * SMALL_N * NRHS) * size))

        for name, r in res.items():
            check(r["rel_err"] <= r["tol"],
                  f"{name} {dtype}: kernel vs plain rel err {r['rel_err']} "
                  f">= {r['tol']}")
        rows[str(dtype).replace("torch.", "")] = res
        emit({"phase": "kernels", "dtype": str(dtype), "results": res})

    # ---- 4. the main path through the entry points -------------------------
    def scaled_residual(a, x, b, dtype):
        a, x, b = a.double(), x.double(), b.double()
        num = float((a @ x - b).norm())
        return num / (a.shape[0] * torch.finfo(dtype).eps
                      * float(a.norm()) * float(x.norm()))

    npanels = -(-N // BLOCK)
    flops = 2.0 * N ** 3 / 3.0
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        a = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        b = torch.randn(N, NRHS, generator=gen, device=dev, dtype=dtype)
        base = None
        for variant in ("mtb", "la", "la2"):
            before = panel_lu.lu_panel.launches
            sync()
            t0 = time.perf_counter()
            fac = lu_factor(a, BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            sync()
            t2 = time.perf_counter()
            panels = panel_lu.lu_panel.launches - before
            check(panels == npanels,
                  f"{variant}: {panels} panel launches, expected {npanels}")
            res = scaled_residual(a, x, b, dtype)
            check(res < RESIDUAL_LIMIT, f"gesv {variant} {dtype}: residual {res}")
            if base is None:
                base = fac
            else:
                check(torch.equal(fac.lu, base.lu)
                      and torch.equal(fac.ipiv, base.ipiv),
                      f"{variant} {dtype}: factors differ from mtb's")
            emit({"phase": "gesv", "dtype": str(dtype), "n": N,
                  "block": BLOCK, "nrhs": NRHS, "variant": variant,
                  "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
                  "factor_gflops": flops / (t1 - t0) / 1e9,
                  "scaled_residual": res, "panel_launches": panels,
                  "bitwise_equal_to_mtb": True})
        del base, fac, x

        # the vendor-library baseline (cuSOLVER getrf + getrs), timed after
        # one warm-up call (the port's kernels were warmed in phase 3)
        no_tf32()
        torch.linalg.lu_solve(*torch.linalg.lu_factor(a), b)
        sync()
        t0 = time.perf_counter()
        lu_lib, piv_lib = torch.linalg.lu_factor(a)
        sync()
        t1 = time.perf_counter()
        x = torch.linalg.lu_solve(lu_lib, piv_lib, b)
        sync()
        t2 = time.perf_counter()
        emit({"phase": "gesv_library", "dtype": str(dtype), "n": N,
              "call": "torch.linalg.lu_factor + lu_solve",
              "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
              "factor_gflops": flops / (t1 - t0) / 1e9,
              "scaled_residual": scaled_residual(a, x, b, dtype)})
        del lu_lib, piv_lib, x

        # tracer shares of one la run
        with tracer.trace() as tr:
            lu_factor(a, BLOCK, variant="la")
        cats = ("PF", "TU", "PU", "SWAP")
        total = sum(tr.total(c) for c in cats)
        emit({"phase": "trace_la", "dtype": str(dtype), "n": N,
              "seconds": {c: tr.total(c) for c in cats},
              "shares": {c: tr.total(c) / total for c in cats}})

        # rtm at a smaller n, bitwise against mtb there
        a2, b2 = a[:RTM_N, :RTM_N], b[:RTM_N]
        f_mtb = lu_factor(a2, BLOCK, variant="mtb")
        t0 = time.perf_counter()
        f_rtm = lu_factor(a2, BLOCK, variant="rtm")
        sync()
        t1 = time.perf_counter()
        x = f_rtm.solve(b2)
        res = scaled_residual(a2, x, b2, dtype)
        check(res < RESIDUAL_LIMIT, f"gesv rtm {dtype}: residual {res}")
        check(torch.equal(f_rtm.lu, f_mtb.lu)
              and torch.equal(f_rtm.ipiv, f_mtb.ipiv),
              f"rtm {dtype}: factors differ from mtb's")
        emit({"phase": "gesv", "dtype": str(dtype), "n": RTM_N,
              "block": BLOCK, "variant": "rtm", "factor_ms": (t1 - t0) * 1e3,
              "scaled_residual": res, "bitwise_equal_to_mtb": True})

        # one panel: the solve takes the fused small-solve kernel
        before = trsm.lu_solve_small.launches
        a3, b3 = a[:SMALL_N, :SMALL_N], b[:SMALL_N]
        x = gesv(a3, b3, SMALL_N)
        res = scaled_residual(a3, x, b3, dtype)
        check(res < RESIDUAL_LIMIT, f"gesv n={SMALL_N} {dtype}: residual {res}")
        check(trsm.lu_solve_small.launches == before + 1,
              "gesv at one panel did not take the fused small solve")
        emit({"phase": "gesv", "dtype": str(dtype), "n": SMALL_N,
              "block": SMALL_N, "variant": "la", "scaled_residual": res,
              "small_solve": True})
        del a, b, a2, b2, a3, b3, f_mtb, f_rtm, x
    counts = ops.launches()
    for name, count in counts.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # ---- 5. report ---------------------------------------------------------
    sources = {"gemm_accum": "gemm.cu", "trsm": "trsm.cu",
               "lu_panel": "panel_lu.cu", "lu_solve_small": "trsm.cu"}
    replaces = {"gemm_accum": "src/repro/kernels/blis_gemm.py:126",
                "trsm": "src/repro/kernels/trsm.py:42",
                "lu_panel": "src/repro/kernels/panel_lu.py:34",
                "lu_solve_small": "src/repro/kernels/trsm.py:115"}
    def numbers(r):
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]}

    kernels = []
    for name in ops.KERNELS:   # float64 at the top level, float32 beside it
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": counts[name],
            **numbers(rows["float64"][name]), "dtype": "float64",
            "shape": rows["float64"][name]["shape"],
            "float32": numbers(rows["float32"][name])})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
