#!/usr/bin/env python3
"""Smoke run of the port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; one GPU

1. device: the card, its power limit, the torch/CUDA versions; TF32 off.
2. build:  the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, and what ``-Xptxas -v`` says of each (registers, smem, spills);
   the tensor-core instructions in the flash library's SASS
   (``cuobjdump -sass``), which each bfloat16 instantiation must have.
3. kernels: every kernel of the main paths against its plain PyTorch
   version on the card, at the main path's shapes (n = 8192, b = 128 for
   LU and Cholesky; the 16384 x 128 QR panel, and the first global QRCP
   block, 16384 x 4096 with 128 steps, and a 16384 x 128 window; the GEMM
   also at the gels paths' products, the 16384-deep V^T C and V^T B and
   the QRCP update; the Hessenberg panel at n = 8192, 128 columns from
   k = 0 and k = 4096, and from k = 0 at n = 2048; float64 and float32),
   with its time, the plain version's, one library call's (or, for the
   fused panel updates, which no one library call computes, the composed
   kernels' they replace) and the bound (bytes or operations) for the
   same work.  The GEMM prints the split it chose (chunks of K, their
   mapping onto blocks, the tile) and is held bitwise to its contract run
   one thread an element with one FMA a term (in float64 the check that its
   DMMA steps keep the DFMA chain), and the gels PU's V^T C (and the
   solve's V^T B) bitwise to the whole update's first columns.  The TRSM
   (lower unit and upper non-unit at 128 x 8064 and at the solves'
   128 x 16, the right mode at 8064 x 128) prints its plan (right-hand
   sides a block, strip rows, threads, shared memory) and is held bitwise
   to its contract run one thread a right-hand side (``trsm_chain``, the
   previous design, timed beside it); its times are the card's on a busy
   card, with one call from an idle card beside them.  The fused panel
   updates are held bitwise to the composed kernels, pivots included; the
   QR, QRCP and Hessenberg panels within 4·k·eps of their plain versions,
   k the longest chain of terms the kernel sums for one element, QRCP
   pivots equal.
4. main path: ``gesv`` (LU with partial pivoting, then the solves) through
   the port's entry points, under ``mtb``/``la``/``la2``/``la_mb`` at
   n = 8192 and ``rtm`` at n = 2048, plus n = 128 with block 128 (the fused
   small solve): scaled residuals, look-ahead factors bitwise equal to
   ``mtb``'s, launch counts, wall times, the cuSOLVER baseline and the
   tracer's PF/TU/PU/SWAP shares under ``la`` and ``la_mb``.
5. second path: ``posv`` (Cholesky, then the solves) on a symmetric
   positive-definite input, under ``mtb``/``la``/``la2``/``la_mb`` at
   n = 8192 and ``rtm`` at n = 2048: the same checks and times, against
   ``torch.linalg.cholesky`` + ``torch.cholesky_solve``, and the time of
   one PyTorch-op ``cholesky_unblocked`` of a 128 x 128 block.
6. ``gels`` (Householder QR, then the least-squares solve), m = 16384,
   n = 4096, 16 right-hand sides, under ``mtb``/``la``/``la2``/``la_mb``,
   ``rtm`` at 4096 x 1024 and a wide 1024 x 2048 factor: LAPACK's
   least-squares ratio, factors bitwise equal to ``mtb``'s, wall times
   against ``torch.geqrf`` and ``torch.linalg.lstsq`` (cuSOLVER), the
   traced PF/TU shares under ``la``.
7. ``gels(pivot=True)`` on the same shape: global QRCP (``mtb``, ``rtm``
   at 4096 x 1024) and windowed ``qrcp_local`` (``mtb``/``la``/``la2``):
   ``jpvt`` a permutation, ``|r_jj|`` non-increasing (within each window
   for ``local``), the least-squares ratio, ``local`` look-ahead bitwise
   equal to ``local`` ``mtb``, and on a rank-n/2 input the rank.
8. ``gehrd`` (Hessenberg reduction, ``HessenbergFactors``) at n = 8192
   under ``mtb`` and at n = 2048 under ``rtm``: H exactly zero below the
   first subdiagonal, ‖QᵀQ − I‖ and ‖A − Q·H·Qᵀ‖ scaled by n·eps, ``rtm``
   bitwise equal to ``mtb``, one panel launch per panel, wall times, the
   traced PF/TU shares; ``eigvals()`` of a symmetric n = 512 input against
   ``torch.linalg.eigvalsh``.
9. ``gecon`` and ``getri`` at n = 2048: the condition estimate against
   the exact 1/(‖A‖₁·‖A⁻¹‖₁), and the scaled residual of the inverse.
10. ``flash_attention`` against its plain version, bfloat16 and float32,
    at the serving shape (B 4, 40 query heads over 10 KV heads, S 1024,
    D 128, causal) and at one 32k sequence (prefill_32k's), on the
    positions prefill passes, each output
    within an elementwise bound of the plain version run in float64
    (``attention.attn_expect``), which must also fail two planted faults
    (``attention.attn_faults``: a 64-key tile left out, the second half of
    the rows not written); with its time on a busy card and of one call
    from an idle one (host work included), the plain version's, the bound
    and the times of ``scaled_dot_product_attention`` (a yardstick the port
    never calls) and SDPA's error over the same bound (recorded: SDPA
    rounds P to bfloat16 once); the bfloat16 kernel's tiling, route,
    shared memory, registers, spills and SASS tensor-core instructions.
11. serving: phi3-medium-14b at full width and depth (40 layers, bfloat16,
    seeded random weights made on the card) through
    ``ServeEngine.generate``: batch 4, prompt 1024, 64 new tokens, greedy;
    prefill ms, decode ms a step (p50/p99), tokens/s, peak memory, and
    40 flash-attention launches in the prefill, none in decode.
12. teacher-forced consistency through ``api.prefill``/``decode_step``:
    prefill 1024 tokens of a 2048-token sequence, decode 32 more, and hold
    the logits to one full ``api.apply`` over all 2048 (the flash kernel
    against the plain decode attention), float32 at full width and 4
    layers, bfloat16 at 40 layers, each within ``CONS_TOL``.
13. ``wkv6_fused`` against its plain version, bfloat16 and float32, at the
    serving shape (B 4, H 64, S 1024, 64, chunk 128), at one 32k sequence
    and at S 1000 (a short last chunk) from a nonzero state, on decays drawn
    like the served model's (the share of chunks where the clip engages is
    reported): each output and final state within an elementwise bound of
    the plain version run in float64 (``wkv6_expect``: the cumsum's
    rounding reaches the exponents), which three planted faults must
    exceed (the state dropped at a chunk boundary, the diagonal in the score
    mask, the last chunk not written); a run split at a chunk boundary
    equals the unsplit one bitwise; with its time, the plain version's and
    the bound (no PyTorch call computes WKV6).
14. serving: rwkv6-7b at full width and depth (32 layers, bfloat16) the
    same way as phi3: 32 ``wkv6_fused`` launches in the prefill, none in
    decode (``wkv6_step`` is plain tensor ops, as in the reference).
15. rwkv6-7b teacher-forced decode against the full forward, bfloat16 at
    32 layers and float32 at 4, gated at a chunk of 16 where the clip
    cannot engage (checked on the run), within ``CONS_TOL_RWKV``; in
    bfloat16 each route's deviation from the same weights' float32 full
    forward, the two within ``ROUNDING_RATIO`` of each other (the witness
    that the bfloat16 deviation is rounding); at the config's chunk 128
    each layer's kernel output within its bound of the plain version on
    the same inputs (gated), and token-by-token decode
    from position 0 against the full forward over 256 tokens (float32, 4
    layers; recorded, not gated: the reference's clip).

Launch counts are set to 0 just before each path and read just after it;
each kernel of a path must have launched in it (``flash_attention`` and
``wkv6_fused`` on their serving paths, the others on the factorization
paths).

Each phase prints one JSON line and raises on failure (non-zero exit).
Then come the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero before printing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, BLOCK, NRHS = 8192, 128, 16   # the main path (and gehrd's n)
QR_M, QR_N = 16384, 4096         # the gels paths: a tall 4:1 system
QR_RTM = (4096, 1024)            # rtm's launches grow as panels x tiles
QR_WIDE = (1024, 2048)           # wide QR: the row-exhaustion stop
RTM_N = 2048                     # rtm's per-tile launches grow as (n/b)^3
SMALL_N = 128                    # one panel: the fused small solve
EIG_N = 512                      # gehrd + eigvals of a symmetric input
COND_N = 2048                    # gecon and getri
SEED = 0
ARCH = "phi3-medium-14b"         # the serving path: full width and depth
SERVE_BATCH, PROMPT, NEW_TOKENS = 4, 1024, 64
LONG_S = 32768                   # prefill_32k's per-sequence shape
CONS_S, CONS_DECODE = 2048, 32   # teacher-forced decode vs the full forward
CONS_F32_LAYERS = 4              # the float32 check's depth (full width)
#: Relative Frobenius deviation of the teacher-forced decode logits from
#: the full forward's.  float32: the two routes (flash kernel + M = 2048
#: GEMMs, plain decode attention + M = 1 GEMMs) differ by summation order
#: only, about sqrt(K)·eps = 1.6e-5 for the deepest sum (K = d_ff = 17920)
#: per product, so 1e-4 leaves room for 4 layers while a wrong mask,
#: position or cache slot moves the logits by O(1).  bfloat16: each of the
#: 40 layers rounds some 8 activations to bfloat16 (2^-9 relative) at
#: places the two routes do not share; as a random walk that is
#: sqrt(320)·2^-9 = 3.5e-2 of the logits' scale, and the bound allows 3x.
CONS_TOL = {"float32": 1e-4, "bfloat16": 0.1}
RWKV_ARCH = "rwkv6-7b"           # the second serving path, full width and depth
WKV_RAGGED = 1000                # a sequence that ends in a short chunk
#: The chunk at which rwkv6-7b's teacher-forced decode is gated: the
#: cumulative log-decay inside one chunk stays above the clip's -80 there
#: (16·max|log w| ≈ 70; the phase checks it on its own run), so the chunked
#: form is the exact recurrence up to rounding.  At the config's 128 the
#: clip engages and the two differ by the reference's own design.
CONS_RWKV_CHUNK = 16
#: Relative Frobenius deviation, rwkv6-7b, at CONS_RWKV_CHUNK.  float32 as
#: phi3's (the deepest sum is d_ff = 14336).  bfloat16: each of the 32
#: layers rounds 38 activations to bfloat16 (layer norm 2, the five
#: time-mix and two channel-mix token shifts at 3 roundings each, the r, k,
#: v, g, wo, ck, cr and cv products 8, silu, y·g, square, sigmoid, the
#: gate product and the 2 residual adds) at places the two routes (M = 2048
#: GEMMs, M = 1 GEMVs) round differently; as a random walk
#: sqrt(32·38)·2^-9 = 6.8e-2 of the logits' scale, and the bound allows 3x.
CONS_TOL_RWKV = {"float32": 1e-4, "bfloat16": 0.2}
#: The witness that rwkv6-7b's bfloat16 deviation is rounding: the same
#: weights' full forward in float32 is the rounding-free answer, and each
#: bfloat16 route (full forward; prefill + decode) lies some distance from
#: it.  Both routes round at the same operations, so rounding puts them
#: about equally far; a fault that only one bfloat16 route has puts that
#: one further.  The larger distance may be at most twice the smaller.
ROUNDING_RATIO = 2.0
STEPWISE_S = 256                 # token-by-token decode over two chunks of 128
#: kernels checked on the serving paths, not on the factorization paths
SERVING_KERNELS = ("flash_attention", "wkv6_fused")
#: Peaks of one H100 SXM: 67 TFLOP/s for float32 outside the tensor cores
#: and for float64 through them (NVIDIA data sheet); 3.35 TB/s of HBM3.
PEAK_FLOPS = 67e12
#: bfloat16 dense through the tensor cores (NVIDIA data sheet)
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6                  # the H100's L2 cache (NVIDIA data sheet)
RESIDUAL_LIMIT = 100.0


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def flash_kernel_name(mangled: str) -> str:
    """``flash_wgmma_kernel<128>`` or ``flash_fwd_kernel<128>`` for the
    mangled name of that instantiation in the flash library."""
    m = re.search(r"(flash_wgmma_kernel|flash_fwd_kernel)If?Li(\d+)E",
                  mangled)
    return mangled if m is None else f"{m.group(1)}<{m.group(2)}>"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.backend import no_tf32
    from repro_torch.core.cholesky import cholesky_panel, cholesky_unblocked
    from repro_torch.core import qr
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, attention, blis_gemm, ops,
                                     panel_hessenberg, panel_lu, panel_qr,
                                     panel_qrcp, trsm)
    from repro_torch.kernels import fused_panel_update as fpu
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.models import api, rwkv6
    from repro_torch.obs import tracer
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.solve import (cholesky_factor, gecon, gehrd, geqp3,
                                   gesv, getri, lu_factor, qr_factor)

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

    def queued_ms(fn, reps: int) -> float:
        """Median CUDA-event ms of one call of ``fn`` on a busy card: a
        ``torch.cuda._sleep`` (about 2.5 ms) queued ahead of the first event
        keeps the card busy while the host checks the arguments and
        launches, so the events time the card's work for the call alone,
        not the host's launch work that :func:`time_ms` also counts."""
        fn()
        sync()
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

    def tolerance(dtype, k) -> float:
        """Kernel vs plain version, relative: 4·k·eps for ``k`` terms summed
        in turn per element.  The GEMM, TRSM and fused kernels sum them in
        the plain version's order and differ by FMA rounding only
        (measured: under 16 eps); the QR panels regroup (see there).  A
        kernel that dropped one 8-wide slice of K or one row of a triangle
        would be off by a few per cent; one that summed in half precision
        by about 2**-11 relative, or more."""
        return 4.0 * k * torch.finfo(dtype).eps

    def compare(x, ref):
        d = (x.double() - ref.double())
        return (float(d.norm() / max(float(ref.double().norm()), 1e-300)),
                float(d.abs().max()))

    def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def streamed(passes: float, block: float) -> float:
        """The elements a panel that passes over a block once a step must
        fetch from HBM: every pass where the block exceeds the L2 cache,
        one read where it fits.  No L2 rate is published, so the passes
        over L2 are not charged and such a bound is a floor."""
        return passes if block * size > L2_BYTES else block

    def attn_err(got, want, tol):
        """(max abs error, max of error / tolerance) of ``got``."""
        err = (got.double() - want).abs_()
        return float(err.max()), float((err / tol).max())

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
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul
              .allow_bf16_reduced_precision_reduction})

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_summary(log) for name, log in logs.items()}
    # the flash library's tensor-core instructions, by instantiation: the
    # bfloat16 kernel must run on them
    flash_mma = {flash_kernel_name(fn): n for fn, n in
                 _build.sass_mma_counts("flash_attention").items()}
    bf16_mma = {fn: n for fn, n in flash_mma.items() if "wgmma" in fn}
    check(len(bf16_mma) == 3 and min(bf16_mma.values()) > 0,
          f"flash_attention: the bfloat16 kernels lack tensor-core "
          f"instructions in their SASS: {flash_mma}")
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "flash_attention_sass_mma": flash_mma})

    # ---- 3. kernels against their plain versions ---------------------------
    m = N - BLOCK
    rows = {}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

        size = torch.finfo(dtype).bits // 8
        res = {}

        def gemm_row(c, a, b):
            """The GEMM kernel, ``C − A·B`` (``A·B`` where ``c`` is None),
            against its plain version, one cuBLAS call and the bound; the
            split it chose (chunks of K, their mapping onto blocks, the
            tile); bitwise equal to its contract run one thread an element
            with one FMA a term (``gemm_chain``: in float64 the check that
            the DMMA steps keep the DFMA chain)."""
            mm, k = a.shape
            nn = b.shape[1]
            out = torch.empty(mm, nn, dtype=dtype, device=dev)
            lib_out = torch.empty_like(out)
            if c is None:
                def run():
                    return blis_gemm.gemm(a, b, out=out)

                def plain():
                    return blis_gemm.gemm_accum_plain(None, a, b, alpha=1.0,
                                                      beta=0.0)

                def lib():
                    return torch.matmul(a, b, out=lib_out)
            else:
                def run():
                    return blis_gemm.gemm_accum(c, a, b, out=out)

                def plain():
                    return blis_gemm.gemm_accum_plain(c, a, b)

                def lib():
                    return torch.addmm(c, a, b, alpha=-1, out=lib_out)
            got = run()
            chain = blis_gemm.gemm_chain(c, a, b, alpha=1.0 if c is None
                                         else -1.0,
                                         beta=0.0 if c is None else 1.0)
            sync()
            check(torch.equal(got, chain), f"gemm {dtype} {mm}x{k}x{nn}: "
                  "not bitwise equal to its FMA-chain contract")
            del chain
            split = blis_gemm.plan(mm, nn, k, dtype)
            check(split["kc"] == blis_gemm.KC, f"gemm: the kernel's KC "
                  f"{split['kc']} is not the plain version's {blis_gemm.KC}")
            err, mx = compare(got, plain())
            return dict(
                shape=[mm, k, nn], split=split,
                bitwise_equal_to_chain=True, rel_err=err, max_abs_err=mx,
                tol=tolerance(dtype, k), ms=time_ms(run, 10),
                plain_ms=time_ms(plain, 3 if k <= BLOCK else 1),
                library_ms=time_ms(lib, 10),
                bound=bound(2.0 * mm * nn * k,
                            (mm * k + k * nn
                             + (1 if c is None else 2) * mm * nn) * size))

        # GEMM-accumulate: the first trailing update, 8064x128 . 128x8064;
        # the same kernel with beta = 0 (plain GEMM) at the same shape
        c, a, b = randn(m, m), randn(m, BLOCK), randn(BLOCK, m)
        res["gemm_accum"] = gemm_row(c, a, b)
        res["gemm"] = gemm_row(None, a, b)
        del c, a, b
        # the gels paths' first panel (trailing nc = QR_N - BLOCK columns):
        # the update's beta = 0 V^T C, under la also on the next panel's
        # BLOCK columns (most of PU), and the solve's V^T B (16 columns),
        # each summing K = QR_M terms an element; and global QRCP's update
        # A2 -= V2 F^T (K = BLOCK; QR's C -= V W has the same K and 128
        # rows more)
        # The PU's product is the whole update's first BLOCK columns (and the
        # solve's V^T B its first NRHS): bitwise equal, whatever the split's
        # tile and mapping for each.
        nc = QR_N - BLOCK
        vt, c_all = randn(BLOCK, QR_M), randn(QR_M, nc)
        res["gemm_gels_vtc"] = gemm_row(None, vt, c_all)
        res["gemm_gels_vtc_pu"] = gemm_row(None, vt, c_all[:, :BLOCK])
        res["gemm_gels_vtb"] = gemm_row(None, vt, c_all[:, :NRHS])
        whole = blis_gemm.gemm(vt, c_all)
        for key, cols in (("gemm_gels_vtc_pu", BLOCK),
                          ("gemm_gels_vtb", NRHS)):
            got = blis_gemm.gemm(vt, c_all[:, :cols])
            sync()
            check(torch.equal(whole[:, :cols], got), f"gemm {dtype}: V^T C "
                  f"on {cols} columns not bitwise the whole update's")
            res[key]["bitwise_equal_to_whole"] = True
        del vt, c_all, whole, got
        res["gemm_accum_qrcp"] = gemm_row(randn(QR_M - BLOCK, nc),
                                          randn(QR_M - BLOCK, BLOCK),
                                          randn(BLOCK, nc))

        # TRSM: lower unit (U12 = L11^-1 A12) and upper non-unit at 128 x
        # 8064 and at the solves' diagonal blocks, 128 x NRHS; the right
        # transposed mode (the Cholesky L21 solve) at 8064 x 128 below.  Each
        # bitwise equal to its contract run one thread a right-hand side
        # (trsm_chain: the previous design, timed beside it); ms on a busy
        # card (queued_ms), call_ms from an idle card, host work included.
        tri = BLOCK * (BLOCK + 1) // 2

        def trsm_row(t, rhs, lower, unit, right=False):
            out = torch.empty_like(rhs)
            nrhs = rhs.shape[0 if right else 1]
            if right:
                def run():
                    return trsm.trsm_right_lower_t(t, rhs, unit_diagonal=unit,
                                                   out=out)

                def plain():
                    return trsm.trsm_right_lower_t_plain(t, rhs,
                                                         unit_diagonal=unit)

                def lib():
                    return torch.linalg.solve_triangular(
                        t.mT, rhs, upper=True, left=False, unitriangular=unit)
            else:
                def run():
                    return trsm.trsm(t, rhs, lower=lower, unit_diagonal=unit,
                                     out=out)

                def plain():
                    return trsm.trsm_plain(t, rhs, lower=lower,
                                           unit_diagonal=unit)

                def lib():
                    return torch.linalg.solve_triangular(
                        t, rhs, upper=not lower, unitriangular=unit)

            def chain():
                return trsm.trsm_chain(t, rhs, lower=lower,
                                       unit_diagonal=unit, right=right)
            got = run()
            sync()
            check(torch.equal(got, chain()), f"trsm {dtype} "
                  f"{tuple(rhs.shape)} lower={lower} unit={unit} "
                  f"right={right}: not bitwise equal to its chain contract")
            err, mx = compare(got, plain())
            flops = nrhs * BLOCK * (BLOCK - 1) + (0 if unit else nrhs * BLOCK)
            return dict(
                shape=list(rhs.shape), lower=lower, unit=unit, right=right,
                plan=trsm.plan(BLOCK, nrhs, dtype, right=right),
                bitwise_equal_to_chain=True, rel_err=err, max_abs_err=mx,
                tol=tolerance(dtype, BLOCK), ms=queued_ms(run, 20),
                call_ms=time_ms(run, 20), chain_ms=queued_ms(chain, 5),
                plain_ms=time_ms(plain, 3), library_ms=queued_ms(lib, 20),
                library_call_ms=time_ms(lib, 20),
                bound=bound(flops, (tri + 2 * BLOCK * nrhs) * size))

        lu_t = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
        for key, cols in (("trsm", m), ("trsm_solve", NRHS)):
            rhs = randn(BLOCK, cols)
            res[key] = trsm_row(lu_t, rhs, True, True)
            res[f"{key}_upper"] = trsm_row(lu_t, rhs, False, False)
        del rhs

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
        lu_lib_ms = time_ms(lambda: torch.linalg.lu_factor(panel0), 10)
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
            library_ms=lu_lib_ms,
            bound=bound(flops, 2 * N * BLOCK * size + 4 * BLOCK))
        del panel0, pk, pp, work

        def spd(n):
            g = randn(n, n)
            return g @ g.mT / n + torch.eye(n, dtype=dtype, device=dev)

        # right transposed TRSM: X L^T = B, the Cholesky L21 solve, 8064 x 128
        l_c = torch.linalg.cholesky(spd(BLOCK)).contiguous()
        res["trsm_right_lower_t"] = trsm_row(l_c, randn(m, BLOCK), True,
                                             False, right=True)

        def fused_row(name, fused, plain, composed, ops_in, outs, flops,
                      nbytes, tol_k):
            """A fused panel update on fresh copies of its in-place operands
            ``outs`` (indices into ``ops_in``): bitwise against the composed
            kernels it replaces (pivots too), within 4·k·eps of its plain
            version (which rounds each product where the kernels use FMA),
            timed with the copies' own time subtracted."""
            def fresh():
                args = list(ops_in)
                for i in outs:
                    args[i] = work[i].copy_(ops_in[i])
                return args

            work = {i: ops_in[i].clone() for i in outs}
            got = [t.clone() for t in _as_tuple(fused(*fresh()))]
            want = [t.clone() for t in _as_tuple(composed(*fresh()))]
            ref = [t.clone() for t in _as_tuple(plain(*fresh()))]
            sync()
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"{name} {dtype}: not bitwise equal to the composed kernels")
            err, mx = compare(got[-1] if len(got) == 1 else got[1],
                              ref[-1] if len(ref) == 1 else ref[1])
            if len(got) == 3:
                check(torch.equal(got[2], ref[2]),
                      f"{name} {dtype}: pivots differ from the plain version's")
            copy_ms = time_ms(fresh, 10)
            res[name] = dict(
                shape=[m, BLOCK, BLOCK], bitwise_equal_to_composed=True,
                pivots_equal=len(got) == 3 or None, rel_err=err,
                max_abs_err=mx, tol=tolerance(dtype, tol_k),
                ms=time_ms(lambda: fused(*fresh()), 10) - copy_ms,
                plain_ms=time_ms(lambda: plain(*fresh()), 3) - copy_ms,
                composed_ms=time_ms(lambda: composed(*fresh()), 10) - copy_ms,
                library_ms=None, bound=bound(flops, nbytes))

        # fused LU panel update at the first PU: L11 128 x 128, L21 8064 x 128
        l11 = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
        lu_in = (l11, randn(m, BLOCK), randn(BLOCK, BLOCK), randn(m, BLOCK))

        def composed_lu(l11, l21, a1l, a2l):
            ops.trsm(l11, a1l, lower=True, unit_diagonal=True, out=a1l)
            ops.update(a2l, l21, a1l)
            return a1l, a2l, ops.lu_panel(a2l)

        getf2 = sum((m - j - 1) * (1 + 2 * (BLOCK - j - 1))
                    for j in range(BLOCK))
        fused_row("fused_lu_panel_update", fpu.fused_lu_panel_update,
                  fpu.fused_lu_panel_update_plain, composed_lu, lu_in, (2, 3),
                  BLOCK * (BLOCK - 1) * BLOCK + 2.0 * m * BLOCK * BLOCK
                  + getf2,
                  (tri + m * BLOCK + 2 * BLOCK * BLOCK + 2 * m * BLOCK) * size
                  + 4 * BLOCK, 2 * BLOCK)
        del lu_in

        # fused Cholesky panel update at the first PU: lrow = L21[:128]
        l21 = 0.1 * randn(m, BLOCK)
        panel_c = 0.1 * randn(m, BLOCK)
        panel_c[:BLOCK] = l21[:BLOCK] @ l21[:BLOCK].mT + spd(BLOCK)

        def composed_chol(lrow, l21, panel):
            ops.update(panel, l21, lrow.mT.contiguous())
            return cholesky_panel(panel, BLOCK, "cuda")

        fused_row("fused_cholesky_panel_update",
                  fpu.fused_cholesky_panel_update,
                  fpu.fused_cholesky_panel_update_plain, composed_chol,
                  (l21[:BLOCK], l21, panel_c), (2,),
                  2.0 * m * BLOCK * BLOCK + BLOCK ** 3 / 3.0
                  + float(m - BLOCK) * BLOCK * BLOCK,
                  (BLOCK * BLOCK + 2 * m * BLOCK + m * BLOCK) * size,
                  2 * BLOCK)
        del l21, panel_c

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

        # QR panel (GEQR2 + LARFT) at the gels path's first panel,
        # 16384 x 128, in place; its LARFT entry on the same V.  The
        # reductions group differently from the plain version's, so the
        # bound is relative, 4·k·eps on packed, tau and T, with k the
        # longest chain of terms the kernel sums in turn for one element:
        # a block's rows of the cooperative grid (G blocks), then the G
        # block partials, then up to BLOCK terms of the T recurrence.
        sfx = _build.SUFFIX[dtype]

        def chain(grid):
            return -(-QR_M // grid) + grid + BLOCK

        g_qr = panel_qr._grid(f"repro_qr_panel_grid_{sfx}", QR_M, BLOCK)
        g_larft = panel_qr._grid(f"repro_larft_grid_{sfx}", QR_M, BLOCK)
        qpanel0 = randn(QR_M, BLOCK)
        qk, qp = qpanel0.clone(), qpanel0.clone()
        _, tau_k, t_k = panel_qr.qr_panel(qk)
        _, tau_p, t_p = panel_qr.qr_panel_plain(qp)
        sync()
        errs = {what: compare(x, y)[0] for what, x, y in (
            ("packed", qk, qp), ("tau", tau_k, tau_p), ("T", t_k, t_p))}
        work = torch.empty_like(qpanel0)
        copy_ms = time_ms(lambda: work.copy_(qpanel0), 10)
        geqr2 = sum(4.0 * (QR_M - j) * (BLOCK - j) for j in range(BLOCK))
        gram = float(QR_M) * BLOCK * (BLOCK - 1) + BLOCK ** 3 / 3.0
        res["qr_panel"] = dict(
            shape=[QR_M, BLOCK], rel_err=max(errs.values()), rel_errs=errs,
            max_abs_err=compare(qk, qp)[1], grid=g_qr,
            tol=tolerance(dtype, chain(g_qr)),
            ms=time_ms(lambda: panel_qr.qr_panel(work.copy_(qpanel0)), 10)
            - copy_ms,
            plain_ms=time_ms(
                lambda: panel_qr.qr_panel_plain(work.copy_(qpanel0)), 2)
            - copy_ms,
            library_ms=time_ms(lambda: torch.geqrf(qpanel0), 10),
            bound=bound(geqr2 + gram, (2 * QR_M * BLOCK + BLOCK * BLOCK
                                       + BLOCK) * size))
        v_q = qr.unpack_v(qk, BLOCK)
        t_l = panel_qr.larft(v_q, tau_k)
        sync()
        err, mx = compare(t_l, panel_qr.larft_plain(v_q, tau_k))
        res["larft"] = dict(
            shape=[QR_M, BLOCK], rel_err=err, max_abs_err=mx, grid=g_larft,
            tol=tolerance(dtype, chain(g_larft)),
            ms=time_ms(lambda: panel_qr.larft(v_q, tau_k), 10),
            plain_ms=time_ms(lambda: panel_qr.larft_plain(v_q, tau_k), 2),
            library_ms=None,
            bound=bound(gram, (QR_M * BLOCK + BLOCK + BLOCK * BLOCK) * size))
        del qpanel0, qk, qp, work, v_q

        # xLAQPS: the global path's first block (16384 x 4096, 128 steps)
        # and a qrcp_local window (16384 x 128); pivots equal to the plain
        # version's, arrays within 4·k·eps, k as for the QR panel (up to
        # BLOCK terms of the F recurrence).  The bound counts the per-step
        # pass over the block where it exceeds L2 (one read of the
        # L2-resident window).  No PyTorch call computes it.
        g_qrcp = panel_qrcp._grid(sfx, QR_M, BLOCK)
        qrcp_rows = {}
        for cols in (QR_N, BLOCK):
            blk0 = randn(QR_M, cols)
            bk_, bp_ = blk0.clone(), blk0.clone()
            got = panel_qrcp.qrcp_panel(bk_, BLOCK)
            want = panel_qrcp.qrcp_panel_plain(bp_, BLOCK)
            sync()
            check(torch.equal(got[4], want[4]),
                  f"qrcp_panel {dtype} {QR_M}x{cols}: pivots differ from the "
                  "plain version's")
            errs = {what: compare(x, y)[0] for what, x, y in zip(
                ("block", "v", "f", "tau"), got[:4], want[:4])}
            work = torch.empty_like(blk0)
            copy_ms = time_ms(lambda: work.copy_(blk0), 5)
            passes = sum(float(QR_M - j) * cols for j in range(BLOCK))
            flops = 2.0 * QR_M * cols + sum(
                2.0 * (QR_M - j) * (cols + 2 * j) + 4.0 * cols * j
                for j in range(BLOCK))
            qrcp_rows[cols] = dict(
                shape=[QR_M, cols, BLOCK], pivots_equal=True,
                rel_err=max(errs.values()), rel_errs=errs,
                max_abs_err=compare(got[0], want[0])[1], grid=g_qrcp,
                tol=tolerance(dtype, chain(g_qrcp)),
                ms=time_ms(lambda: panel_qrcp.qrcp_panel(work.copy_(blk0),
                                                         BLOCK), 3) - copy_ms,
                plain_ms=time_ms(lambda: panel_qrcp.qrcp_panel_plain(
                    work.copy_(blk0), BLOCK), 1) - copy_ms,
                library_ms=None,
                bound=bound(flops, (streamed(passes, QR_M * cols)
                                    + QR_M * cols + QR_M * BLOCK
                                    + cols * BLOCK) * size))
            del blk0, bk_, bp_, got, want, work
        res["qrcp_panel"] = {**qrcp_rows[QR_N], "window": qrcp_rows[BLOCK]}
        check(qrcp_rows[BLOCK]["rel_err"] <= qrcp_rows[BLOCK]["tol"],
              f"qrcp_panel {dtype} window: kernel vs plain rel err "
              f"{qrcp_rows[BLOCK]['rel_err']}")

        # xLAHR2: gehrd's first panel (k = 0) and one from the middle
        # (k = N/2) of an N x N matrix, and the first panel of the rtm
        # path's RTM_N x RTM_N matrix (L2-resident in both dtypes), in
        # place.
        # Arrays within 4·c·eps of the plain version, c the longest chain
        # of terms the kernel sums for one element: a GEMV row (a lane's
        # ⌈(N−k)/32⌉ columns and five shuffle steps) or a cross-block sum
        # (⌈N/G⌉ rows, then G partials), then the 2·BLOCK terms of the
        # right and left updates.  The bound
        # counts each column's GEMV pass over columns kj+1.. of every row
        # where the matrix exceeds L2 (one read of it where it fits), the
        # panel read and written, and V and W written.  No PyTorch call
        # computes it.
        hess_rows = {}
        for nh, k0 in ((N, 0), (N, N // 2), (RTM_N, 0)):
            g_hess = panel_hessenberg._grid(sfx, nh, BLOCK)
            a0 = randn(nh, nh)
            ak, ap = a0.clone(), a0.clone()
            got = panel_hessenberg.hessenberg_panel(ak, k0, BLOCK)
            want = panel_hessenberg.hessenberg_panel_plain(ap, k0, BLOCK)
            sync()
            cmp = [compare(x, y) for x, y in zip(got, want)]
            errs = dict(zip(("a", "v", "t", "w", "tau"), (c[0] for c in cmp)))
            del ak, ap, got, want
            work = torch.empty_like(a0)
            copy_ms = time_ms(lambda: work.copy_(a0), 5)
            passes = sum(float(nh) * (nh - k0 - j - 1) for j in range(BLOCK))
            chain = max(-(-(nh - k0) // 32) + 5, -(-nh // g_hess) + g_hess) \
                + 2 * BLOCK
            hess_rows[nh, k0] = dict(
                shape=[nh, nh, BLOCK], k=k0, rel_err=max(errs.values()),
                rel_errs=errs, grid=g_hess, chain=chain,
                max_abs_err=max(c[1] for c in cmp),
                tol=tolerance(dtype, chain),
                ms=time_ms(lambda: panel_hessenberg.hessenberg_panel(
                    work.copy_(a0), k0, BLOCK), 3) - copy_ms,
                plain_ms=time_ms(
                    lambda: panel_hessenberg.hessenberg_panel_plain(
                        work.copy_(a0), k0, BLOCK), 1) - copy_ms,
                library_ms=None,
                bound=bound(2.0 * passes + 8.0 * nh * BLOCK * BLOCK,
                            (streamed(passes, nh * (nh - k0))
                             + 4 * nh * BLOCK + BLOCK * BLOCK
                             + BLOCK) * size))
            check(hess_rows[nh, k0]["rel_err"] <= hess_rows[nh, k0]["tol"],
                  f"hessenberg_panel {dtype} n={nh} k={k0}: kernel vs plain "
                  f"rel err {hess_rows[nh, k0]['rel_err']}")
            del a0, work
        res["hessenberg_panel"] = {**hess_rows[N, 0],
                                   "k_half": hess_rows[N, N // 2],
                                   "n_rtm": hess_rows[RTM_N, 0]}

        for name, r in res.items():
            check(r["rel_err"] <= r["tol"],
                  f"{name} {dtype}: kernel vs plain rel err {r['rel_err']} "
                  f">= {r['tol']}")
        rows[str(dtype).replace("torch.", "")] = res
        emit({"phase": "kernels", "dtype": str(dtype), "results": res})

    # ---- 4. the main path through the entry points -------------------------
    def emit_trace(path, variant, dtype, run, n=N):
        """PF/TU/PU/SWAP shares of one traced factor (spans fenced)."""
        with tracer.trace() as tr:
            run()
        cats = ("PF", "TU", "PU", "SWAP")
        total = sum(tr.total(c) for c in cats)
        emit({"phase": f"trace_{variant}", "path": path, "dtype": str(dtype),
              "n": n, "seconds": {c: tr.total(c) for c in cats},
              "shares": {c: tr.total(c) / total for c in cats},
              "fused_spans": sum(1 for sp in tr.spans if sp.meta.get("fused"))})

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
        for variant in ("mtb", "la", "la2", "la_mb"):
            before = (panel_lu.lu_panel.launches
                      + fpu.fused_lu_panel_update.launches)
            sync()
            t0 = time.perf_counter()
            fac = lu_factor(a, BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            sync()
            t2 = time.perf_counter()
            panels = (panel_lu.lu_panel.launches
                      + fpu.fused_lu_panel_update.launches - before)
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

        # tracer shares of one la and one la_mb run
        for variant in ("la", "la_mb"):
            emit_trace("gesv", variant, dtype,
                       lambda: lu_factor(a, BLOCK, variant=variant))

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
    for name in ("gemm_accum", "trsm", "lu_panel", "lu_solve_small",
                 "fused_lu_panel_update"):
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "gesv path")

    # ---- 5. posv: Cholesky on a symmetric positive-definite input ----------
    chol_flops = N ** 3 / 3.0
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        g = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        a = torch.matmul(g, g.mT) / N
        a.diagonal().add_(1.0)
        del g
        b = torch.randn(N, NRHS, generator=gen, device=dev, dtype=dtype)
        base = None
        for variant in ("mtb", "la", "la2", "la_mb"):
            sync()
            t0 = time.perf_counter()
            fac = cholesky_factor(a, BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            sync()
            t2 = time.perf_counter()
            res = scaled_residual(a, x, b, dtype)
            check(res < RESIDUAL_LIMIT, f"posv {variant} {dtype}: residual {res}")
            if base is None:
                base = fac
            else:
                check(torch.equal(fac.l, base.l),
                      f"posv {variant} {dtype}: factor differs from mtb's")
            emit({"phase": "posv", "dtype": str(dtype), "n": N,
                  "block": BLOCK, "nrhs": NRHS, "variant": variant,
                  "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
                  "factor_gflops": chol_flops / (t1 - t0) / 1e9,
                  "scaled_residual": res, "bitwise_equal_to_mtb": True})
        del fac, x

        # the vendor-library baseline (cuSOLVER potrf + potrs), warmed up
        no_tf32()
        torch.cholesky_solve(b, torch.linalg.cholesky(a))
        sync()
        t0 = time.perf_counter()
        l_lib = torch.linalg.cholesky(a)
        sync()
        t1 = time.perf_counter()
        x = torch.cholesky_solve(b, l_lib)
        sync()
        t2 = time.perf_counter()
        emit({"phase": "posv_library", "dtype": str(dtype), "n": N,
              "call": "torch.linalg.cholesky + torch.cholesky_solve",
              "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
              "factor_gflops": chol_flops / (t1 - t0) / 1e9,
              "scaled_residual": scaled_residual(a, x, b, dtype)})
        del l_lib, x

        # one PyTorch-op cholesky_unblocked of a diagonal block: the part of
        # the composed Cholesky PF that runs as PyTorch ops, once per panel
        blk = a[:BLOCK, :BLOCK].clone()
        unb_ms = time_ms(lambda: cholesky_unblocked(blk.copy_(a[:BLOCK,
                                                                 :BLOCK])), 5)
        emit({"phase": "cholesky_unblocked", "dtype": str(dtype),
              "block": BLOCK, "ms_per_call": unb_ms, "calls_per_factor": npanels,
              "ms_per_factor": unb_ms * npanels})
        for variant in ("la", "la_mb"):
            emit_trace("posv", variant, dtype,
                       lambda: cholesky_factor(a, BLOCK, variant=variant))

        # rtm at a smaller n (a principal submatrix: SPD too), bitwise
        a2, b2 = a[:RTM_N, :RTM_N], b[:RTM_N]
        f_mtb = cholesky_factor(a2, BLOCK, variant="mtb")
        sync()
        t0 = time.perf_counter()
        f_rtm = cholesky_factor(a2, BLOCK, variant="rtm")
        sync()
        t1 = time.perf_counter()
        res = scaled_residual(a2, f_rtm.solve(b2), b2, dtype)
        check(res < RESIDUAL_LIMIT, f"posv rtm {dtype}: residual {res}")
        check(torch.equal(f_rtm.l, f_mtb.l),
              f"posv rtm {dtype}: factor differs from mtb's")
        emit({"phase": "posv", "dtype": str(dtype), "n": RTM_N,
              "block": BLOCK, "variant": "rtm", "factor_ms": (t1 - t0) * 1e3,
              "scaled_residual": res, "bitwise_equal_to_mtb": True})
        del a, b, a2, b2, f_mtb, f_rtm, base
    counts_posv = ops.launches()
    for name in ("gemm_accum", "trsm", "trsm_right_lower_t",
                 "fused_cholesky_panel_update"):
        check(counts_posv[name] > 0, f"kernel {name} was not launched on the "
              "posv path")
    counts = {k: counts[k] + counts_posv[k] for k in counts}

    # ---- 6. gels: Householder QR, then the least-squares solve -------------
    def ls_ratio(a, x, b, dtype):
        """LAPACK's least-squares test ratio ‖Aᵀ(b − A·x)‖ /
        (max(m, n, nrhs)·eps·‖A‖·‖b‖), Frobenius norms, in float64."""
        a, x, b = a.double(), x.double(), b.double()
        num = float((a.mT @ (b - a @ x)).norm())
        return num / (max(*a.shape, b.shape[1]) * torch.finfo(dtype).eps
                      * float(a.norm()) * float(b.norm()))

    def same(f, g, fields):
        return all(torch.equal(getattr(f, k), getattr(g, k)) for k in fields)

    qr_flops = 2.0 * QR_M * QR_N ** 2 - 2.0 * QR_N ** 3 / 3.0
    qr_panels = -(-QR_N // BLOCK)
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        a = torch.randn(QR_M, QR_N, generator=gen, device=dev, dtype=dtype)
        b = torch.randn(QR_M, NRHS, generator=gen, device=dev, dtype=dtype)
        base = None
        for variant in ("mtb", "la", "la2", "la_mb"):
            before = panel_qr.qr_panel.launches
            sync()
            t0 = time.perf_counter()
            fac = qr_factor(a, BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            sync()
            t2 = time.perf_counter()
            panels = panel_qr.qr_panel.launches - before
            check(panels == qr_panels,
                  f"gels {variant}: {panels} panel launches, expected "
                  f"{qr_panels}")
            ratio = ls_ratio(a, x, b, dtype)
            check(ratio < RESIDUAL_LIMIT, f"gels {variant} {dtype}: "
                  f"least-squares ratio {ratio}")
            if base is None:
                base = fac
            else:
                check(same(fac, base, ("packed", "taus")),
                      f"gels {variant} {dtype}: factors differ from mtb's")
            emit({"phase": "gels", "dtype": str(dtype), "m": QR_M, "n": QR_N,
                  "block": BLOCK, "nrhs": NRHS, "variant": variant,
                  "factor_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
                  "factor_gflops": qr_flops / (t1 - t0) / 1e9,
                  "ls_ratio": ratio, "panel_launches": panels,
                  "bitwise_equal_to_mtb": True})
        del base, fac, x

        # the vendor library (cuSOLVER geqrf; lstsq with the gels driver),
        # each timed after one warm-up call
        no_tf32()
        lib = {}
        for name, call in (("geqrf", lambda: torch.geqrf(a)),
                           ("lstsq", lambda: torch.linalg.lstsq(a, b))):
            call()
            sync()
            t0 = time.perf_counter()
            out = call()
            sync()
            lib[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        emit({"phase": "gels_library", "dtype": str(dtype), "m": QR_M,
              "n": QR_N, "call": "torch.geqrf; torch.linalg.lstsq", **lib,
              "factor_gflops": qr_flops / lib["geqrf_ms"] * 1e-6,
              "ls_ratio": ls_ratio(a, out.solution, b, dtype)})
        del out

        emit_trace("gels", "la", dtype,
                   lambda: qr_factor(a, BLOCK, variant="la"), n=QR_N)

        # rtm at 4096 x 1024 and a wide 1024 x 2048 factor, bitwise vs mtb
        for (m_, n_), variants in ((QR_RTM, ("rtm",)),
                                   (QR_WIDE, ("la", "la2", "rtm"))):
            a2 = a[:m_, :n_] if n_ <= QR_N else torch.randn(
                m_, n_, generator=gen, device=dev, dtype=dtype)
            f_mtb = qr_factor(a2, BLOCK, variant="mtb")
            for variant in variants:
                sync()
                t0 = time.perf_counter()
                f_v = qr_factor(a2, BLOCK, variant=variant)
                sync()
                t1 = time.perf_counter()
                check(same(f_v, f_mtb, ("packed", "taus")),
                      f"qr {variant} {m_}x{n_} {dtype}: factors differ from "
                      "mtb's")
                row = {"phase": "gels", "dtype": str(dtype), "m": m_,
                       "n": n_, "block": BLOCK, "variant": variant,
                       "factor_ms": (t1 - t0) * 1e3,
                       "bitwise_equal_to_mtb": True}
                if m_ >= n_:
                    row["ls_ratio"] = ls_ratio(a2, f_v.solve(b[:m_]), b[:m_],
                                               dtype)
                    check(row["ls_ratio"] < RESIDUAL_LIMIT,
                          f"gels {variant} {m_}x{n_}: ratio {row['ls_ratio']}")
                emit(row)
        del a, b, a2, f_mtb, f_v
    counts_gels = ops.launches()
    for name in ("gemm_accum", "trsm", "qr_panel", "larft"):
        check(counts_gels[name] > 0, f"kernel {name} was not launched on the "
              "gels path")
    counts = {k: counts[k] + counts_gels[k] for k in counts}

    # ---- 7. gels(pivot=True): column-pivoted QR, global and windowed -------
    def diag_ok(packed, windows, dtype):
        """|r_jj| non-increasing (slack 1 + 1e3·eps), within each window."""
        d = packed.diagonal().abs().double()
        slack = 1.0 + 1e3 * torch.finfo(dtype).eps
        return all(bool((d[k + 1 : k + w] <= d[k : k + w - 1] * slack
                         + 1e-300).all()) for k, w in windows)

    def is_perm(jpvt):
        return torch.equal(jpvt.sort().values.long(),
                           torch.arange(jpvt.shape[0], device=jpvt.device))

    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        a = torch.randn(QR_M, QR_N, generator=gen, device=dev, dtype=dtype)
        b = torch.randn(QR_M, NRHS, generator=gen, device=dev, dtype=dtype)
        rank_def = torch.matmul(
            torch.randn(QR_M, QR_N // 2, generator=gen, device=dev,
                        dtype=dtype),
            torch.randn(QR_N // 2, QR_N, generator=gen, device=dev,
                        dtype=dtype))
        local_base = None
        for local, variant in ((False, "mtb"), (True, "mtb"), (True, "la"),
                               (True, "la2")):
            before = panel_qrcp.qrcp_panel.launches
            sync()
            t0 = time.perf_counter()
            fac = geqp3(a, BLOCK, variant=variant, local=local)
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            sync()
            t2 = time.perf_counter()
            panels = panel_qrcp.qrcp_panel.launches - before
            check(panels == qr_panels, f"gels pivot {variant}: {panels} "
                  f"panel launches, expected {qr_panels}")
            name = f"{'local ' if local else ''}{variant} {dtype}"
            check(is_perm(fac.jpvt), f"gels pivot {name}: jpvt is not a "
                  "permutation")
            windows = ([(k, BLOCK) for k in range(0, QR_N, BLOCK)] if local
                       else [(0, QR_N)])
            check(diag_ok(fac.packed, windows, dtype),
                  f"gels pivot {name}: |r_jj| increases")
            ratio = ls_ratio(a, x, b, dtype)
            check(ratio < RESIDUAL_LIMIT,
                  f"gels pivot {name}: least-squares ratio {ratio}")
            if local:
                if local_base is None:
                    local_base = fac
                else:
                    check(same(fac, local_base, ("packed", "taus", "jpvt")),
                          f"gels pivot {name}: factors differ from local "
                          "mtb's")
            emit({"phase": "gels_pivot", "dtype": str(dtype), "m": QR_M,
                  "n": QR_N, "block": BLOCK, "nrhs": NRHS, "local": local,
                  "variant": variant, "factor_ms": (t1 - t0) * 1e3,
                  "solve_ms": (t2 - t1) * 1e3, "ls_ratio": ratio,
                  "rank": fac.rank(), "panel_launches": panels,
                  "bitwise_equal_to_local_mtb": local or None})
        del local_base, fac, x

        # a rank-n/2 input: the rank and the least-squares ratio, global
        # (checked) and windowed (reported)
        for local in (False, True):
            sync()
            t0 = time.perf_counter()
            fac = geqp3(rank_def, BLOCK, local=local, variant="mtb")
            sync()
            t1 = time.perf_counter()
            x = fac.solve(b)
            rank = fac.rank()
            ratio = ls_ratio(rank_def, x, b, dtype)
            if not local:
                check(rank == QR_N // 2, f"gels pivot {dtype}: rank {rank} "
                      f"of a rank-{QR_N // 2} input")
                check(ratio < RESIDUAL_LIMIT, f"gels pivot rank-deficient "
                      f"{dtype}: least-squares ratio {ratio}")
            emit({"phase": "gels_pivot_rank_deficient", "dtype": str(dtype),
                  "m": QR_M, "n": QR_N, "local": local, "variant": "mtb",
                  "true_rank": QR_N // 2, "rank": rank, "ls_ratio": ratio,
                  "factor_ms": (t1 - t0) * 1e3})
        del rank_def, fac, x

        # global rtm at 4096 x 1024, bitwise vs mtb
        a2 = a[:QR_RTM[0], :QR_RTM[1]]
        f_mtb = geqp3(a2, BLOCK, variant="mtb")
        sync()
        t0 = time.perf_counter()
        f_rtm = geqp3(a2, BLOCK, variant="rtm")
        sync()
        t1 = time.perf_counter()
        check(same(f_rtm, f_mtb, ("packed", "taus", "jpvt")),
              f"gels pivot rtm {dtype}: factors differ from mtb's")
        emit({"phase": "gels_pivot", "dtype": str(dtype), "m": QR_RTM[0],
              "n": QR_RTM[1], "block": BLOCK, "local": False,
              "variant": "rtm", "factor_ms": (t1 - t0) * 1e3,
              "bitwise_equal_to_mtb": True})
        del a, b, a2, f_mtb, f_rtm
    counts_piv = ops.launches()
    for name in ("gemm_accum", "trsm", "qrcp_panel", "larft"):
        check(counts_piv[name] > 0, f"kernel {name} was not launched on the "
              "gels(pivot=True) path")
    counts = {k: counts[k] + counts_piv[k] for k in counts}

    # ---- 8. gehrd: Hessenberg reduction, A = Q·H·Qᵀ ------------------------
    def fro(x):
        return float(x.double().norm())

    hess_flops = 10.0 * N ** 3 / 3.0
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        a = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        eps = torch.finfo(dtype).eps
        before = panel_hessenberg.hessenberg_panel.launches
        sync()
        t0 = time.perf_counter()
        fac = gehrd(a, BLOCK)
        sync()
        t1 = time.perf_counter()
        panels = panel_hessenberg.hessenberg_panel.launches - before
        check(panels == npanels, f"gehrd {dtype}: {panels} panel launches, "
              f"expected {npanels}")
        check(not bool(torch.tril(fac.h, -2).any()),
              f"gehrd {dtype}: H is not zero below the first subdiagonal")
        q = fac.q()
        sync()
        t2 = time.perf_counter()
        eye = torch.eye(N, dtype=torch.float64, device=dev)
        orth = fro(q.double().mT @ q.double() - eye) / (N * eps)
        del q, eye
        sync()
        t3 = time.perf_counter()
        rec = fac.reconstruct()
        sync()
        t4 = time.perf_counter()
        resid = fro(a - rec) / (N * eps * fro(a))
        del rec
        check(orth < RESIDUAL_LIMIT, f"gehrd {dtype}: ‖QᵀQ − I‖/(n·eps) "
              f"{orth}")
        check(resid < RESIDUAL_LIMIT, f"gehrd {dtype}: ‖A − QHQᵀ‖/"
              f"(n·eps·‖A‖) {resid}")
        emit({"phase": "gehrd", "dtype": str(dtype), "n": N, "block": BLOCK,
              "variant": "mtb", "factor_ms": (t1 - t0) * 1e3,
              "factor_gflops": hess_flops / (t1 - t0) / 1e9,
              "q_ms": (t2 - t1) * 1e3, "reconstruct_ms": (t4 - t3) * 1e3,
              "orthogonality": orth, "scaled_residual": resid,
              "panel_launches": panels})
        del fac
        emit_trace("gehrd", "mtb", dtype, lambda: gehrd(a, BLOCK))

        # rtm at a smaller n (the matrix stays in L2 in float64), bitwise
        a2 = a[:RTM_N, :RTM_N]
        f_mtb = gehrd(a2, BLOCK)
        sync()
        t0 = time.perf_counter()
        f_rtm = gehrd(a2, BLOCK, variant="rtm")
        sync()
        t1 = time.perf_counter()
        check(same(f_rtm, f_mtb, ("packed", "taus")),
              f"gehrd rtm {dtype}: reduction differs from mtb's")
        resid = fro(a2 - f_rtm.reconstruct()) / (RTM_N * eps * fro(a2))
        check(resid < RESIDUAL_LIMIT, f"gehrd rtm {dtype}: residual {resid}")
        emit({"phase": "gehrd", "dtype": str(dtype), "n": RTM_N,
              "block": BLOCK, "variant": "rtm", "factor_ms": (t1 - t0) * 1e3,
              "scaled_residual": resid, "bitwise_equal_to_mtb": True})
        del a, a2, f_mtb, f_rtm

    # the spectrum of a symmetric input (float64): H is similar to A, so its
    # eigenvalues are real and A's
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    g = torch.randn(EIG_N, EIG_N, generator=gen, device=dev,
                    dtype=torch.float64)
    sym = (g + g.mT) / 2
    ev = gehrd(sym, BLOCK).eigvals()
    ev_a = torch.linalg.eigvalsh(sym)
    scale = max(float(ev_a.abs().max()), 1.0)
    imag = float(ev.imag.abs().max())
    real_err = float((torch.sort(ev.real).values - ev_a).abs().max())
    check(imag < 1e-8 * EIG_N, f"gehrd eigvals: imaginary part {imag}")
    check(real_err < 1e-8 * EIG_N * scale,
          f"gehrd eigvals: {real_err} from eigvalsh")
    emit({"phase": "gehrd_eigvals", "dtype": "torch.float64", "n": EIG_N,
          "eigvals_device": str(ev.device), "max_imag": imag,
          "max_real_err": real_err, "limit": 1e-8 * EIG_N * scale})
    del g, sym, ev, ev_a
    counts_hess = ops.launches()
    for name in ("gemm_accum", "hessenberg_panel", "larft"):
        check(counts_hess[name] > 0, f"kernel {name} was not launched on the "
              "gehrd path")
    counts = {k: counts[k] + counts_hess[k] for k in counts}

    # ---- 9. gecon and getri on the LU factors ------------------------------
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        a = torch.randn(COND_N, COND_N, generator=gen, device=dev,
                        dtype=dtype)
        a64 = a.double()
        eps = torch.finfo(dtype).eps
        exact = 1.0 / float(a64.abs().sum(0).max()
                            * torch.linalg.inv(a64).abs().sum(0).max())
        sync()
        t0 = time.perf_counter()
        est = float(gecon(a, BLOCK, variant="la"))
        t1 = time.perf_counter()
        # Hager's estimate of ‖A⁻¹‖₁ is a lower bound, so est ≥ exact, up to
        # the rounding of the working precision's solves (κ₁·eps)
        slack = max(1e-6, eps / exact)
        ratio = est / exact
        check(1.0 <= ratio * (1.0 + slack) and ratio <= 10.0,
              f"gecon {dtype}: estimate / exact = {ratio}")
        sync()
        t2 = time.perf_counter()
        x = getri(a, BLOCK)
        sync()
        t3 = time.perf_counter()
        eye = torch.eye(COND_N, dtype=torch.float64, device=dev)
        resid = fro(a64 @ x.double() - eye) / (COND_N * eps * fro(a)
                                                * fro(x))
        check(resid < RESIDUAL_LIMIT, f"getri {dtype}: residual {resid}")
        emit({"phase": "gecon_getri", "dtype": str(dtype), "n": COND_N,
              "block": BLOCK, "variant": "la", "rcond_estimate": est,
              "rcond_exact": exact, "ratio": ratio, "slack": slack,
              "gecon_ms": (t1 - t0) * 1e3, "getri_ms": (t3 - t2) * 1e3,
              "getri_scaled_residual": resid})
        del a, a64, x, eye
    counts_cond = ops.launches()
    for name in ("gemm_accum", "trsm", "lu_panel"):
        check(counts_cond[name] > 0, f"kernel {name} was not launched on the "
              "gecon/getri path")
    counts = {k: counts[k] + counts_cond[k] for k in counts}
    for name, count in counts.items():
        if name not in SERVING_KERNELS:   # checked on the serving paths
            check(count > 0,
                  f"kernel {name} was not launched on the main paths")

    # ---- 10. flash attention against its plain version ---------------------
    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    heads, kv_heads, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        res = {}
        for key, bsz, seq, reps in (("serve", SERVE_BATCH, PROMPT, 10),
                                    ("prefill_32k", 1, LONG_S, 2)):
            gen = torch.Generator(device=dev).manual_seed(SEED + 8)

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)

            q = randn(bsz, heads, seq, hd)
            k, v = randn(bsz, kv_heads, seq, hd), randn(bsz, kv_heads, seq, hd)
            # the positions prefill passes (transformer.forward: arange,
            # int64), so the kernel is held and timed on the serving route
            pos = torch.arange(seq, device=dev)

            def kernel():
                return attention.flash_attention(q, k, v, qpos=pos, kpos=pos)

            got = kernel()
            sync()
            want, tol = attention.attn_expect(q, k, v, qpos=pos, kpos=pos)
            mx, worst = attn_err(got, want, tol)
            # planted faults the tolerance must catch: the 64-key tile at
            # S/2 left out (hidden through kpos), the second half of the
            # rows not written
            planted = {name: attn_err(wrong, want, tol)[1] for name, wrong
                       in attention.attn_faults(q, k, v, got, qpos=pos,
                                                kpos=pos).items()}
            del got
            if dtype == torch.bfloat16:
                ke, ve = k, v

                def lib():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, ke, ve, is_causal=True, enable_gqa=True)
            else:
                # enable_gqa sends float32 to the math backend, which
                # materialises the 32k x 32k scores (160 GiB): time the
                # same function on KV heads repeated beforehand instead
                ke = k.repeat_interleave(heads // kv_heads, dim=1)
                ve = v.repeat_interleave(heads // kv_heads, dim=1)

                def lib():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, ke, ve, is_causal=True)
            # SDPA rounds P to bfloat16 once: recorded against the same
            # bound, not gated
            lib_err, lib_worst = attn_err(lib(), want, tol)
            check(worst <= 1.0, f"flash_attention {dtype} {key}: kernel vs "
                  f"plain (float64) {worst} of the tolerance, max abs err "
                  f"{mx}")
            check(min(planted.values()) > 1.0,
                  f"flash_attention {dtype} {key}: the tolerance does not "
                  f"catch every planted fault: {planted}")
            res[key] = dict(
                shape=[bsz, heads, kv_heads, seq, hd], causal=True,
                max_abs_err=mx, err_over_tol=worst,
                planted_err_over_tol=planted,
                library_max_abs_err=lib_err,
                library_err_over_tol=lib_worst,
                # the card's time (a wrapper call's host work is about
                # half the bfloat16 kernel's 0.2 ms at the serving shape),
                # and one call from an idle card as the other phases time
                ms=queued_ms(kernel, reps),
                call_ms=time_ms(kernel, reps),
                plain_ms=time_ms(lambda: attention.flash_attention_plain(
                    q, k, v, pos, pos), 1),
                library_ms=queued_ms(lib, reps),
                library_call_ms=time_ms(lib, reps),
                library=("sdpa(is_causal, enable_gqa)"
                         if dtype == torch.bfloat16
                         else "sdpa(is_causal), KV repeated to 40 heads"),
                bound=bound(0.5 * 4.0 * bsz * heads * seq * seq * hd,
                            2.0 * (q.numel() + k.numel()) * size,
                            BF16_FLOPS if dtype == torch.bfloat16
                            else PEAK_FLOPS))
            del q, k, v, pos, want, tol, ke, ve
        attn_rows[str(dtype).replace("torch.", "")] = res
        if dtype == torch.bfloat16:
            # the tensor-core kernel's tiling, registers, spills and MMA
            # instructions at the served head dim
            res["kernel"] = {
                **attention.kernel_config(hd),
                "ptxas": [{**r, "kernel": flash_kernel_name(r["kernel"])}
                          for r in ptxas["flash_attention"]],
                "sass_mma": flash_mma}
        emit({"phase": "kernels_attention", "dtype": str(dtype),
              "results": res})
    torch.cuda.empty_cache()

    # ---- 11. serve phi3-medium-14b: full width and depth, bfloat16 ---------
    def leaves(tree):
        for x in tree.values():
            yield from leaves(x) if isinstance(x, dict) else (x,)

    def device_busy(fn):
        """Wall ms of ``fn`` under ``torch.profiler``, the ms in which the
        card ran a kernel or copy (the union of their intervals) and the
        device time by kernel name (top 6); the profiler's own host cost
        lengthens the wall time, so the busy ms are the number to read."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        spans, by_name = [], {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                spans.append((ev.time_range.start, ev.time_range.end))
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    (ev.time_range.end - ev.time_range.start) / 1e3
        busy, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"wall_ms": wall,
                "busy_ms": busy / 1e3 if spans else None,   # not measured
                "kernels": len(spans),
                "top_ms": {name[:60]: ms for name, ms in top}}

    def serve(cfg, phase, kernel):
        """Serve ``cfg`` (seeded random weights made on the card) through
        ``ServeEngine.generate``: batch 4, prompt 1024, 64 new tokens,
        greedy.  ``kernel`` must launch once a layer in the prefill, never
        in decode, and no other kernel may launch.  Returns (params, the
        run's launch counts)."""
        sync()
        t0 = time.perf_counter()
        params = api.init_params(cfg, SEED)
        sync()
        init_s = time.perf_counter() - t0
        param_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(params))
        engine = ServeEngine(cfg, params, ServeConfig(
            batch_size=SERVE_BATCH, max_len=PROMPT + NEW_TOKENS, seed=SEED))
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (SERVE_BATCH, PROMPT)).astype(np.int32)
        engine.generate(prompts, 4)    # warm-up: library handles, heuristics
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        tokens, stats = engine.generate(prompts, NEW_TOKENS)
        counts = ops.launches()
        peak = torch.cuda.max_memory_allocated()
        check(tokens.shape == (SERVE_BATCH, NEW_TOKENS)
              and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
              f"{phase}: tokens of shape {tokens.shape} outside the vocab")
        # one launch a layer per prefill, none per decode step (one prefill
        # and NEW_TOKENS - 1 decode steps in this run), no other kernel
        others = {n: c for n, c in counts.items() if n != kernel and c}
        check(counts[kernel] == cfg.num_layers and not others,
              f"{phase}: {counts[kernel]} {kernel} launches, expected "
              f"{cfg.num_layers} (one prefill); others {others}")
        steps = NEW_TOKENS - 1
        prof_cache = {}

        def prof_prefill():
            prof_cache["c"] = api.prefill(cfg, params, {"tokens": prompts},
                                          max_len=PROMPT + NEW_TOKENS)[1]

        def prof_decode():
            for i in range(8):
                api.decode_step(cfg, params, prof_cache["c"], prompts[:, :1],
                                PROMPT + i)

        busy_prefill = device_busy(prof_prefill)
        busy_decode = device_busy(prof_decode)
        del prof_cache, engine
        emit({"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
              "layers": cfg.num_layers, "params": cfg.param_count(),
              "param_bytes": param_bytes, "init_s": init_s,
              "batch": SERVE_BATCH, "prompt": PROMPT,
              "new_tokens": NEW_TOKENS,
              "sampling": "greedy", "prefill_ms": stats["prefill_s"] * 1e3,
              "decode_steps": steps,
              "decode_ms_per_step": stats["decode_s"] * 1e3 / steps,
              "decode_step_p50_ms": stats["p50_ms"],
              "decode_step_p99_ms": stats["p99_ms"],
              "decode_tok_per_s": stats["decode_tok_per_s"],
              "tok_per_s": stats["items_per_s"], "wall_s": stats["wall"],
              "peak_memory_bytes": peak,
              f"{kernel}_launches": counts[kernel],
              "prefills": 1,
              "profiled_prefill": busy_prefill,
              "profiled_8_decode_steps": busy_decode})
        return params, counts

    params, serve_counts = serve(cfg, "serve", "flash_attention")

    # ---- 12. teacher-forced decode against the full forward ---------------
    def consistency(cfg, params, phase, kernel, tol, extra=None):
        """Prefill CONS_S/2 tokens of a CONS_S-token sequence, decode the
        next CONS_DECODE of its tokens, and hold the logits to the full
        forward's over all CONS_S (the prefill's kernel against plain
        decode) within ``tol``; ``extra`` adds its keys to the line.
        Returns the tokens and the compared rows (decoded, full
        forward's)."""
        toks = np.random.default_rng(SEED + 9).integers(
            0, cfg.vocab_size, (1, CONS_S)).astype(np.int32)
        half = CONS_S // 2
        ops.reset_launches()
        sync()
        t0 = time.perf_counter()
        full = api.apply(cfg, params, {"tokens": toks})
        sync()
        full_ms = (time.perf_counter() - t0) * 1e3
        n_full = ops.launches()[kernel]
        lg, cache = api.prefill(cfg, params, {"tokens": toks[:, :half]},
                                max_len=CONS_S)
        n_prefill = ops.launches()[kernel] - n_full
        rows = [lg[:, 0]]
        for i in range(CONS_DECODE):
            lg, cache = api.decode_step(cfg, params, cache,
                                        toks[:, half + i:half + i + 1],
                                        half + i)
            rows.append(lg[:, 0])
        n_decode = ops.launches()[kernel] - n_full - n_prefill
        got = torch.stack(rows, dim=1).double()
        want = full[:, half - 1:half + CONS_DECODE].double()
        check(bool(torch.isfinite(full).all()) and full.shape ==
              (1, CONS_S, cfg.vocab_size), f"{phase}: full forward "
              "logits not finite or of the wrong shape")
        check((n_full, n_prefill, n_decode)
              == (cfg.num_layers, cfg.num_layers, 0),
              f"{phase}: {kernel} launches {n_full}/{n_prefill}/{n_decode}")
        rel = float((got - want).norm() / want.norm())
        check(rel <= tol, f"{phase} {cfg.dtype}: relative deviation "
              f"{rel} > {tol}")
        emit({"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
              "layers": cfg.num_layers, "sequence": CONS_S, "prefill": half,
              "decode_steps": CONS_DECODE, "rel_fro_deviation": rel,
              "limit": tol,
              "max_abs_deviation": float((got - want).abs().max()),
              "max_abs_logit": float(want.abs().max()),
              "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                        .double().mean()),
              "full_forward_ms": full_ms,
              "kernel_launches": {"full": n_full, "prefill": n_prefill,
                                  "decode": n_decode}, **(extra or {})})
        return toks, got, want

    consistency(cfg, params, "consistency", "flash_attention",
                CONS_TOL[cfg.dtype])
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=CONS_F32_LAYERS,
                                dtype="float32")
    consistency(cfg32, api.init_params(cfg32, SEED), "consistency",
                "flash_attention", CONS_TOL[cfg32.dtype])
    torch.cuda.empty_cache()

    # ---- 13. the WKV6 kernel against its plain version ---------------------
    cfg = get_config(RWKV_ARCH)
    heads, hd = cfg.num_heads, cfg.head_dim
    c = cfg.rwkv_chunk

    def wkv_inputs(bsz, seq, dtype, seed):
        """r, k, v ~ N(0, 1) in ``dtype``; decays drawn like the served
        model's, log w = -exp(-0.6 + 0.42 z) (its decay offsets have a
        standard deviation of 0.42); u ~ 0.5 N(0, 1)."""
        gen = torch.Generator(device=dev).manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        r, k, v = (randn(bsz, heads, seq, hd).to(dtype) for _ in range(3))
        logw = -torch.exp(-0.6 + 0.42 * randn(bsz, heads, seq, hd))
        return r, k, v, logw, 0.5 * randn(heads, hd)

    def wkv_within(got, want, tol):
        """max of |error| / tolerance."""
        return float(((got.double() - want).abs_() / tol).max())

    def wkv_bound(r, s0, size):
        """The least time of one call: the strict score triangle's flops
        per chunk of n rows, 4·n·dk·dv + n(n-1)·(dk + dv), at the float32
        peak; each input read once (r, k, v in their dtype, logw, u, s0 in
        float32), out and the final state written once."""
        bsz, _, seq, _ = r.shape
        flops = sum(4.0 * n * hd * hd + n * (n - 1) * 2.0 * hd
                    for n in (min(c, seq - t) for t in range(0, seq, c)))
        nbytes = (3 * size + 4 * 2) * r.numel() + 4 * heads * hd \
            + 4 * (0 if s0 is None else s0.numel()) + 4 * bsz * heads * hd * hd
        return bound(flops * bsz * heads, nbytes)

    wkv_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        res = {}
        for key, bsz, seq, reps in (("serve", SERVE_BATCH, PROMPT, 10),
                                    ("prefill_32k", 1, LONG_S, 3),
                                    ("ragged", SERVE_BATCH, WKV_RAGGED, 10)):
            r, k, v, logw, u = wkv_inputs(bsz, seq, dtype, SEED + 10)
            # the ragged run continues from the state of a preceding one
            s0 = None if key != "ragged" else wkv.wkv6_fused(
                *wkv_inputs(bsz, PROMPT, dtype, SEED + 11), chunk=c)[1]
            got, sfin = wkv.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=c)
            sync()
            want, tol, s_want, s_tol = wkv.wkv6_expect(r, k, v, logw, u,
                                                       s0=s0, chunk=c)
            worst = wkv_within(got, want, tol)
            s_worst = wkv_within(sfin, s_want, s_tol)
            plain = wkv_within(wkv.wkv6_fused_plain(r, k, v, logw, u, s0=s0,
                                                    chunk=c)[0], want, tol)
            # split at the chunk boundary nearest S/2: the second part from
            # the first's final state equals the unsplit run
            cut = seq // 2 // c * c
            part = [x[:, :, :cut] for x in (r, k, v, logw)]
            rest = [x[:, :, cut:] for x in (r, k, v, logw)]
            o1, s1 = wkv.wkv6_fused(*part, u, s0=s0, chunk=c)
            o2, s2 = wkv.wkv6_fused(*rest, u, s0=s1, chunk=c)
            split_equal = bool(torch.equal(torch.cat([o1, o2], 2), got)
                               and torch.equal(s2, sfin))
            del part, rest, o1, o2, s1, s2
            # the planted faults: a state dropped at the cut, the diagonal
            # in the score mask, the last chunk unwritten
            planted = {name: wkv_within(bad, want, tol) for name, bad in
                       wkv.wkv6_faults(r, k, v, logw, u, got, s0=s0, chunk=c,
                                       split_at=cut).items()}
            # the share of (chunk, channel) whose cumulative log-decay
            # passes -80 inside a full chunk: the clip engages there
            full_chunks = logw[:, :, :seq // c * c].unflatten(2, (-1, c))
            cum = torch.cumsum(full_chunks, 3)
            clipped = {"channels": float((cum[:, :, :, -1] < -80)
                                         .double().mean()),
                       "exponents": float((cum < -80).double().mean())}
            del cum, full_chunks
            check(worst <= 1.0 and s_worst <= 1.0 and plain <= 1.0,
                  f"wkv6_fused {dtype} {key}: kernel vs plain (float64) "
                  f"{worst} (state {s_worst}) of the tolerance, plain "
                  f"float32 {plain}")
            check(split_equal, f"wkv6_fused {dtype} {key}: the run split at "
                  f"{cut} differs from the unsplit one")
            check(min(planted.values()) > 1.0,
                  f"wkv6_fused {dtype} {key}: the tolerance does not catch "
                  f"each planted fault: {planted}")
            res[key] = dict(
                shape=[bsz, heads, seq, hd], chunk=c, s0=s0 is not None,
                max_abs_err=float((got.double() - want).abs().max()),
                err_over_tol=worst, state_err_over_tol=s_worst,
                plain_err_over_tol=plain, split_at=cut,
                split_equals_unsplit=split_equal,
                planted_err_over_tol=planted,
                clipped_share=clipped,
                ms=time_ms(lambda: wkv.wkv6_fused(r, k, v, logw, u, s0=s0,
                                                  chunk=c), reps),
                plain_ms=time_ms(lambda: wkv.wkv6_fused_plain(
                    r, k, v, logw, u, s0=s0, chunk=c), 1),
                library_ms=None,   # no PyTorch call computes WKV6
                bound=wkv_bound(r, s0, size))
            del r, k, v, logw, u, s0, got, sfin, want, tol, s_want, s_tol
            torch.cuda.empty_cache()
        wkv_rows[str(dtype).replace("torch.", "")] = res
        emit({"phase": "kernels_wkv", "dtype": str(dtype), "results": res})

    # ---- 14. serve rwkv6-7b: full width and depth, bfloat16 ----------------
    params, serve_rwkv_counts = serve(cfg, "serve_rwkv", "wkv6_fused")

    # ---- 15. rwkv6-7b: teacher-forced decode against the full forward ------
    @contextlib.contextmanager
    def watch_wkv(check_kernel: bool):
        """Wrap ``rwkv6.wkv6_chunked`` inside the block: record the lowest
        cumulative log-decay inside a chunk and the share of (chunk,
        channel) that pass -80; with ``check_kernel``, hold each layer's
        WKV output to the plain version in float64 on the same inputs
        within ``wkv6_expect``'s bound (the worst ratio)."""
        seen = {"min_cum": 0.0, "clipped_channels": [], "worst": 0.0,
                "calls": 0}
        inner = rwkv6.wkv6_chunked

        def watched(r, k, v, logw, u, s0, chunk):
            out = inner(r, k, v, logw, u, s0, chunk)
            seq = logw.shape[2]
            for t0 in range(0, seq, chunk):
                cum = torch.cumsum(logw[:, :, t0:t0 + chunk], 2)
                seen["min_cum"] = min(seen["min_cum"], float(cum.min()))
                seen["clipped_channels"].append(
                    float((cum[:, :, -1] < -80).double().mean()))
            if check_kernel:
                want, tol, _, _ = wkv.wkv6_expect(r, k, v, logw, u, s0=s0,
                                                  chunk=chunk)
                seen["worst"] = max(seen["worst"],
                                    wkv_within(out[0], want, tol))
            seen["calls"] += 1
            return out

        rwkv6.wkv6_chunked = watched
        try:
            yield seen
        finally:
            rwkv6.wkv6_chunked = inner

    def stepwise(cfg, params, seq):
        """Relative deviation of token-by-token decode from position 0
        (the exact recurrence) from one full forward (the chunked form)
        over ``seq`` tokens."""
        toks = np.random.default_rng(SEED + 12).integers(
            0, cfg.vocab_size, (1, seq)).astype(np.int32)
        full = api.apply(cfg, params, {"tokens": toks}).double()
        lg, cache = api.prefill(cfg, params, {"tokens": toks[:, :1]},
                                max_len=seq)
        rows = [lg[:, 0]]
        for i in range(1, seq):
            lg, cache = api.decode_step(cfg, params, cache, toks[:, i:i + 1],
                                        i)
            rows.append(lg[:, 0])
        got = torch.stack(rows, dim=1).double()
        return float((got - full).norm() / full.norm())

    def as_float32(tree):
        return {name: as_float32(leaf) if isinstance(leaf, dict)
                else leaf.float() for name, leaf in tree.items()}

    def rounding_witness(cfg, params, toks, got, want):
        """The bfloat16 teacher-forced deviation beside the rounding-free
        answer: the same weights' full forward in float32 over the same
        tokens, and each bfloat16 route's relative deviation from it on
        the compared rows (``want`` the full forward's, ``got`` prefill +
        decode's), within ROUNDING_RATIO of each other."""
        half = CONS_S // 2
        params32 = as_float32(params)
        exact = api.apply(dataclasses.replace(cfg, dtype="float32"),
                          params32, {"tokens": toks})
        exact = exact[:, half - 1:half + CONS_DECODE].double()
        del params32
        torch.cuda.empty_cache()
        dev = {name: float((rows - exact).norm() / exact.norm())
               for name, rows in (("full_forward", want),
                                  ("prefill_decode", got))}
        ratio = max(dev.values()) / max(min(dev.values()), 1e-300)
        check(ratio <= ROUNDING_RATIO,
              f"consistency_rwkv_rounding: the bfloat16 routes lie "
              f"{dev} from the float32 forward, {ratio} apart")
        emit({"phase": "consistency_rwkv_rounding", "arch": cfg.name,
              "layers": cfg.num_layers, "chunk": cfg.rwkv_chunk,
              "rel_fro_from_float32": dev,
              "teacher_forced_rel_fro": float((got - want).norm()
                                              / want.norm()),
              "ratio": ratio, "limit": ROUNDING_RATIO,
              "argmax_agreement_with_float32": {
                  name: float((rows.argmax(-1) == exact.argmax(-1))
                              .double().mean())
                  for name, rows in (("full_forward", want),
                                     ("prefill_decode", got))}})

    def consistency_rwkv(cfg, params):
        """Gated at CONS_RWKV_CHUNK, where the clip cannot engage (in
        bfloat16 with the rounding witness beside it); at the config's
        chunk, each layer's kernel output against the plain version within
        the kernel bound (gated) and the chunked form against the exact
        recurrence (recorded)."""
        gated = dataclasses.replace(cfg, rwkv_chunk=CONS_RWKV_CHUNK)
        with watch_wkv(False) as seen:
            toks, got, want = consistency(
                gated, params, "consistency_rwkv", "wkv6_fused",
                CONS_TOL_RWKV[cfg.dtype], extra={"chunk": CONS_RWKV_CHUNK})
        check(seen["min_cum"] > -80.0,
              f"consistency_rwkv: the cumulative log-decay reached "
              f"{seen['min_cum']} inside a chunk of {CONS_RWKV_CHUNK}: the "
              "clip engaged, so the gate does not hold")
        if cfg.dtype == "bfloat16":
            rounding_witness(gated, params, toks, got, want)
        with watch_wkv(True) as seen_c:
            api.apply(cfg, params, {"tokens": toks})
        check(seen_c["calls"] == cfg.num_layers and seen_c["worst"] <= 1.0,
              f"consistency_rwkv: at chunk {cfg.rwkv_chunk} the kernel is "
              f"{seen_c['worst']} of its bound from the plain version")
        emit({"phase": "consistency_rwkv_clip", "arch": cfg.name,
              "dtype": cfg.dtype, "layers": cfg.num_layers,
              "gated_chunk": CONS_RWKV_CHUNK,
              "gated_min_cum_in_chunk": seen["min_cum"],
              "chunk": cfg.rwkv_chunk, "sequence": CONS_S,
              "min_cum_in_chunk": seen_c["min_cum"],
              "clipped_channel_share": statistics.mean(
                  seen_c["clipped_channels"]),
              "kernel_err_over_tol_worst_layer": seen_c["worst"]})

    consistency_rwkv(cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=CONS_F32_LAYERS,
                                dtype="float32")
    params = api.init_params(cfg32, SEED)
    consistency_rwkv(cfg32, params)
    # recorded, not gated: the reference's clip at its own chunk
    emit({"phase": "rwkv_chunked_vs_stepwise", "arch": cfg32.name,
          "dtype": cfg32.dtype, "layers": cfg32.num_layers,
          "sequence": STEPWISE_S, "rel_fro_deviation": {
              str(ch): stepwise(dataclasses.replace(cfg32, rwkv_chunk=ch),
                                params, STEPWISE_S)
              for ch in (CONS_RWKV_CHUNK, cfg32.rwkv_chunk)}})
    del params
    torch.cuda.empty_cache()

    # ---- 16. report --------------------------------------------------------
    sources = {"gemm_accum": "gemm.cu", "trsm": "trsm.cu",
               "lu_panel": "panel_lu.cu", "lu_solve_small": "trsm.cu",
               "trsm_right_lower_t": "trsm.cu",
               "fused_lu_panel_update": "fused_pu.cu",
               "fused_cholesky_panel_update": "fused_pu.cu",
               "qr_panel": "panel_qr.cu", "larft": "panel_qr.cu",
               "qrcp_panel": "panel_qrcp.cu",
               "hessenberg_panel": "panel_hessenberg.cu"}
    replaces = {"gemm_accum": "src/repro/kernels/blis_gemm.py:126",
                "trsm": "src/repro/kernels/trsm.py:42",
                "lu_panel": "src/repro/kernels/panel_lu.py:34",
                "lu_solve_small": "src/repro/kernels/trsm.py:115",
                "trsm_right_lower_t": "src/repro/kernels/trsm.py:69",
                "fused_lu_panel_update":
                    "src/repro/kernels/fused_panel_update.py:112",
                "fused_cholesky_panel_update":
                    "src/repro/kernels/fused_panel_update.py:194",
                "qr_panel": "src/repro/kernels/panel_qr.py:31",
                "larft": "src/repro/kernels/panel_qr.py:31",
                "qrcp_panel": "src/repro/kernels/panel_qrcp.py:43",
                "hessenberg_panel": "src/repro/kernels/panel_hessenberg.py:39"}

    def numbers(r):
        # what this run measured or gated; a kernel's chosen plan or split
        # stays in its phase record
        out = {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
               "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for key in ("composed_ms", "bitwise_equal_to_chain",
                    "chain_ms", "call_ms", "library_call_ms"):
            if key in r:
                out[key] = r[key]
        for key in ("window", "k_half", "n_rtm"):
            if key in r:
                out[key] = numbers(r[key])
        return out

    def at_shape(key):   # float64 at the top level, float32 beside it
        return {**numbers(rows["float64"][key]), "dtype": "float64",
                "shape": rows["float64"][key]["shape"],
                "float32": numbers(rows["float32"][key])}

    kernels = []
    for name in ops.KERNELS:
        if name in SERVING_KERNELS:
            continue
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": counts[name],
            **at_shape(name)})
        if name == "gemm_accum":   # beta = 0, and the gels paths' products
            kernels[-1]["shapes"] = {key: at_shape(key) for key in (
                "gemm", "gemm_gels_vtc", "gemm_gels_vtc_pu", "gemm_gels_vtb",
                "gemm_accum_qrcp")}
        if name == "trsm":   # the upper mode, and the solves' shape
            kernels[-1]["shapes"] = {key: at_shape(key) for key in (
                "trsm_upper", "trsm_solve", "trsm_solve_upper")}

    def attn_numbers(r):
        out = {**numbers(r), "err_over_tol": r["err_over_tol"]}
        if "library_err_over_tol" in r:
            out["library_err_over_tol"] = r["library_err_over_tol"]
        return out

    def bf16_shape(by_dtype, key):   # bfloat16 on top, float32 beside it
        return {**attn_numbers(by_dtype["bfloat16"][key]),
                "dtype": "bfloat16",
                "shape": by_dtype["bfloat16"][key]["shape"],
                "float32": attn_numbers(by_dtype["float32"][key])}

    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention.py:105",
        "launches": serve_counts["flash_attention"],
        **bf16_shape(attn_rows, "serve"),
        "shapes": {"prefill_32k": bf16_shape(attn_rows, "prefill_32k")}})

    kernels.append({
        "name": "wkv6_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:95",
        "launches": serve_rwkv_counts["wkv6_fused"],
        **bf16_shape(wkv_rows, "serve"),
        "shapes": {key: bf16_shape(wkv_rows, key)
                   for key in ("prefill_32k", "ragged")}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
