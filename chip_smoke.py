#!/usr/bin/env python3
"""Smoke run of the port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; one GPU

1. device: the card, its power limit, the torch/CUDA versions; TF32 off.
2. build:  the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, and what ``-Xptxas -v`` says of each (registers, smem, spills).
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
   same work.  The fused panel
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
    D 128, causal) and at one 32k sequence (prefill_32k's), each output
    within an elementwise bound of the plain version run in float64
    (``attn_expect``), which must also fail two planted faults (a 64-key
    tile left out, the second half of the rows not written); with its time, the plain version's, the bound and the time of
    ``scaled_dot_product_attention`` (a yardstick the port never calls).
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

Launch counts are set to 0 just before each path and read just after it;
each kernel of a path must have launched in it (``flash_attention`` on the
serving path, the others on the factorization paths).

Each phase prints one JSON line and raises on failure (non-zero exit).
Then come the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script exits
non-zero before printing anything.
"""
from __future__ import annotations

import dataclasses
import json
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
    from repro_torch.models import api
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

    def attn_expect(q, k, v):
        """The plain flash attention in float64 (causal) and the kernel's
        elementwise tolerance against it.

        One output is o = Σ p_j·v_j / Σ p_j with p_j = exp(s_j − m).  With
        u = 2^-24 and rounding errors bounded as Higham and Mary's
        probabilistic analysis does, at λ = 10 (a miss chance far below
        1e-9 over all outputs): a score, a D-term dot product scaled, is
        off by (λ·√D + 1)·u·a, a = scale·|q_i|·max_j|k_j| ≥ |s_j|; exp's
        argument s_j − m by u·2a more, and expf adds 2 ulp, so every p_j is
        off by a relative δ = u·((λ·√D + 3)·a + 4), which moves o by at
        most 2·δ·M, M = Σ p_j·|v_j| / Σ p_j.  The two sums over Sk keys and
        the Sk/64 tile rescalings add 2·λ·√(Sk + Sk/64)·u·M, the division
        u·M.  bfloat16 output adds its rounding, 2^-8 of |o| + the above.
        The bound scales with M, not with max|v|: a tile left out or a row
        not written exceeds it, which the phase checks."""
        h, d, hkv, sk = q.shape[1], q.shape[3], k.shape[1], k.shape[2]
        q64, k64, v64 = q.double(), k.double(), v.double()
        both = attention.flash_attention_plain(
            q64, k64, torch.cat([v64, v64.abs()], dim=-1),
            block_q=1024, block_k=1024)
        want, mag = both[..., :d], both[..., d:]
        kmax = k64.norm(dim=-1).amax(dim=-1).repeat_interleave(h // hkv, 1)
        a = d ** -0.5 * q64.norm(dim=-1, keepdim=True) \
            * kmax[:, :, None, None]
        del q64, k64, v64, both
        lam, u = 10.0, 2.0 ** -24
        tol = u * mag * (2.0 * ((lam * d ** 0.5 + 3.0) * a + 4.0)
                         + 2.0 * lam * (sk + sk / 64) ** 0.5 + 1.0)
        if q.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * (want.abs() + tol)
        return want, tol

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

        def gemm_row(c, a, b):
            """The GEMM kernel, ``C − A·B`` (``A·B`` where ``c`` is None),
            against its plain version, one cuBLAS call and the bound."""
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
            sync()
            err, mx = compare(got, plain())
            return dict(
                shape=[mm, k, nn], rel_err=err, max_abs_err=mx,
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
        nc = QR_N - BLOCK
        vt = randn(BLOCK, QR_M)
        res["gemm_gels_vtc"] = gemm_row(None, vt, randn(QR_M, nc))
        res["gemm_gels_vtc_pu"] = gemm_row(None, vt, randn(QR_M, BLOCK))
        res["gemm_gels_vtb"] = gemm_row(None, vt, randn(QR_M, NRHS))
        del vt
        res["gemm_accum_qrcp"] = gemm_row(randn(QR_M - BLOCK, nc),
                                          randn(QR_M - BLOCK, BLOCK),
                                          randn(BLOCK, nc))

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
        rhs_r = randn(m, BLOCK)
        rout = torch.empty_like(rhs_r)
        got = trsm.trsm_right_lower_t(l_c, rhs_r, out=rout)
        sync()
        err, mx = compare(got, trsm.trsm_right_lower_t_plain(l_c, rhs_r))
        res["trsm_right_lower_t"] = dict(
            shape=[m, BLOCK], rel_err=err, max_abs_err=mx,
            tol=tolerance(dtype, BLOCK),
            ms=time_ms(lambda: trsm.trsm_right_lower_t(l_c, rhs_r, out=rout),
                       10),
            plain_ms=time_ms(
                lambda: trsm.trsm_right_lower_t_plain(l_c, rhs_r), 3),
            library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                l_c.mT, rhs_r, upper=True, left=False), 10),
            bound=bound(float(m) * BLOCK * BLOCK,
                        (tri + 2 * m * BLOCK) * size))
        del rhs_r, rout

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
        if name != "flash_attention":   # the serving path's, checked there
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
            got = attention.flash_attention(q, k, v)
            sync()
            want, tol = attn_expect(q, k, v)
            mx, worst = attn_err(got, want, tol)
            # planted faults the tolerance must catch: the 64-key tile at
            # S/2 left out (hidden through kpos), the second half of the
            # rows not written
            kpos = torch.arange(seq, dtype=torch.int32, device=dev)
            kpos[seq // 2:seq // 2 + 64] = seq
            skip = attn_err(attention.flash_attention(q, k, v, kpos=kpos),
                            want, tol)[1]
            got[:, :, seq // 2:] = 0
            zero = attn_err(got, want, tol)[1]
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
            lib_err = float((lib().double() - want).abs().max())
            check(worst <= 1.0, f"flash_attention {dtype} {key}: kernel vs "
                  f"plain (float64) {worst} of the tolerance, max abs err "
                  f"{mx}")
            check(skip > 1.0 and zero > 1.0,
                  f"flash_attention {dtype} {key}: the tolerance does not "
                  f"catch a skipped tile ({skip}) or unwritten rows ({zero})")
            res[key] = dict(
                shape=[bsz, heads, kv_heads, seq, hd], causal=True,
                max_abs_err=mx, err_over_tol=worst,
                planted_err_over_tol={"tile_skipped": skip,
                                      "half_rows_zero": zero},
                library_max_abs_err=lib_err,
                ms=time_ms(lambda: attention.flash_attention(q, k, v), reps),
                plain_ms=time_ms(
                    lambda: attention.flash_attention_plain(q, k, v), 1),
                library_ms=time_ms(lib, reps),
                library=("sdpa(is_causal, enable_gqa)"
                         if dtype == torch.bfloat16
                         else "sdpa(is_causal), KV repeated to 40 heads"),
                bound=bound(0.5 * 4.0 * bsz * heads * seq * seq * hd,
                            2.0 * (q.numel() + k.numel()) * size,
                            BF16_FLOPS if dtype == torch.bfloat16
                            else PEAK_FLOPS))
            del q, k, v, got, want, tol, ke, ve
        attn_rows[str(dtype).replace("torch.", "")] = res
        emit({"phase": "kernels_attention", "dtype": str(dtype),
              "results": res})
    torch.cuda.empty_cache()

    # ---- 11. serve phi3-medium-14b: full width and depth, bfloat16 ---------
    sync()
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED)
    sync()
    init_s = time.perf_counter() - t0

    def leaves(tree):
        for x in tree.values():
            yield from leaves(x) if isinstance(x, dict) else (x,)

    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    engine = ServeEngine(cfg, params, ServeConfig(
        batch_size=SERVE_BATCH, max_len=PROMPT + NEW_TOKENS, seed=SEED))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (SERVE_BATCH, PROMPT)).astype(np.int32)
    engine.generate(prompts, 4)    # warm-up: library handles, heuristics
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens, stats = engine.generate(prompts, NEW_TOKENS)
    serve_counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (SERVE_BATCH, NEW_TOKENS)
          and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
          f"serve: tokens of shape {tokens.shape} outside the vocab")
    # 40 launches per prefill, none per decode step (one prefill and
    # NEW_TOKENS - 1 decode steps in this run)
    check(serve_counts["flash_attention"] == cfg.num_layers,
          f"serve: {serve_counts['flash_attention']} flash_attention "
          f"launches, expected {cfg.num_layers} (one prefill)")
    steps = NEW_TOKENS - 1

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
    del prof_cache
    emit({"phase": "serve", "arch": ARCH, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "params": cfg.param_count(),
          "param_bytes": param_bytes, "init_s": init_s,
          "batch": SERVE_BATCH, "prompt": PROMPT, "new_tokens": NEW_TOKENS,
          "sampling": "greedy", "prefill_ms": stats["prefill_s"] * 1e3,
          "decode_steps": steps,
          "decode_ms_per_step": stats["decode_s"] * 1e3 / steps,
          "decode_step_p50_ms": stats["p50_ms"],
          "decode_step_p99_ms": stats["p99_ms"],
          "decode_tok_per_s": stats["decode_tok_per_s"],
          "tok_per_s": stats["items_per_s"], "wall_s": stats["wall"],
          "peak_memory_bytes": peak,
          "flash_attention_launches": serve_counts["flash_attention"],
          "prefills": 1,
          "profiled_prefill": busy_prefill,
          "profiled_8_decode_steps": busy_decode})

    # ---- 12. teacher-forced decode against the full forward ---------------
    def consistency(cfg, params):
        """Prefill CONS_S/2 tokens of a CONS_S-token sequence, decode the
        next CONS_DECODE of its tokens, and hold the logits to the full
        forward's over all CONS_S (the flash kernel against the plain
        decode attention)."""
        toks = np.random.default_rng(SEED + 9).integers(
            0, cfg.vocab_size, (1, CONS_S)).astype(np.int32)
        half = CONS_S // 2
        ops.reset_launches()
        sync()
        t0 = time.perf_counter()
        full = api.apply(cfg, params, {"tokens": toks})
        sync()
        full_ms = (time.perf_counter() - t0) * 1e3
        n_full = ops.launches()["flash_attention"]
        lg, cache = api.prefill(cfg, params, {"tokens": toks[:, :half]},
                                max_len=CONS_S)
        n_prefill = ops.launches()["flash_attention"] - n_full
        rows = [lg[:, 0]]
        for i in range(CONS_DECODE):
            lg, cache = api.decode_step(cfg, params, cache,
                                        toks[:, half + i:half + i + 1],
                                        half + i)
            rows.append(lg[:, 0])
        n_decode = ops.launches()["flash_attention"] - n_full - n_prefill
        got = torch.stack(rows, dim=1).double()
        want = full[:, half - 1:half + CONS_DECODE].double()
        check(bool(torch.isfinite(full).all()) and full.shape ==
              (1, CONS_S, cfg.vocab_size), "consistency: full forward "
              "logits not finite or of the wrong shape")
        check((n_full, n_prefill, n_decode)
              == (cfg.num_layers, cfg.num_layers, 0),
              f"consistency: flash launches {n_full}/{n_prefill}/{n_decode}")
        rel = float((got - want).norm() / want.norm())
        tol = CONS_TOL[cfg.dtype]
        check(rel <= tol, f"consistency {cfg.dtype}: relative deviation "
              f"{rel} > {tol}")
        emit({"phase": "consistency", "arch": ARCH, "dtype": cfg.dtype,
              "layers": cfg.num_layers, "sequence": CONS_S, "prefill": half,
              "decode_steps": CONS_DECODE, "rel_fro_deviation": rel,
              "limit": tol,
              "max_abs_deviation": float((got - want).abs().max()),
              "max_abs_logit": float(want.abs().max()),
              "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                        .double().mean()),
              "full_forward_ms": full_ms,
              "flash_launches": {"full": n_full, "prefill": n_prefill,
                                 "decode": n_decode}})

    consistency(cfg, params)
    del engine, params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, num_layers=CONS_F32_LAYERS,
                                dtype="float32")
    consistency(cfg32, api.init_params(cfg32, SEED))
    torch.cuda.empty_cache()

    # ---- 13. report --------------------------------------------------------
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
        out = {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
               "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for key in ("composed_ms", "window", "k_half", "n_rtm"):
            if key in r:
                out[key] = r[key] if key == "composed_ms" else numbers(r[key])
        return out

    def at_shape(key):   # float64 at the top level, float32 beside it
        return {**numbers(rows["float64"][key]), "dtype": "float64",
                "shape": rows["float64"][key]["shape"],
                "float32": numbers(rows["float32"][key])}

    kernels = []
    for name in ops.KERNELS:
        if name == "flash_attention":
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

    def attn_numbers(r):
        return {**numbers(r), "err_over_tol": r["err_over_tol"]}

    def attn_shape(key):   # bfloat16 at the top level, float32 beside it
        return {**attn_numbers(attn_rows["bfloat16"][key]),
                "dtype": "bfloat16",
                "shape": attn_rows["bfloat16"][key]["shape"],
                "float32": attn_numbers(attn_rows["float32"][key])}

    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention.py:105",
        "launches": serve_counts["flash_attention"], **attn_shape("serve"),
        "shapes": {"prefill_32k": attn_shape("prefill_32k")}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
