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
   block, 16384 x 4096 with 128 steps, a 16384 x 128 window and a
   65536 x 128 window; the GEMM
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
   card, with one call from an idle card beside them.  The fused small LU
   solve (128 x 16) the same way, bitwise the two chains (unit lower, then
   upper), beside ``torch.linalg.lu_solve`` on both metrics.  The GETF2
   panel, bitwise its plain version with equal pivots, on both of its
   routes (8192 x 128 with each block's rows in shared memory, 65536 x 128
   streamed), route, grid and rows a block recorded, timed on both
   metrics beside ``torch.linalg.lu_factor``.  The fused panel updates are
   held bitwise to the composed kernels, pivots included, and timed on
   both metrics beside them; the Cholesky one (and the Cholesky panel
   kernel, the same kernel with no update terms, at 8192 x 128) also
   bitwise to the panel composed of PyTorch ops (``cholesky_unblocked``)
   and the right TRSM kernel, timed beside it, with its plan printed.  The
   TRSMs (384 x 7808 and its right mode), the GETF2 panel (8192 x 384),
   the fused panel updates (first PU of a block-384 factor) and the
   Cholesky panel (8192 x 384) are run again at block 384, wider than
   256; the QR,
   QRCP and Hessenberg panels within 4·k·eps of their plain versions, k
   the longest chain of terms the kernel sums for one element (its plan's
   ``chain``), QRCP pivots equal.  The three are deterministic; the QR
   panel's T is bitwise its LARFT entry's on the same V; the QR and QRCP
   panels run on both routes (rows resident in shared memory: the
   16384-row panel and window; streamed: the 65536-row ones and the global
   block); route, grid and k recorded; all are timed on both metrics, the
   QR panel beside ``torch.geqrf``.
4. main path: ``gesv`` (LU with partial pivoting, then the solves) through
   the port's entry points, under ``mtb``/``la``/``la2``/``la_mb`` at
   n = 8192 and ``rtm`` at n = 2048, plus n = 128 with block 128 (the fused
   small solve): scaled residuals, look-ahead factors bitwise equal to
   ``mtb``'s, launch counts, wall times, the cuSOLVER baseline and the
   tracer's PF/TU/PU/SWAP shares under ``la`` and ``la_mb``; and at
   n = 8192 with block 384 (wider than 256), every variant ``rtm``
   included, bitwise equal to ``mtb``.
5. second path: ``posv`` (Cholesky, then the solves) on a symmetric
   positive-definite input, under ``mtb``/``la``/``la2``/``la_mb`` at
   n = 8192 and ``rtm`` at n = 2048: the same checks and times, against
   ``torch.linalg.cholesky`` + ``torch.cholesky_solve``; ``mtb`` once more
   with the panel composed of PyTorch ops and the right TRSM kernel
   (``panel_fn=``), bitwise the panel kernel's factor and timed beside it;
   the time of one PyTorch-op ``cholesky_unblocked`` of a 128 x 128 block
   beside the panel kernel's on a 8192 x 128 panel; block 384 as for
   ``gesv``.
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
9a. ``ldlt_factor`` (unpivoted LDLᵀ; its PF the PyTorch-op diagonal sweep
   and the unit right TRSM kernel, its TU the GEMM-accumulate kernel) at
   n = 8192 on a symmetric quasi-definite input made on the card,
   (G + Gᵀ)/2 + diag(±2n): ``mtb``/``la``/``la2``/``la_mb`` each bitwise
   ``mtb``, ‖A − L·D·Lᵀ‖₁/(‖A‖₁·n·eps) and the ``solve`` residual for 16
   right-hand sides under 100, D of both signs; wall ms beside
   ``torch.linalg.ldl_factor`` + ``ldl_solve`` (cuSOLVER's pivoted
   Bunch–Kaufman: the same n³/3 flops, a yardstick, not the same
   function); one diagonal sweep of a 128 x 128 block beside the kernel
   time of the rest of its PF; the traced PF/TU/PU/EPI shares under ``la``.
   Each variant's ms in 9a–9c is the median of ``NEW_REPS`` calls, every
   call bitwise ``mtb``'s first.
9b. ``getri(method="gj")`` (Gauss–Jordan; M from the β = 0 GEMM, every
   update the GEMM-accumulate kernel) at n = 8192 on G·Gᵀ + n·I:
   ``mtb``/``la``/``la2`` bitwise ``mtb``, ‖A·X − I‖₁/(‖A‖₁·‖X‖₁·n·eps)
   under 100, beside ``torch.linalg.inv``'s residual and wall ms; the
   witnesses of the gap between the two (the left residual, the
   ``backend="torch"`` residual, and the residual on A/(2n), which has a
   unit diagonal scale); one diagonal-block inverse (PyTorch ops) beside
   M's GEMM; traced shares.
9c. two-sided band reduction (``qr_panel`` for the left QR and the right LQ
   panels, the GEMMs for the updates) at n = 8192, w = 128: ``la`` bitwise
   ``mtb``, every element outside the band exactly 0, ‖B‖_F within
   100·n·eps of ‖A‖_F, and at n = 2048 the singular values against
   ``torch.linalg.svdvals`` (float64): max|Δσ|/σ_max under 100·n·eps of
   the input dtype (the reference's absolute bound, 200·n·eps·‖A‖_F,
   printed beside it; in float32 it exceeds σ_max itself); wall
   ms (8n³/3 flops; no library call computes it); traced shares.
9d. the tile-DAG backend (``variant="tiled"``, one task at a time on one
   stream): ``cholesky_factor`` at n = 8192, tiles of 256 and 512, against
   ``rtm``'s factor at the same block (bitwise, or the deviation recorded
   and bounded by 200·n·eps), the ``posv`` residual; ``qr_factor`` at
   16384 x 4096, tiles of 256: ‖QR − A‖ and ‖QᵀQ − I‖ through
   ``qr_form_q`` (units of m·eps), the least-squares ratio through
   ``TiledQRFactors``, R exactly triangular; one 512 x 256 tile bitwise
   ``mtb``'s R; two runs bitwise equal; per path the median of
   ``NEW_REPS`` calls beside ``mtb``'s, ``report.tile_dag`` of one traced
   run (tasks, waves, widest wave, ideal speedup, seconds by kind) and
   its launches by kernel (float64 and float32).
9e. the tuner in a temporary cache: ``tune.search`` for LU and Cholesky at
   n = 8192 over blocks ``TUNE_BLOCKS`` and for QR over the default
   blocks with ``tiled`` among the variants (its best-ranked candidates
   and their modeled ms printed), float64: each measured candidate with
   its model prediction and attainment row, the winner at or below the
   measured ``b = 128`` ``la`` baseline, a second search from the cache
   that launches no kernel, and ``gesv``/``posv`` with
   ``variant="tuned"`` bitwise a direct call of the winner.
9f. the trace export: one traced float64 ``gesv`` ``la`` at n = 8192
   written by ``export.write_chrome_trace`` to a temporary file and read
   back as JSON with its lanes; its ``report.overlap`` and
   ``export.render_timeline``.
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
    equals the unsplit one bitwise, and a second run gives the same bits;
    the plan (tiles, grid, blocks an SM, workspace bytes, flag words,
    shared memory, registers, spills); with its time on a busy card and of one
    call from an idle one, the plain version's and the bound (no PyTorch
    call computes WKV6).
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
15a. batched solves: ``gesv_batched`` and ``posv_batched`` with B 64 and
    n 256, block 32 (f64 and f32), then ``lu_factor_batched`` /
    ``cholesky_factor_batched`` and ``solve_batched`` with two fresh
    right-hand-side batches: every system bitwise the unbatched driver's,
    scaled residuals under 100, within the drivers' bound of batched
    ``torch.linalg.solve`` / ``cholesky_solve`` (cuSOLVER), whose wall ms
    stand beside the port's, with the kernel launches of the batched call.
15b. the solve server (``SolveServer``) on two request mixes, closed loop
    (submit, ``pump`` after each, ``drain``), every response bitwise the
    unbatched driver on the raw shape and within the drivers' bound of
    ``torch.linalg.solve`` / ``lstsq``: mix A, the reference's server
    traffic (its ``bench_serve_solver.py`` MIX, 512 requests, f32 and
    f64, ``max_batch`` 16, ``max_wait_s`` 0.005, block 32), then a
    factor-once/solve-many round (64 distinct ``gesv``/``posv`` matrices,
    4 rounds of fresh right-hand sides, ``cache=True``: hit rate 0.75)
    and the one-at-a-time ``gesv`` loop at n 48 (the reference's naive
    baseline); mix B, the larger systems of per-head whitening and
    per-expert normal equations (128 requests, f64, block 128). Each
    prints req/s, p50/p99, batches, buckets (``compiles``), hit rate,
    launches by kernel and the card's name and power limit.
15c. ``mesh``: the mesh engine (``repro_torch.core.distributed``) in worlds
    of ranks on the one card, started by ``repro_torch.launch.mesh.spawn``
    (``MESH_WORLDS``): one rank under NCCL (a real communicator of one), and
    four ranks under gloo on CUDA tensors (collectives staged through host
    tensors) with a ``(4,)`` mesh (nd 4) and a ``(2, 2)`` mesh with
    ``Layout(axis="model")`` (nd 2).  ``lu_factor``/``gesv`` and
    ``cholesky_factor``/``posv`` at n = 8192, b = 128 and
    ``qr_factor``/``gels`` at 16384 x 4096, float64 and float32, under
    ``mtb``/``la``/``la2``: factors (pivots included) and solutions bitwise
    the single-device port's at the same schedule (rank 0 computes those in
    the same world), the same residual gates as phases 4-6; rank 0's wall
    ms beside the single-device ``mtb``'s, the transport, and from one
    traced float64 ``gesv`` a mesh and variant the BCAST count, bytes and
    seconds and, under ``la2``, ``report.overlap``'s ``bcast_hidden_frac``;
    launches by kernel on rank 0.  In the parent, the GEMM and TRSM kernels
    held column-decomposable, bitwise, at the mesh's local widths.
15d. ``qr_bucket_tall``: ``gels`` 4324 x 100 (4 right-hand sides, seed 88,
    block 128) in its 8192 x 128 bucket, bitwise the raw shape's answer,
    with both QR panel plans.
15e. ``train_grad``: the gradient routes of the two kernels
    (``FlashAttentionFn``, ``Wkv6Fn``) at small shapes, float32 and
    bfloat16 (the kernels' dtypes): the gradients of q, k, v and of r, k,
    v, log w, u, s0 bitwise autograd through the plain formulation on the
    same inputs and output gradients, the forwards within ``attn_expect``
    and ``wkv6_expect``, one launch a forward and none in the backward;
    at the train step's shapes (bfloat16) the kernel's forward ms, the
    Function's forward + backward ms and the plain forward's.
15f. ``train``: phi3-medium-14b and rwkv6-7b at full width, depth cut to
    4 (``TRAIN_LAYERS``), bfloat16, seeded random weights, batches of
    4 x 1024 tokens of ``SyntheticTask(noise=0)`` over the first 512
    tokens (``TRAIN_TASK_VOCAB``; the loss over the whole vocabulary):
    phi3 8 AdamW steps,
    rwkv6 8 AdamW steps and 10 DMF-Shampoo steps, and 10 DMF-Shampoo
    steps at depth 1, where the 4096-wide weights are 2-D and
    preconditioned (9 leaves; none at depth 4, whose stacked weights take
    Adam, as in the reference).  Gates: every loss finite, the mean of
    the last two below the first, the kernel launched layers x (forward +
    remat recompute) times a step and no other kernel.  Records step ms
    (p50), tokens/s, peak memory, the optimizer's ms (Shampoo with and
    without a refresh) and device ms by kernel of one profiled step.
15g. ``train_resume``: a reduced phi3 (bfloat16) checkpointed at step 4 and
    restored into a fresh ``Trainer``, every leaf bitwise the saved one;
    its next 4 losses within ``RESUME_TOL`` of the uninterrupted run's.
15h. ``shampoo_seed``: ``cholesky_norm_seed`` (the look-ahead Cholesky at
    block 32, float32) of a 4096 x 4096 Gram matrix, bracketing
    ``torch.linalg.matrix_norm(A, 2)`` (seed ≤ 1.001·‖A‖₂ ≤ 1.001·n·seed),
    the Cholesky kernels launched; beside it the damped statistic of the
    depth-1 Shampoo run (recorded) and ``torch.linalg.cholesky``'s ms.

Launch counts are set to 0 just before each path and read just after it;
each kernel of a path must have launched in it (``flash_attention`` and
``wkv6_fused`` on their serving paths and in every train step, the others
on the factorization paths).

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
import tempfile
import time
from pathlib import Path

N, BLOCK, NRHS = 8192, 128, 16   # the main path (and gehrd's n)
WIDE_BLOCK = 384                 # gesv / posv with a block wider than 256
QR_M, QR_N = 16384, 4096         # the gels paths: a tall 4:1 system
QR_RTM = (4096, 1024)            # rtm's launches grow as panels x tiles
QR_WIDE = (1024, 2048)           # wide QR: the row-exhaustion stop
RTM_N = 2048                     # rtm's per-tile launches grow as (n/b)^3
SMALL_N = 128                    # one panel: the fused small solve
QR_STREAMED_M = 65536            # a QR panel too tall for the SMs' shared memory
EIG_N = 512                      # gehrd + eigvals of a symmetric input
COND_N = 2048                    # gecon and getri
BAND_W = 128                     # band reduction's output bandwidth
SV_N = 2048                      # band reduction against svdvals
NEW_REPS = 3                     # timed calls of each variant in 9a-9c
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
#: a part of each serving kernel's device symbol, to find it in a profile
KERNEL_SYMBOLS = {"flash_attention": "flash_", "wkv6_fused": "wkv6_tile"}
RESIDUAL_LIMIT = 100.0
TILE_BLOCKS = (256, 512)         # 9d: tiled Cholesky's tiles at n = N
TILE_QR_BLOCK = 256              # 9d: tiled QR's tiles at QR_M x QR_N
SINGLE_TILE = (512, 256)         # 9d: one tile covering the matrix
TUNE_BLOCKS = (96, 128, 192, 256, 384)   # 9e: the LU and Cholesky sweeps
BATCH_B, BATCH_N, BATCH_BLOCK = 64, 256, 32   # 15a: the batched drivers
#: 15b, mix A: the reference's server traffic (its bench_serve_solver MIX):
#: (dmf, m, n, (nrhs low, high), weight)
SERVER_MIX_A = (("gesv", 48, 48, (2, 2), 4), ("gesv", 33, 33, (1, 1), 3),
                ("gesv", 64, 64, (4, 4), 3), ("posv", 40, 40, (2, 2), 2),
                ("gels", 56, 30, (2, 2), 2), ("geqp3", 80, 17, (1, 1), 1))
#: mix B: the larger systems of per-head whitening and per-expert normal
#: equations, each kind alike, 1 to 16 right-hand sides
SERVER_MIX_B = tuple((dmf, m, n, (1, 16), 1) for dmf, m, n in (
    ("gesv", 100, 100), ("gesv", 250, 250), ("gesv", 500, 500),
    ("gesv", 1000, 1000), ("posv", 128, 128), ("posv", 384, 384),
    ("posv", 768, 768), ("gels", 1500, 120), ("gels", 3000, 250),
    ("geqp3", 1000, 100)))
MIX_A_REQUESTS, MIX_B_REQUESTS = 512, 128
CACHE_MATRICES, CACHE_ROUNDS = 64, 4   # mix A's factor-once/solve-many round
NAIVE_CALLS = 200                 # the one-at-a-time gesv baseline at n 48
#: 15c: the mesh worlds, (ranks, meshes: (name, shape, dimension names,
#: the Layout's axis or None)); the backend follows from the layout
#: (``launch.mesh.world_backend``: NCCL for one rank on the card, gloo for
#: four ranks sharing it)
MESH_WORLDS = ((1, (("d1", (1,), ("model",), None),)),
               (4, (("d4", (4,), ("model",), None),
                    ("d2", (2, 2), ("data", "model"), "model"))))
MESH_VARIANTS = ("mtb", "la", "la2")
#: 15d: the tall gels bucket of the QR panel's dealt chunks
TALL_GELS = (4324, 100, 4, 88)    # m, n, right-hand sides, seed
#: 15e: the Functions' gradient checks: flash (B, H, S, D) over 2 KV heads,
#: WKV6 (B, H, S, D) from a state
TRAIN_GRAD_ATTN = (2, 8, 256, 64)
TRAIN_GRAD_WKV = (2, 4, 200, 64)
#: 15f: the train phase, full width at depth TRAIN_LAYERS (the whole
#: model's weights, gradients and AdamW moments do not fit one card):
#: batches of TRAIN_B x TRAIN_S tokens, TRAIN_STEPS AdamW steps (a warm-up
#: of 2 to TRAIN_LR, then a cosine), SHAMPOO_STEPS DMF-Shampoo steps (one
#: refresh round of 10)
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 4, 4, 1024
TRAIN_STEPS, SHAMPOO_STEPS, TRAIN_LR = 8, 10, 1e-3
#: The synthetic task's tokens are drawn below TRAIN_TASK_VOCAB; every loss
#: still runs over the model's whole vocabulary.  Drawn from all 65536 or
#: 100352 tokens, a batch of 4096 sees most tokens once, so no run of a
#: few steps can learn the next-token map and the loss moves within the
#: batch-to-batch noise (rwkv6-7b, 8 AdamW steps: 11.47 first, 11.61
#: last); over 512 tokens the map is seen many times a batch and the loss
#: falls within the phase.
TRAIN_TASK_VOCAB = 512
#: 15g: the resumed steps' losses against the uninterrupted run's,
#: relative.  The restored state is bitwise the saved one, so the first
#: resumed step repeats the uninterrupted one's forward; after it, the
#: embedding backward's atomic adds (index_put with accumulate) sum each
#: token's rows in another order, which moves a bfloat16 gradient by an
#: ulp here and there, and the loss by far less than 1e-3 in three steps.
RESUME_S, RESUME_TOL = 256, 1e-3


def _mesh_job(rank, cfg):
    """One rank of a 15c mesh world: every rank runs every mesh call; rank
    0 also runs the single-device port at the same schedule and compares.
    Returns rank 0's records and its launches on the mesh calls."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.core.backend import no_tf32
    from repro_torch.kernels import ops
    from repro_torch.obs import report, tracer
    from repro_torch.solve import cholesky_factor, lu_factor, qr_factor

    no_tf32()
    dev = torch.device("cuda", torch.cuda.current_device())
    n, b, nrhs = cfg["n"], cfg["block"], cfg["nrhs"]

    def sync():
        torch.cuda.synchronize(dev)

    def inputs(driver, dtype):
        # the same on every rank: one seeded generator on the card and
        # elementwise ops (a symmetric, diagonally dominant posv input)
        gen = torch.Generator(device=dev).manual_seed(
            cfg["seed"] + ("gesv", "posv", "gels").index(driver))
        shape = cfg["gels"] if driver == "gels" else (n, n)
        a = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        if driver == "posv":
            a = (a + a.mT) / 2
            a.diagonal().add_(float(n))
        rhs = torch.randn(shape[0], nrhs, generator=gen, device=dev,
                          dtype=dtype)
        return a, rhs

    factor = {"gesv": (lu_factor, ("lu", "ipiv", "perm")),
              "posv": (cholesky_factor, ("l",)),
              "gels": (qr_factor, ("packed", "taus"))}

    def gate(driver, a, x, rhs, dtype):
        a64, x64, b64 = a.double(), x.double(), rhs.double()
        if driver == "gels":       # LAPACK's least-squares ratio
            num = float((a64.mT @ (b64 - a64 @ x64)).norm())
            return num / (max(*a.shape, nrhs) * torch.finfo(dtype).eps
                          * float(a64.norm()) * float(b64.norm()))
        num = float((a64 @ x64 - b64).norm())
        return num / (a.shape[0] * torch.finfo(dtype).eps
                      * float(a64.norm()) * float(x64.norm()))

    meshes = [(name, init_device_mesh("cuda", shape, mesh_dim_names=names),
               None if axis is None else D.Layout(axis=axis))
              for name, shape, names, axis in cfg["meshes"]]
    records, launches = [], {}
    # warm-up, not timed or counted: the kernels' libraries and plans, and
    # each mesh's communicators (NCCL builds its own at first use)
    for dtype in (torch.float64, torch.float32):
        for driver, (fn, _) in factor.items():
            g = torch.randn(512 if driver != "gels" else 1024, 512,
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev, dtype=dtype)
            if driver == "posv":
                g = g + g.mT + 512 * torch.eye(512, device=dev, dtype=dtype)
            fn(g, b, variant="la")
            for _, mesh, layout in meshes:
                fn(g, b, variant="la", mesh=mesh, layout=layout)
    sync()
    ops.reset_launches()

    def bank():
        for k, v in ops.launches().items():
            launches[k] = launches.get(k, 0) + v
        ops.reset_launches()

    for dtype in (torch.float64, torch.float32):
        for driver in ("gesv", "posv", "gels"):
            a, rhs = inputs(driver, dtype)
            fn, fields = factor[driver]
            for variant in MESH_VARIANTS:
                single = None
                if rank == 0:
                    sync()
                    t0 = time.perf_counter()
                    single = fn(a, b, variant=variant)
                    xs = single.solve(rhs)
                    sync()
                    single_ms = (time.perf_counter() - t0) * 1e3
                    if variant == "mtb":
                        mtb_ms = single_ms
                for mname, mesh, layout in meshes:
                    ops.reset_launches()
                    sync()
                    t0 = time.perf_counter()
                    fac = fn(a, b, variant=variant, mesh=mesh, layout=layout)
                    x = fac.solve(rhs)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    bank()
                    if rank != 0:
                        continue
                    bits = all(torch.equal(getattr(fac, f), getattr(single, f))
                               for f in fields) and torch.equal(x, xs)
                    check(bits, f"mesh {mname} {driver} {variant} {dtype}: "
                          "not bitwise the single-device port")
                    res = gate(driver, a, x, rhs, dtype)
                    check(res < RESIDUAL_LIMIT, f"mesh {mname} {driver} "
                          f"{variant} {dtype}: residual {res}")
                    axis = D.resolve_axis(mesh, layout)
                    records.append({
                        "mesh": mname, "mesh_shape": list(mesh.shape),
                        "nd": D.axis_size(mesh, axis), "driver": driver,
                        "dtype": str(dtype), "variant": variant,
                        "shape": list(a.shape), "block": b,
                        "transport": D.transport(mesh, axis, dev).name,
                        "wall_ms": ms, "single_ms": single_ms,
                        "single_mtb_ms": mtb_ms, "residual": res,
                        "bitwise_equal_to_single_device": True})
                del single
            del a, rhs
    # one traced float64 gesv a mesh and variant: the BCAST figures
    a, rhs = inputs("gesv", torch.float64)
    traces = []
    for mname, mesh, layout in meshes:
        for variant in MESH_VARIANTS:
            with tracer.trace() as tr:
                lu_factor(a, b, variant=variant, mesh=mesh, layout=layout)
            bank()
            bc = tr.by_cat("BCAST")
            rep = report.overlap(tr.spans)
            traces.append({
                "mesh": mname, "variant": variant,
                "nd": D.axis_size(mesh, D.resolve_axis(mesh, layout)),
                "bcast_count": len(bc),
                "bcast_bytes": sum(sp.meta["bytes"] for sp in bc),
                "bcast_s": rep["bcast_s"],
                "bcast_hidden_frac": rep["bcast_hidden_frac"],
                "pf_s": rep["panel_s"], "update_s": rep["update_s"]})
    return {"rank": rank, "records": records, "traces": traces,
            "launches": launches}


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
    from repro_torch.tune.model import MACHINE

    # the card's peaks, one record for the port (NVIDIA data sheet, H100
    # SXM at 700 W): float64 through the tensor cores and float32 outside
    # them at the same rate, bfloat16 through the tensor cores, HBM3, L2
    PEAK_FLOPS = MACHINE.peak(torch.float64)
    BF16_FLOPS = MACHINE.peak(torch.bfloat16)
    HBM_BYTES_PER_S = MACHINE.hbm_bytes_per_s
    L2_BYTES = MACHINE.l2_bytes
    from repro_torch.core.backend import no_tf32
    from repro_torch.core.cholesky import cholesky_blocked, cholesky_unblocked
    from repro_torch.core.cholesky import cholesky_panel as op_cholesky_panel
    from repro_torch.core import qr
    from repro_torch.core.gauss_jordan import gj_inverse_unblocked
    from repro_torch.core.ldlt import ldlt_panel, ldlt_unblocked
    from repro_torch.core.lookahead import get_variant
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import (_build, attention, blis_gemm, ops,
                                     panel_hessenberg, panel_lu, panel_qr,
                                     panel_qrcp, trsm)
    from repro_torch.kernels import fused_panel_update as fpu
    from repro_torch.kernels import wkv6 as wkv
    from repro_torch.models import api, rwkv6
    from repro_torch import tune
    from repro_torch.core import tiles
    from repro_torch.obs import export, report, tracer
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve import ServerConfig, SolveServer, shape_class
    from repro_torch.solve import (batched, cholesky_factor, gecon, gehrd,
                                   geqp3, gels, gesv, getri, ldlt_factor,
                                   lu_factor, posv, qr_factor)

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

    def wall_ms(fn, reps: int = 5) -> float:
        """Median host ms of a synchronised call of ``fn``."""
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
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
            nb = t.shape[0]
            flops = nrhs * nb * (nb - 1) + (0 if unit else nrhs * nb)
            return dict(
                shape=list(rhs.shape), lower=lower, unit=unit, right=right,
                plan=trsm.plan(nb, nrhs, dtype, right=right),
                bitwise_equal_to_chain=True, rel_err=err, max_abs_err=mx,
                tol=tolerance(dtype, nb), ms=queued_ms(run, 20),
                call_ms=time_ms(run, 20), chain_ms=queued_ms(chain, 5),
                plain_ms=time_ms(plain, 3), library_ms=queued_ms(lib, 20),
                library_call_ms=time_ms(lib, 20),
                bound=bound(flops, (nb * (nb + 1) // 2 + 2 * nb * nrhs)
                            * size))

        lu_t = torch.linalg.lu_factor(randn(BLOCK, BLOCK)).LU.contiguous()
        for key, cols in (("trsm", m), ("trsm_solve", NRHS)):
            rhs = randn(BLOCK, cols)
            res[key] = trsm_row(lu_t, rhs, True, True)
            res[f"{key}_upper"] = trsm_row(lu_t, rhs, False, False)
        del rhs
        # the U12 solve of a block-WIDE_BLOCK factor's first step
        lu_w = torch.linalg.lu_factor(
            randn(WIDE_BLOCK, WIDE_BLOCK)).LU.contiguous()
        res["trsm"]["wide"] = trsm_row(lu_w, randn(WIDE_BLOCK, N - WIDE_BLOCK),
                                       True, True)
        del lu_w

        # GETF2 panel, 8192 x 128 (resident: each block's rows in shared
        # memory), QR_STREAMED_M x 128 (streamed from device memory) and
        # 8192 x WIDE_BLOCK, in place, timed on a fresh copy with the copy's
        # own time subtracted:
        # ms on a busy card (queued_ms), call_ms one call from an idle card,
        # each beside lu_factor on the same metric.  Bitwise equal to its
        # plain version by design: one rounding per product and per
        # difference.  Route, grid and rows a block stay in the record.
        def lu_panel_row(mp, nb=BLOCK):
            pl = panel_lu.plan(mp, nb, dtype)
            panel0 = randn(mp, nb)
            pk, pp = panel0.clone(), panel0.clone()
            piv_k = panel_lu.lu_panel(pk)
            piv_p = panel_lu.lu_panel_plain(pp)
            sync()
            check(torch.equal(piv_k, piv_p), f"lu_panel {dtype} {mp}x{nb}: "
                  "pivots differ")
            check(torch.equal(pk, pp), f"lu_panel {dtype} {mp}x{nb}: "
                  "factors not bitwise equal to the plain version's")
            err, mx = compare(pk, pp)
            work = torch.empty_like(panel0)

            def run():
                return panel_lu.lu_panel(work.copy_(panel0))

            def copy():
                return work.copy_(panel0)

            def lib():
                return torch.linalg.lu_factor(panel0)
            flops = sum((mp - j - 1) * (1 + 2 * (nb - j - 1))
                        for j in range(nb))
            row = dict(
                shape=[mp, nb], route=pl["route"], grid=pl["grid"],
                rows_per_block=pl["chunk"], pivots_equal=True,
                bitwise_equal=True, rel_err=err, max_abs_err=mx, tol=0.0,
                ms=queued_ms(run, 20) - queued_ms(copy, 20),
                call_ms=time_ms(run, 20) - time_ms(copy, 20),
                plain_ms=time_ms(lambda: panel_lu.lu_panel_plain(copy()), 2)
                - time_ms(copy, 10),
                library_ms=queued_ms(lib, 10), library_call_ms=time_ms(lib, 10),
                bound=bound(flops, 2 * mp * nb * size + 4 * nb))
            del panel0, pk, pp, work
            return row

        res["lu_panel"] = lu_panel_row(N)
        check(res["lu_panel"]["route"] == "resident",
              f"lu_panel {dtype}: {N}x{BLOCK} not on the resident route")
        stream_lu = lu_panel_row(QR_STREAMED_M)
        check(stream_lu["route"] == "streamed", f"lu_panel {dtype}: "
              f"{QR_STREAMED_M}x{BLOCK} not on the streamed route")
        res["lu_panel"]["streamed"] = stream_lu
        res["lu_panel"]["wide"] = lu_panel_row(N, WIDE_BLOCK)

        def spd(n):
            g = randn(n, n)
            return g @ g.mT / n + torch.eye(n, dtype=dtype, device=dev)

        # right transposed TRSM: X L^T = B, the Cholesky L21 solve, 8064 x 128
        l_c = torch.linalg.cholesky(spd(BLOCK)).contiguous()
        res["trsm_right_lower_t"] = trsm_row(l_c, randn(m, BLOCK), True,
                                             False, right=True)
        l_w = torch.linalg.cholesky(spd(WIDE_BLOCK)).contiguous()
        res["trsm_right_lower_t"]["wide"] = trsm_row(
            l_w, randn(N - WIDE_BLOCK, WIDE_BLOCK), True, False, right=True)
        del l_w

        def fused_row(name, fused, plain, composed, ops_in, outs, flops,
                      nbytes, tol_k, shape, plan=None, op_composed=None):
            """A fused panel update on fresh copies of its in-place operands
            ``outs`` (indices into ``ops_in``): bitwise against the composed
            kernels it replaces (pivots too), within 4·k·eps of its plain
            version (which rounds each product where the kernels use FMA),
            timed with the copies' own time subtracted: ms on a busy card
            (queued_ms), call_ms one call from an idle card, the composed
            kernels on both metrics.  ``op_composed``: a second composition
            (the Cholesky panel as PyTorch ops and the right TRSM kernel),
            held bitwise too and timed on a busy card."""
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
            copy_ms, copy_busy = time_ms(fresh, 10), queued_ms(fresh, 10)
            row = dict(
                shape=shape, bitwise_equal_to_composed=True,
                pivots_equal=len(got) == 3 or None, rel_err=err,
                max_abs_err=mx, tol=tolerance(dtype, tol_k),
                ms=queued_ms(lambda: fused(*fresh()), 10) - copy_busy,
                call_ms=time_ms(lambda: fused(*fresh()), 10) - copy_ms,
                plain_ms=time_ms(lambda: plain(*fresh()), 3) - copy_ms,
                composed_ms=queued_ms(lambda: composed(*fresh()), 10)
                - copy_busy,
                composed_call_ms=time_ms(lambda: composed(*fresh()), 10)
                - copy_ms,
                library_ms=None, bound=bound(flops, nbytes))
            if plan is not None:
                row.update(route=plan["route"], grid=plan["grid"],
                           rows_per_block=plan["chunk"], plan=plan)
            if op_composed is not None:
                ops_out = [t.clone() for t in
                           _as_tuple(op_composed(*fresh()))]
                sync()
                check(all(torch.equal(x, y) for x, y in zip(got, ops_out)),
                      f"{name} {dtype}: not bitwise equal to the PyTorch-op "
                      "Cholesky panel")
                row.update(bitwise_equal_to_pytorch_ops=True,
                           pytorch_ops_ms=queued_ms(
                               lambda: op_composed(*fresh()), 5) - copy_busy)
            return row

        # the fused panel updates at the first PU of a factor with block bb
        # (L11 bb x bb, L21 (N - bb) x bb): the main path's BLOCK, and
        # WIDE_BLOCK (the LU update's rows streamed, the Cholesky diagonal
        # block past shared memory)
        def composed_lu(l11, l21, a1l, a2l):
            ops.trsm(l11, a1l, lower=True, unit_diagonal=True, out=a1l)
            ops.update(a2l, l21, a1l)
            return a1l, a2l, ops.lu_panel(a2l)

        def fused_lu_row(bb):
            mm = N - bb
            l11 = torch.linalg.lu_factor(randn(bb, bb)).LU.contiguous()
            lu_in = (l11, randn(mm, bb), randn(bb, bb), randn(mm, bb))
            getf2 = sum((mm - j - 1) * (1 + 2 * (bb - j - 1)) for j in range(bb))
            return fused_row(
                "fused_lu_panel_update", fpu.fused_lu_panel_update,
                fpu.fused_lu_panel_update_plain, composed_lu, lu_in, (2, 3),
                bb * (bb - 1) * bb + 2.0 * mm * bb * bb + getf2,
                (bb * (bb + 1) // 2 + mm * bb + 2 * bb * bb + 2 * mm * bb) * size
                + 4 * bb, 2 * bb, [mm, bb, bb], plan=fpu.plan(bb, mm, bb, dtype))

        # the Cholesky PU composed: the GEMM kernel, then the panel (the
        # panel kernel entry; and, held bitwise too, the PyTorch-op panel
        # with the right TRSM kernel, the rounding the reference specifies)
        def fused_chol_row(bb):
            mm = N - bb
            l21 = 0.1 * randn(mm, bb)
            panel_c = 0.1 * randn(mm, bb)
            panel_c[:bb] = l21[:bb] @ l21[:bb].mT + spd(bb)

            def composed_chol(lrow, l21, panel):
                ops.update(panel, l21, lrow.mT.contiguous())
                return ops.cholesky_panel(panel, bb, "cuda")

            def op_composed_chol(lrow, l21, panel):
                ops.update(panel, l21, lrow.mT.contiguous())
                return op_cholesky_panel(panel, bb, "cuda")

            return fused_row(
                "fused_cholesky_panel_update", fpu.fused_cholesky_panel_update,
                fpu.fused_cholesky_panel_update_plain, composed_chol,
                (l21[:bb], l21, panel_c), (2,),
                2.0 * mm * bb * bb + bb ** 3 / 3.0 + float(mm - bb) * bb * bb,
                (bb * bb + 2 * mm * bb + mm * bb) * size, 2 * bb, [mm, bb, bb],
                plan=fpu.cholesky_plan(mm, bb, dtype, b=bb),
                op_composed=op_composed_chol)

        # the Cholesky panel entry (the same kernel with no update terms) on
        # the main path's first panel, N x bb: bitwise the PyTorch-op panel
        # (cholesky_unblocked, then the right TRSM kernel), which is also its
        # composed time; no one PyTorch call computes it.  Its inputs come
        # from a generator of their own, so the other rows' inputs do not
        # depend on it.
        pgen = torch.Generator(device=dev).manual_seed(SEED + 3)

        def chol_panel_row(bb):
            panel0 = 0.1 * torch.randn((N, bb), generator=pgen, device=dev,
                                       dtype=dtype)
            g = torch.randn((bb, bb), generator=pgen, device=dev, dtype=dtype)
            panel0[:bb] = g @ g.mT / bb + torch.eye(bb, dtype=dtype,
                                                     device=dev)
            return fused_row(
                "cholesky_panel", lambda p: fpu.cholesky_panel(p, bb),
                lambda p: fpu.cholesky_panel_plain(p, bb),
                lambda p: op_cholesky_panel(p, bb, "cuda"), (panel0,), (0,),
                bb ** 3 / 3.0 + float(N - bb) * bb * bb, 2 * N * bb * size,
                bb, [N, bb], plan=fpu.cholesky_plan(N, bb, dtype))

        for key, row_of in (("fused_lu_panel_update", fused_lu_row),
                            ("fused_cholesky_panel_update", fused_chol_row),
                            ("cholesky_panel", chol_panel_row)):
            res[key] = row_of(BLOCK)
            res[key]["wide"] = row_of(WIDE_BLOCK)

        # fused small solve: packed 128 x 128 LU, 16 right-hand sides; both
        # sweeps on the TRSM's strip kernel, bitwise the chain pair (unit
        # lower, then upper), timed as the TRSM rows are
        lu_s = torch.linalg.lu_factor(randn(SMALL_N, SMALL_N)).LU.contiguous()
        rhs_s = randn(SMALL_N, NRHS)
        ident = torch.arange(1, SMALL_N + 1, dtype=torch.int32, device=dev)
        sout = torch.empty_like(rhs_s)

        def solve_run():
            return trsm.lu_solve_small(lu_s, rhs_s, out=sout)

        def solve_chain():
            return trsm.trsm_chain(lu_s, trsm.trsm_chain(
                lu_s, rhs_s, lower=True, unit_diagonal=True), lower=False)

        def solve_lib():
            return torch.linalg.lu_solve(lu_s, ident, rhs_s)
        got = solve_run()
        sync()
        check(torch.equal(got, solve_chain()), f"lu_solve_small {dtype}: not "
              "bitwise equal to the unit-lower then upper chain contract")
        err, mx = compare(got, trsm.lu_solve_small_plain(lu_s, rhs_s))
        res["lu_solve_small"] = dict(
            shape=[SMALL_N, NRHS], plan=trsm.plan(SMALL_N, NRHS, dtype),
            bitwise_equal_to_chain=True, rel_err=err, max_abs_err=mx,
            tol=tolerance(dtype, 2 * SMALL_N),   # two sweeps
            ms=queued_ms(solve_run, 20), call_ms=time_ms(solve_run, 20),
            chain_ms=queued_ms(solve_chain, 5),
            plain_ms=time_ms(lambda: trsm.lu_solve_small_plain(lu_s, rhs_s), 3),
            library_ms=queued_ms(solve_lib, 20),
            library_call_ms=time_ms(solve_lib, 20),
            bound=bound(2.0 * SMALL_N * SMALL_N * NRHS,
                        (SMALL_N * SMALL_N + 2 * SMALL_N * NRHS) * size))

        # QR panel (GEQR2 + LARFT) at the gels path's first panel,
        # 16384 x 128, in place, and on the streamed route (QR_STREAMED_M
        # rows, more than the SMs' shared memory holds); its LARFT entry on
        # the same V, whose T must be the panel's bitwise.  The reductions
        # group differently from the plain version's, so the bound is
        # relative, 4·k·eps on packed, tau and T, with k the longest chain
        # of terms the kernel sums in turn for one element (the plan's
        # "chain": a block's rows, a lane's share of the block partials and
        # five shuffle steps, up to BLOCK - 1 terms of the T recurrence).
        # ms on a busy card (queued_ms), call_ms one call from an idle card,
        # each beside geqrf (no T) on the same metric; the in-place panel is
        # timed on a fresh copy, the copy's own time subtracted.
        def qr_row(mq):
            pl = panel_qr.plan(mq, BLOCK, dtype)
            qpanel0 = randn(mq, BLOCK)
            qk, qp = qpanel0.clone(), qpanel0.clone()
            _, tau_k, t_k = panel_qr.qr_panel(qk)
            _, tau_p, t_p = panel_qr.qr_panel_plain(qp)
            again = panel_qr.qr_panel(qpanel0.clone())
            sync()
            check(all(torch.equal(x, y) for x, y in zip(again, (qk, tau_k, t_k))),
                  f"qr_panel {dtype} {mq}x{BLOCK}: not deterministic")
            errs = {what: compare(x, y)[0] for what, x, y in (
                ("packed", qk, qp), ("tau", tau_k, tau_p), ("T", t_k, t_p))}
            v_q = qr.unpack_v(qk, BLOCK)
            t_l = panel_qr.larft(v_q, tau_k)
            sync()
            check(torch.equal(t_l, t_k), f"qr_panel {dtype} {mq}x{BLOCK}: T "
                  "not bitwise the larft entry's on the same V")
            work = torch.empty_like(qpanel0)

            def run():
                return panel_qr.qr_panel(work.copy_(qpanel0))

            def copy():
                return work.copy_(qpanel0)

            def lib():
                return torch.geqrf(qpanel0)
            geqr2 = sum(4.0 * (mq - j) * (BLOCK - j) for j in range(BLOCK))
            gram = float(mq) * BLOCK * (BLOCK - 1) + BLOCK ** 3 / 3.0
            row = dict(
                shape=[mq, BLOCK], route=pl["route"], grid=pl["grid"],
                rows_per_block=pl["rows"], chain=pl["chain"],
                deterministic=True, t_bitwise_larft=True,
                rel_err=max(errs.values()), rel_errs=errs,
                max_abs_err=compare(qk, qp)[1],
                tol=tolerance(dtype, pl["chain"]),
                ms=queued_ms(run, 10) - queued_ms(copy, 10),
                call_ms=time_ms(run, 10) - time_ms(copy, 10),
                plain_ms=time_ms(lambda: panel_qr.qr_panel_plain(copy()), 1)
                - time_ms(copy, 10),
                library_ms=queued_ms(lib, 10), library_call_ms=time_ms(lib, 10),
                bound=bound(geqr2 + gram, (2 * mq * BLOCK + BLOCK * BLOCK
                                           + BLOCK) * size))
            del qpanel0, qk, qp, work, again
            return row, v_q, tau_k, pl, gram

        res["qr_panel"], v_q, tau_k, pl, gram = qr_row(QR_M)
        check(res["qr_panel"]["route"] == "resident",
              f"qr_panel {dtype}: {QR_M}x{BLOCK} not on the resident route")
        t_l = panel_qr.larft(v_q, tau_k)
        sync()
        err, mx = compare(t_l, panel_qr.larft_plain(v_q, tau_k))
        res["larft"] = dict(
            shape=[QR_M, BLOCK], rel_err=err, max_abs_err=mx, grid=pl["grid"],
            chain=pl["chain"], tol=tolerance(dtype, pl["chain"]),
            ms=queued_ms(lambda: panel_qr.larft(v_q, tau_k), 10),
            call_ms=time_ms(lambda: panel_qr.larft(v_q, tau_k), 10),
            plain_ms=time_ms(lambda: panel_qr.larft_plain(v_q, tau_k), 2),
            library_ms=None,
            bound=bound(gram, (QR_M * BLOCK + BLOCK + BLOCK * BLOCK) * size))
        del v_q, t_l
        stream_row = qr_row(QR_STREAMED_M)[0]
        check(stream_row["route"] == "streamed", f"qr_panel {dtype}: "
              f"{QR_STREAMED_M}x{BLOCK} not on the streamed route")
        check(stream_row["rel_err"] <= stream_row["tol"], f"qr_panel {dtype} "
              f"streamed: kernel vs plain rel err {stream_row['rel_err']}")
        res["qr_panel"]["streamed"] = stream_row

        # xLAQPS: the global path's first block (16384 x 4096, 128 steps,
        # streamed from device memory), a qrcp_local window (16384 x 128,
        # its rows resident in the blocks' shared memory) and a window too
        # tall for that (QR_STREAMED_M x 128, streamed), in place; pivots
        # equal to the plain version's, three arrays and tau within 4·c·eps,
        # c the plan's chain (a row's bring-current, a block's column sum,
        # the cross-block sum, the F recurrence); the same bits on a second
        # run.  ms on a busy card (queued_ms), call_ms one call from an idle
        # card, each on a fresh copy with the copy's own time subtracted.
        # The bound counts the per-step pass over the block where it
        # exceeds L2 (one read of an L2-resident window).  No PyTorch call
        # computes it.  Route, grid and chain stay in this phase's record.
        def qrcp_row(rows, cols):
            pl = panel_qrcp.plan(rows, cols, BLOCK, dtype)
            blk0 = randn(rows, cols)
            got = panel_qrcp.qrcp_panel(blk0.clone(), BLOCK)
            again = panel_qrcp.qrcp_panel(blk0.clone(), BLOCK)
            want = panel_qrcp.qrcp_panel_plain(blk0.clone(), BLOCK)
            sync()
            what = f"qrcp_panel {dtype} {rows}x{cols}"
            check(torch.equal(got[4], want[4]),
                  f"{what}: pivots differ from the plain version's")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{what}: not deterministic")
            errs = {what_: compare(x, y)[0] for what_, x, y in zip(
                ("block", "v", "f", "tau"), got[:4], want[:4])}
            max_abs = compare(got[0], want[0])[1]
            del got, again, want
            work = torch.empty_like(blk0)

            def run():
                return panel_qrcp.qrcp_panel(work.copy_(blk0), BLOCK)

            def copy():
                return work.copy_(blk0)
            passes = sum(float(rows - j) * cols for j in range(BLOCK))
            flops = 2.0 * rows * cols + sum(
                2.0 * (rows - j) * (cols + 2 * j) + 4.0 * cols * j
                for j in range(BLOCK))
            row = dict(
                shape=[rows, cols, BLOCK], route=pl["route"], grid=pl["grid"],
                rows_per_block=pl["rows"], owners=pl["owners"],
                chain=pl["chain"], pivots_equal=True, deterministic=True,
                rel_err=max(errs.values()), rel_errs=errs, max_abs_err=max_abs,
                tol=tolerance(dtype, pl["chain"]),
                ms=queued_ms(run, 10) - queued_ms(copy, 10),
                call_ms=time_ms(run, 10) - time_ms(copy, 10),
                plain_ms=time_ms(lambda: panel_qrcp.qrcp_panel_plain(
                    copy(), BLOCK), 1) - time_ms(copy, 10),
                library_ms=None,
                bound=bound(flops, (streamed(passes, rows * cols)
                                    + rows * cols + rows * BLOCK
                                    + cols * BLOCK) * size))
            check(row["rel_err"] <= row["tol"], f"{what}: kernel vs plain rel "
                  f"err {row['rel_err']} >= {row['tol']}")
            del blk0, work
            return row

        qrcp_rows = {key: qrcp_row(rows, cols) for key, rows, cols in (
            ("global", QR_M, QR_N), ("window", QR_M, BLOCK),
            ("streamed", QR_STREAMED_M, BLOCK))}
        for key, route in (("global", "streamed"), ("window", "resident"),
                           ("streamed", "streamed")):
            check(qrcp_rows[key]["route"] == route, f"qrcp_panel {dtype} "
                  f"{key}: {qrcp_rows[key]['route']}, expected {route}")
        res["qrcp_panel"] = {**qrcp_rows["global"],
                             "window": qrcp_rows["window"],
                             "streamed": qrcp_rows["streamed"]}

        # xLAHR2: gehrd's first panel (k = 0) and one from the middle
        # (k = N/2) of an N x N matrix, and the first panel of the rtm
        # path's RTM_N x RTM_N matrix (L2-resident in both dtypes), in
        # place.  Arrays within 4·c·eps of the plain version, c the plan's
        # chain (the two updates, the sums of Vᵀcol and of the norm, Tᵀu
        # and the GEMV that one element of W runs through); the same bits
        # on a second run.  ms on a busy card (queued_ms), call_ms one call
        # from an idle card.  The bound counts each column's GEMV pass over
        # columns kj+1.. of every row where the matrix exceeds L2 (one read
        # of it where it fits), the panel read and written, and V and W
        # written.  No PyTorch call computes it.  Grid, what each block
        # keeps in shared memory and the chain stay in this phase's record.
        hess_rows = {}
        for nh, k0 in ((N, 0), (N, N // 2), (RTM_N, 0)):
            pl = panel_hessenberg.plan(nh, k0, BLOCK, dtype)
            a0 = randn(nh, nh)
            got = panel_hessenberg.hessenberg_panel(a0.clone(), k0, BLOCK)
            again = panel_hessenberg.hessenberg_panel(a0.clone(), k0, BLOCK)
            want = panel_hessenberg.hessenberg_panel_plain(a0.clone(), k0,
                                                           BLOCK)
            sync()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"hessenberg_panel {dtype} n={nh} k={k0}: not "
                  "deterministic")
            cmp = [compare(x, y) for x, y in zip(got, want)]
            errs = dict(zip(("a", "v", "t", "w", "tau"), (c[0] for c in cmp)))
            del got, again, want
            work = torch.empty_like(a0)

            def run():
                return panel_hessenberg.hessenberg_panel(work.copy_(a0), k0,
                                                         BLOCK)

            def copy():
                return work.copy_(a0)
            passes = sum(float(nh) * (nh - k0 - j - 1) for j in range(BLOCK))
            hess_rows[nh, k0] = dict(
                shape=[nh, nh, BLOCK], k=k0, grid=pl["grid"],
                rows_per_block=pl["chunk"], shared=pl["shared"],
                chain=pl["chain"], deterministic=True,
                rel_err=max(errs.values()), rel_errs=errs,
                max_abs_err=max(c[1] for c in cmp),
                tol=tolerance(dtype, pl["chain"]),
                ms=queued_ms(run, 5) - queued_ms(copy, 5),
                call_ms=time_ms(run, 5) - time_ms(copy, 5),
                plain_ms=time_ms(
                    lambda: panel_hessenberg.hessenberg_panel_plain(
                        copy(), k0, BLOCK), 1) - time_ms(copy, 5),
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
            for rr in (r, r.get("wide", r)):
                check(rr["rel_err"] <= rr["tol"],
                      f"{name} {dtype} {rr['shape']}: kernel vs plain rel err "
                      f"{rr['rel_err']} >= {rr['tol']}")
        rows[str(dtype).replace("torch.", "")] = res
        emit({"phase": "kernels", "dtype": str(dtype), "results": res})

    # ---- 4. the main path through the entry points -------------------------
    def emit_trace(path, variant, dtype, run, n=N):
        """PF/TU/PU/SWAP/EPI shares of one traced factor (spans fenced)."""
        with tracer.trace() as tr:
            run()
        cats = tuple(c for c in tracer.CATEGORIES if c != "drive")
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
    small = {}   # dtype -> the n = 128 operands and residual
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

        # a block wider than 256 (the TRSM's x tile sized to it, the fused
        # PU on the streamed route): every variant bitwise mtb
        base = None
        for variant in ("mtb", "rtm", "la", "la2", "la_mb"):
            sync()
            t0 = time.perf_counter()
            fac = lu_factor(a, WIDE_BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            res = scaled_residual(a, fac.solve(b), b, dtype)
            check(res < RESIDUAL_LIMIT, f"gesv {variant} block {WIDE_BLOCK} "
                  f"{dtype}: residual {res}")
            if base is None:
                base = fac
            else:
                check(torch.equal(fac.lu, base.lu)
                      and torch.equal(fac.ipiv, base.ipiv),
                      f"{variant} block {WIDE_BLOCK} {dtype}: factors differ "
                      "from mtb's")
            emit({"phase": "gesv", "dtype": str(dtype), "n": N,
                  "block": WIDE_BLOCK, "variant": variant,
                  "factor_ms": (t1 - t0) * 1e3, "scaled_residual": res,
                  "bitwise_equal_to_mtb": True})
        del base, fac

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
        small[dtype] = (a3.clone(), b3.clone(), res)
        del a, b, a2, b2, a3, b3, f_mtb, f_rtm, x
    counts = ops.launches()
    for name in ("gemm_accum", "trsm", "lu_panel", "lu_solve_small",
                 "fused_lu_panel_update"):
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "gesv path")
    # n = 128 timed after the path's counts are read: these launches are
    # not the path's
    for dtype, (a3, b3, res) in small.items():
        emit({"phase": "gesv", "dtype": str(dtype), "n": SMALL_N,
              "block": SMALL_N, "variant": "la", "scaled_residual": res,
              "small_solve": True,
              "gesv_ms": wall_ms(lambda: gesv(a3, b3, SMALL_N)),
              "cusolver_ms": wall_ms(lambda: torch.linalg.solve(a3, b3))})
    del small, a3, b3

    # ---- 5. posv: Cholesky on a symmetric positive-definite input ----------
    def bank(into):
        """Add the launches since the last reset to ``into``; reset."""
        for k, v in ops.launches().items():
            into[k] = into.get(k, 0) + v
        ops.reset_launches()

    chol_flops = N ** 3 / 3.0
    counts_posv = {}      # the posv path's launches
    counts_op_panel = {}  # mtb with the PyTorch-op panel: a path of its own
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

        # mtb with the PF composed of PyTorch ops and the right TRSM kernel
        # (the default before the panel kernel; a user's panel_fn=): the
        # same factor, and its time beside the kernel's in this run; its
        # launches counted in a window of their own
        bank(counts_posv)
        sync()
        t0 = time.perf_counter()
        l_ops = cholesky_blocked(a, BLOCK, panel_fn=op_cholesky_panel)
        sync()
        t1 = time.perf_counter()
        bank(counts_op_panel)
        check(torch.equal(l_ops, base.l), f"posv mtb {dtype}: the PyTorch-op "
              "panel's factor differs from the panel kernel's")
        emit({"phase": "posv", "dtype": str(dtype), "n": N, "block": BLOCK,
              "variant": "mtb", "panel": "pytorch_ops",
              "factor_ms": (t1 - t0) * 1e3,
              "factor_gflops": chol_flops / (t1 - t0) / 1e9,
              "bitwise_equal_to_mtb": True})
        del l_ops

        # a block wider than 256 (POTF2 in device memory past 128
        # columns): every variant bitwise mtb
        wide = None
        for variant in ("mtb", "rtm", "la", "la2", "la_mb"):
            sync()
            t0 = time.perf_counter()
            fac = cholesky_factor(a, WIDE_BLOCK, variant=variant)
            sync()
            t1 = time.perf_counter()
            res = scaled_residual(a, fac.solve(b), b, dtype)
            check(res < RESIDUAL_LIMIT, f"posv {variant} block {WIDE_BLOCK} "
                  f"{dtype}: residual {res}")
            if wide is None:
                wide = fac
            else:
                check(torch.equal(fac.l, wide.l), f"posv {variant} block "
                      f"{WIDE_BLOCK} {dtype}: factor differs from mtb's")
            emit({"phase": "posv", "dtype": str(dtype), "n": N,
                  "block": WIDE_BLOCK, "variant": variant,
                  "factor_ms": (t1 - t0) * 1e3, "scaled_residual": res,
                  "bitwise_equal_to_mtb": True})
        del wide, fac

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
        # (these timing launches are not the path's)
        bank(counts_posv)
        blk = a[:BLOCK, :BLOCK].clone()
        unb_ms = time_ms(lambda: cholesky_unblocked(blk.copy_(a[:BLOCK,
                                                                 :BLOCK])), 5)
        # and the panel kernel on the factor's first panel, which replaces it
        # and the right TRSM (one call from an idle card, the copy's time
        # subtracted)
        col0 = a[:, :BLOCK].contiguous()
        work = torch.empty_like(col0)
        entry_ms = (time_ms(lambda: ops.cholesky_panel(work.copy_(col0), BLOCK),
                            10) - time_ms(lambda: work.copy_(col0), 10))
        emit({"phase": "cholesky_unblocked", "dtype": str(dtype),
              "block": BLOCK, "ms_per_call": unb_ms, "calls_per_factor": npanels,
              "ms_per_factor": unb_ms * npanels,
              "panel_kernel_ms_per_call": entry_ms,
              "panel_kernel_shape": [N, BLOCK]})
        del blk, col0, work
        ops.reset_launches()
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
    bank(counts_posv)
    for name in ("gemm_accum", "trsm", "cholesky_panel",
                 "fused_cholesky_panel_update"):
        check(counts_posv[name] > 0, f"kernel {name} was not launched on the "
              "posv path")
    check(counts_op_panel["trsm_right_lower_t"] > 0, "kernel "
          "trsm_right_lower_t was not launched on posv's PyTorch-op panel path")
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

    # ---- 9a. ldlt: unpivoted LDLᵀ of a symmetric quasi-definite input -----
    def one_norm(x):
        return float(torch.linalg.matrix_norm(x.double(), 1))

    new_paths = {"ldlt": {}, "getri_gj": {}, "band_reduction": {}}
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        g = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        a = (g + g.mT) / 2
        del g
        # every third diagonal entry -2n, the others +2n: the sign pattern
        # of the reference's quasi-definite conformance input
        signs = torch.ones(N, dtype=dtype, device=dev)
        signs[::3] = -1.0
        a.diagonal().add_(signs * (2.0 * N))
        b = torch.randn(N, NRHS, generator=gen, device=dev, dtype=dtype)
        eps = torch.finfo(dtype).eps
        base = None
        for variant in ("mtb", "la", "la2", "la_mb"):
            factor_ms, solve_ms = [], []
            for rep in range(NEW_REPS):
                sync()
                t0 = time.perf_counter()
                fac = ldlt_factor(a, BLOCK, variant=variant)
                sync()
                t1 = time.perf_counter()
                x = fac.solve(b)
                sync()
                t2 = time.perf_counter()
                factor_ms.append((t1 - t0) * 1e3)
                solve_ms.append((t2 - t1) * 1e3)
                if base is None:
                    base = fac
                else:
                    check(torch.equal(fac.packed, base.packed),
                          f"ldlt {variant} {dtype} call {rep}: factor "
                          "differs from mtb's")
            res = scaled_residual(a, x, b, dtype)
            check(res < RESIDUAL_LIMIT, f"ldlt {variant} {dtype}: residual "
                  f"{res}")
            extra = {}
            if variant == "mtb":
                l = torch.tril(base.packed.double(), -1)
                l.diagonal().fill_(1.0)
                d = torch.diagonal(base.packed).double()
                recon = one_norm(a.double() - (l * d) @ l.mT) / (
                    one_norm(a) * N * eps)
                del l
                negative = int((d < 0).sum())
                check(recon < RESIDUAL_LIMIT, f"ldlt {dtype}: ‖A − LDLᵀ‖₁/"
                      f"(‖A‖₁·n·eps) {recon}")
                check(0 < negative < N, f"ldlt {dtype}: D has {negative} "
                      "negative entries, expected both signs")
                extra = {"reconstruction": recon, "negative_d": negative}
            fms = statistics.median(factor_ms)
            emit({"phase": "ldlt", "dtype": str(dtype), "n": N,
                  "block": BLOCK, "nrhs": NRHS, "variant": variant,
                  "factor_ms": fms, "factor_ms_calls": factor_ms,
                  "solve_ms": statistics.median(solve_ms),
                  "factor_gflops": chol_flops / fms * 1e3 / 1e9,
                  "scaled_residual": res, "bitwise_equal_to_mtb": True,
                  **extra})
        del fac, x, base

        # the library yardstick: cuSOLVER's Bunch–Kaufman sytrf + sytrs, the
        # same n³/3 flops but pivoted (another function), warmed up
        no_tf32()
        torch.linalg.ldl_solve(*torch.linalg.ldl_factor(a), b)
        factor_ms, solve_ms = [], []
        for _ in range(NEW_REPS):
            sync()
            t0 = time.perf_counter()
            ld, piv = torch.linalg.ldl_factor(a)
            sync()
            t1 = time.perf_counter()
            x = torch.linalg.ldl_solve(ld, piv, b)
            sync()
            t2 = time.perf_counter()
            factor_ms.append((t1 - t0) * 1e3)
            solve_ms.append((t2 - t1) * 1e3)
        fms = statistics.median(factor_ms)
        emit({"phase": "ldlt_library", "dtype": str(dtype), "n": N,
              "call": "torch.linalg.ldl_factor + ldl_solve (Bunch-Kaufman, "
                      "pivoted)",
              "factor_ms": fms, "factor_ms_calls": factor_ms,
              "solve_ms": statistics.median(solve_ms),
              "factor_gflops": chol_flops / fms * 1e3 / 1e9,
              "scaled_residual": scaled_residual(a, x, b, dtype)})
        del ld, piv, x

        # the PF's diagonal sweep (PyTorch ops, once a panel) beside the
        # kernel time of the rest of the PF (the unit right TRSM and the
        # division by D) on the factor's first panel; these timing launches
        # are not the path's
        bank(new_paths["ldlt"])
        blk0 = a[:BLOCK, :BLOCK].clone()
        blk = torch.empty_like(blk0)
        sweep_ms = time_ms(lambda: ldlt_unblocked(blk.copy_(blk0)), 5)
        col0 = a[:, :BLOCK].contiguous()
        fac0 = ldlt_unblocked(blk0.clone())
        below0 = col0[BLOCK:].clone()
        below = torch.empty_like(below0)

        def rest():
            ops.trsm(fac0, below.copy_(below0), side="right", lower=True,
                     trans=True, unit_diagonal=True, out=below)
            return below.div_(torch.diagonal(fac0)[None, :])

        rest_ms = (time_ms(rest, 10)
                   - time_ms(lambda: below.copy_(below0), 10))
        work = torch.empty_like(col0)
        panel_ms = time_ms(lambda: ldlt_panel(work.copy_(col0), BLOCK), 5)
        emit({"phase": "ldlt_panel", "dtype": str(dtype), "block": BLOCK,
              "shape": [N, BLOCK], "sweep_ms_per_call": sweep_ms,
              "rest_kernel_ms": rest_ms, "panel_ms": panel_ms,
              "calls_per_factor": npanels,
              "sweep_ms_per_factor": sweep_ms * npanels})
        del blk0, blk, col0, fac0, below0, below, work
        ops.reset_launches()
        emit_trace("ldlt", "la", dtype,
                   lambda: ldlt_factor(a, BLOCK, variant="la"))
        del a, b
    bank(new_paths["ldlt"])
    for name in ("trsm_right_lower_t", "gemm_accum", "trsm"):
        check(new_paths["ldlt"].get(name, 0) > 0, f"kernel {name} was not "
              "launched on the ldlt path")

    # ---- 9b. getri(method="gj"): Gauss–Jordan inversion of an SPD input --
    gj_flops = 2.0 * N ** 3
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        g = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        a = torch.matmul(g, g.mT)
        del g
        a.diagonal().add_(float(N))
        eps = torch.finfo(dtype).eps
        eye = torch.eye(N, dtype=torch.float64, device=dev)

        def inv_residual(x, a=a, left=False):
            """‖A·X − I‖₁ (or ‖X·A − I‖₁) / (‖A‖₁·‖X‖₁·n·eps)."""
            ax = x.double() @ a.double() if left else a.double() @ x.double()
            return one_norm(ax - eye) / (one_norm(a) * one_norm(x) * N * eps)

        base = None
        for variant in ("mtb", "la", "la2"):
            inverse_ms = []
            for rep in range(NEW_REPS):
                sync()
                t0 = time.perf_counter()
                x = getri(a, BLOCK, variant=variant, method="gj")
                sync()
                inverse_ms.append((time.perf_counter() - t0) * 1e3)
                if base is None:
                    base = x
                else:
                    check(torch.equal(x, base), f"getri gj {variant} {dtype} "
                          f"call {rep}: inverse differs from mtb's")
            extra = {}
            if variant == "mtb":
                resid = inv_residual(base)
                check(resid < RESIDUAL_LIMIT, f"getri gj {dtype}: residual "
                      f"{resid}")
                extra = {"scaled_residual": resid,
                         "left_scaled_residual": inv_residual(base,
                                                              left=True)}
            ims = statistics.median(inverse_ms)
            emit({"phase": "getri_gj", "dtype": str(dtype), "n": N,
                  "block": BLOCK, "variant": variant, "inverse_ms": ims,
                  "inverse_ms_calls": inverse_ms,
                  "gflops": gj_flops / ims * 1e3 / 1e9,
                  "bitwise_equal_to_mtb": True, **extra})
        del x, base
        # torch.linalg.inv (cuSOLVER getrf + getrs on I), warmed up
        torch.linalg.inv(a)
        inverse_ms = []
        for _ in range(NEW_REPS):
            sync()
            t0 = time.perf_counter()
            xi = torch.linalg.inv(a)
            sync()
            inverse_ms.append((time.perf_counter() - t0) * 1e3)
        ims = statistics.median(inverse_ms)
        emit({"phase": "getri_gj_library", "dtype": str(dtype), "n": N,
              "call": "torch.linalg.inv", "inverse_ms": ims,
              "inverse_ms_calls": inverse_ms,
              "gflops": gj_flops / ims * 1e3 / 1e9,
              "scaled_residual": inv_residual(xi),
              "left_scaled_residual": inv_residual(xi, left=True)})
        del xi
        # Witnesses of the gap to inv's residual.  The blocked sweep forms
        # the panel's own rows as A[kr, :] − (I − D⁻¹)·A[kr, :], so their
        # rounding scales with |A[kr, :]|, about |D| times the result's:
        # the same residual from the library GEMMs (backend "torch") and
        # from the reference's formulation, and a small one on A/(2n),
        # whose diagonal is of order 1.
        x = getri(a, BLOCK, method="gj", backend="torch")
        torch_resid = inv_residual(x)
        a_unit = a / (2.0 * N)
        x = getri(a_unit, BLOCK, method="gj")
        unit_resid = inv_residual(x, a=a_unit)
        emit({"phase": "getri_gj_witness", "dtype": str(dtype), "n": N,
              "torch_backend_scaled_residual": torch_resid,
              "unit_scale_scaled_residual": unit_resid,
              "unit_scale_inv_scaled_residual": inv_residual(
                  torch.linalg.inv(a_unit), a=a_unit)})
        del x, a_unit

        # the PF's diagonal-block inverse (PyTorch ops, once a panel) beside
        # the kernel time of the rest of the PF, M's β = 0 GEMM
        bank(new_paths["getri_gj"])
        blk0 = a[:BLOCK, :BLOCK].clone()
        blk = torch.empty_like(blk0)
        inv_ms = time_ms(lambda: gj_inverse_unblocked(blk.copy_(blk0)), 5)
        dinv = gj_inverse_unblocked(blk0.clone())
        p = a[:, :BLOCK].clone()
        p[:BLOCK].diagonal().sub_(1.0)
        m_out = torch.empty_like(p)
        gemm_ms = time_ms(lambda: blis_gemm.gemm(p, dinv, out=m_out), 10)
        emit({"phase": "gj_panel", "dtype": str(dtype), "block": BLOCK,
              "shape": [N, BLOCK], "inverse_ms_per_call": inv_ms,
              "gemm_kernel_ms": gemm_ms, "calls_per_factor": npanels,
              "inverse_ms_per_factor": inv_ms * npanels})
        del blk0, blk, dinv, p, m_out
        ops.reset_launches()
        emit_trace("getri_gj", "la", dtype, lambda: getri(
            a, BLOCK, variant="la", method="gj"))
        del a, eye
    bank(new_paths["getri_gj"])
    check(new_paths["getri_gj"].get("gemm_accum", 0) > 0,
          "kernel gemm_accum was not launched on the getri_gj path")

    # ---- 9c. band_reduction: two-sided reduction to band form, w 128 ------
    band_flops = 8.0 * N ** 3 / 3.0
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 10)
        a = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        eps = torch.finfo(dtype).eps
        base = None
        for variant in ("mtb", "la"):
            reduce_ms = []
            for rep in range(NEW_REPS):
                sync()
                t0 = time.perf_counter()
                band = get_variant("band_reduction", variant)(a, BAND_W)
                sync()
                reduce_ms.append((time.perf_counter() - t0) * 1e3)
                if base is None:
                    base = band
                else:
                    check(torch.equal(band, base), f"band_reduction "
                          f"{variant} {dtype} call {rep}: band differs from "
                          "mtb's")
            extra = {}
            if variant == "mtb":
                check(not bool(torch.tril(base, -1).any())
                      and not bool(torch.triu(base, BAND_W + 1).any()),
                      f"band_reduction {dtype}: an element outside the band "
                      "is not 0")
                gap = abs(fro(base) - fro(a)) / (fro(a) * N * eps)
                check(gap < RESIDUAL_LIMIT, f"band_reduction {dtype}: "
                      f"| ‖B‖_F − ‖A‖_F | / (‖A‖_F·n·eps) {gap}")
                extra = {"outside_band_zero": True, "frobenius_gap": gap}
            rms = statistics.median(reduce_ms)
            emit({"phase": "band_reduction", "dtype": str(dtype), "n": N,
                  "w": BAND_W, "variant": variant, "reduce_ms": rms,
                  "reduce_ms_calls": reduce_ms,
                  "gflops": band_flops / rms * 1e3 / 1e9,
                  "bitwise_equal_to_mtb": True, **extra})
        del band, base
        # the singular values at SV_N (an n = 8192 SVD costs too much time)
        # against torch.linalg.svdvals, both in float64: max|Δσ| / σ_max
        # under 100·n·eps of the input dtype.  The bound of the reference's
        # _check_band_reduction, 200·max(n, 8)·eps·‖A‖_F, is recorded beside
        # it; in float32 at this n it exceeds σ_max, so it gates nothing.
        a2 = a[:SV_N, :SV_N].contiguous()
        band2 = get_variant("band_reduction", "la")(a2, BAND_W)
        sv_ref = torch.linalg.svdvals(a2.double())
        sv_err = float((torch.linalg.svdvals(band2.double())
                        - sv_ref).abs().max())
        sv_max = float(sv_ref[0])
        sv_rel = sv_err / sv_max
        sv_limit = RESIDUAL_LIMIT * SV_N * eps
        check(sv_rel < sv_limit, f"band_reduction {dtype}: singular values "
              f"max|Δσ|/σ_max {sv_rel} from svdvals, limit {sv_limit}")
        emit({"phase": "band_reduction_svdvals", "dtype": str(dtype),
              "n": SV_N, "w": BAND_W, "max_abs_err": sv_err,
              "sigma_max": sv_max, "rel_err": sv_rel, "limit": sv_limit,
              "reference_bound": 200.0 * SV_N * eps * fro(a2)})
        del a2, band2
        emit_trace("band_reduction", "la", dtype,
                   lambda: get_variant("band_reduction", "la")(a, BAND_W))
        del a
    bank(new_paths["band_reduction"])
    for name in ("qr_panel", "gemm_accum"):
        check(new_paths["band_reduction"].get(name, 0) > 0, f"kernel {name} "
              "was not launched on the band_reduction path")
    # ---- 9d. the tile-DAG backend: tiled Cholesky and QR -----------------
    # one task at a time on one stream, as the reference's executor runs
    # them: each task's kernels are the ported ones (the Cholesky panel, the
    # right TRSM and the GEMM; the QR panel and the GEMM)
    def tile_record(run):
        """tile_dag of one traced run, and its launches by kernel."""
        bank(new_paths["tiled"])
        with tracer.trace() as tr:
            run()
        launched = {k: v for k, v in ops.launches().items() if v}
        bank(new_paths["tiled"])
        rep = report.tile_dag(tr.spans)
        return {"tasks": rep["n_tasks"], "waves": rep["n_waves"],
                "widest_wave": rep["max_wave_width"],
                "ideal_speedup": rep["ideal_speedup"],
                "serialized_s": rep["serialized_s"],
                "critical_path_s": rep["critical_path_s"],
                "seconds_by_kind": rep["kind_s"],
                "traced_launches": launched}

    def timed_calls(call, bits=_as_tuple, reps=NEW_REPS):
        """``reps`` synchronised calls: (first result, ms of each, the
        tensors ``bits`` picks of every result bitwise the first's)."""
        first, ms, same_bits = None, [], True
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            out = call()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = out
            else:
                same_bits &= all(torch.equal(x, y) for x, y in
                                 zip(bits(first), bits(out)))
        return first, ms, same_bits

    new_paths["tiled"] = {}
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        eps = torch.finfo(dtype).eps
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        g = torch.randn(N, N, generator=gen, device=dev, dtype=dtype)
        a = torch.matmul(g, g.mT) / N
        a.diagonal().add_(1.0)
        del g
        b = torch.randn(N, NRHS, generator=gen, device=dev, dtype=dtype)
        for blk in TILE_BLOCKS:
            l_tiled, tiled_ms, det = timed_calls(
                lambda: cholesky_factor(a, blk, variant="tiled").l)
            check(det, f"tiled cholesky {dtype} b {blk}: two runs differ")
            l_mtb, mtb_ms, _ = timed_calls(
                lambda: cholesky_factor(a, blk, variant="mtb").l)
            l_rtm = cholesky_factor(a, blk, variant="rtm").l
            bitwise = torch.equal(l_tiled, l_rtm)
            dev_rtm = float((l_tiled.double() - l_rtm.double()).abs().max())
            rel_rtm = compare(l_tiled, l_rtm)[0]
            check(bitwise or rel_rtm < 200.0 * N * eps, f"tiled cholesky "
                  f"{dtype} b {blk}: {rel_rtm} from rtm's factor")
            x = cholesky_factor(a, blk, variant="tiled").solve(b)
            res = scaled_residual(a, x, b, dtype)
            check(res < RESIDUAL_LIMIT, f"tiled posv {dtype} b {blk}: "
                  f"residual {res}")
            emit({"phase": "tiled_cholesky", "dtype": str(dtype), "n": N,
                  "block": blk, "tiled_ms": statistics.median(tiled_ms),
                  "tiled_ms_calls": tiled_ms,
                  "mtb_ms": statistics.median(mtb_ms),
                  "mtb_ms_calls": mtb_ms, "bitwise_equal_to_rtm": bitwise,
                  "bitwise_equal_to_mtb": torch.equal(l_tiled, l_mtb),
                  "max_abs_dev_from_rtm": dev_rtm,
                  "rel_dev_from_rtm": rel_rtm, "deterministic": det,
                  "posv_scaled_residual": res,
                  **tile_record(lambda: cholesky_factor(a, blk,
                                                        variant="tiled"))})
            del l_tiled, l_mtb, l_rtm, x
        del a, b

        # tiled QR on the gels shape: ‖QR − A‖, QᵀQ through qr_form_q,
        # the least-squares ratio through TiledQRFactors
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        a = torch.randn(QR_M, QR_N, generator=gen, device=dev, dtype=dtype)
        b = torch.randn(QR_M, NRHS, generator=gen, device=dev, dtype=dtype)
        fac, tiled_ms, det = timed_calls(
            lambda: qr_factor(a, TILE_QR_BLOCK, variant="tiled"),
            bits=lambda f: (f.tqr.r,))
        check(det, f"tiled qr {dtype}: two runs differ")
        twice = qr_factor(a, TILE_QR_BLOCK, variant="tiled")
        det &= all(torch.equal(f1.v, f2.v) and torch.equal(f1.t, f2.t)
                   for f1, f2 in zip(fac.tqr.factors, twice.tqr.factors))
        check(det, f"tiled qr {dtype}: the reflectors of two runs differ")
        del twice
        _, mtb_ms, _ = timed_calls(
            lambda: qr_factor(a, TILE_QR_BLOCK, variant="mtb").packed)
        x = fac.solve(b)
        ratio = ls_ratio(a, x, b, dtype)
        check(ratio < RESIDUAL_LIMIT, f"tiled gels {dtype}: least-squares "
              f"ratio {ratio}")
        r = fac.tqr.r
        check(not bool(torch.tril(r[:QR_N], -1).any()), f"tiled qr {dtype}: "
              "R is not upper triangular")
        q = tiles.qr_form_q(fac.tqr)
        recon = float((q.double() @ r.double() - a.double()).norm()) / (
            float(a.double().norm()) * QR_M * eps)
        orth = float((q.double().mT @ q.double() - torch.eye(
            QR_M, dtype=torch.float64, device=dev)).norm()) / (QR_M * eps)
        del q
        check(recon < RESIDUAL_LIMIT and orth < RESIDUAL_LIMIT,
              f"tiled qr {dtype}: ‖QR − A‖ {recon}, ‖QᵀQ − I‖ {orth} "
              "(units of m·eps)")
        emit({"phase": "tiled_qr", "dtype": str(dtype), "m": QR_M, "n": QR_N,
              "block": TILE_QR_BLOCK, "tiled_ms": statistics.median(tiled_ms),
              "tiled_ms_calls": tiled_ms, "mtb_ms": statistics.median(mtb_ms),
              "mtb_ms_calls": mtb_ms, "reflectors": len(fac.tqr.factors),
              "reconstruction": recon, "orthogonality": orth,
              "ls_ratio": ratio, "deterministic": det,
              **tile_record(lambda: qr_factor(a, TILE_QR_BLOCK,
                                              variant="tiled"))})
        del fac, x, r, a, b
        # one tile covering the matrix is GEQRF: bitwise mtb's packed R
        sm, sn = SINGLE_TILE
        a = torch.randn(sm, sn, generator=gen, device=dev, dtype=dtype)
        one = qr_factor(a, sm, variant="tiled")
        check(len(one.tqr.factors) == 1 and torch.equal(
            one.tqr.r, torch.triu(qr_factor(a, sm, variant="mtb").packed)),
            f"tiled qr {dtype}: one {sm} x {sn} tile is not mtb's R")
        emit({"phase": "tiled_qr_single_tile", "dtype": str(dtype),
              "shape": [sm, sn], "bitwise_equal_to_mtb_r": True})
        del a, one
    bank(new_paths["tiled"])
    for name in ("cholesky_panel", "trsm_right_lower_t", "gemm_accum",
                 "qr_panel"):
        check(new_paths["tiled"].get(name, 0) > 0, f"kernel {name} was not "
              "launched on the tiled path")

    # ---- 9e. the tuner: search in a temporary cache, "tuned" dispatch ----
    def run_search(dmf, **kw):
        sink = []
        t0 = time.perf_counter()
        cfg = tune.search(dmf, N, torch.float64, trace_sink=sink, **kw)
        search_s = time.perf_counter() - t0
        check(not cfg.from_cache, f"tune {dmf}: the first search was cached")
        check(cfg.seconds <= cfg.baseline_seconds, f"tune {dmf}: winner "
              f"{cfg.seconds} s slower than the baseline "
              f"{cfg.baseline_seconds} s")
        rows = [report.attainment_row(dmf, N, t.candidate.variant,
                                      t.candidate.schedule, t.spans,
                                      dtype="float64") for t in sink]
        measured = [{"candidate": t.candidate.label(),
                     "measured_ms": t.measured_s * 1e3,
                     "predicted_ms": (None if t.predicted_s is None
                                      else t.predicted_s * 1e3),
                     "traced_ms": row["measured_s"] * 1e3,
                     "traced_tile_ms": report.tile_dag(t.spans)[
                         "serialized_s"] * 1e3,
                     "attainment": row["attainment"],
                     "overlap_efficiency": t.overlap["overlap_efficiency"]}
                    for t, row in zip(sink, rows)]
        return cfg, search_s, measured, report.format_attainment(rows)

    new_paths["tune"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = tune.TuneCache(Path(tmp) / "tune.json")
        previous = tune.set_default_cache(cache)
        winners = {}
        for dmf, kw in (("lu", {"blocks": TUNE_BLOCKS}),
                        ("cholesky", {"blocks": TUNE_BLOCKS}), ("qr", {})):
            bank(new_paths["tune"])
            cfg, search_s, measured, table = run_search(dmf, **kw)
            # the ranked candidates of the tile-DAG variant
            cands = tune.sweep._candidates(dmf, N, torch.float64,
                                           kw.get("blocks",
                                                  tune.DEFAULT_BLOCKS),
                                           None, ("cuda",))
            ranked = tune.model.rank(dmf, N, torch.float64, cands)
            tiled_ranks = [{"candidate": c.label(), "rank": i,
                            "predicted_ms": tune.model.predict(
                                dmf, N, torch.float64, c.variant,
                                c.schedule) * 1e3}
                           for i, c in enumerate(ranked)
                           if c.variant == "tiled"][:4]
            bank(new_paths["tune"])
            again = tune.search(dmf, N, torch.float64, **kw)
            cached_launches = sum(ops.launches().values())
            check(again.from_cache and cached_launches == 0, f"tune {dmf}: "
                  f"the second search (from_cache {again.from_cache}) "
                  f"launched {cached_launches} kernels")
            winners[dmf] = cfg
            emit({"phase": "tune", "dmf": dmf, "n": N, "dtype": "float64",
                  "candidates": len(cands), "search_s": search_s,
                  "winner": {"variant": cfg.variant,
                             "block": cfg.schedule[0],
                             "schedule_uniform": tune.is_uniform(
                                 cfg.schedule),
                             "seconds": cfg.seconds, "key": tune.cache_key(
                                 dmf, N, torch.float64, cfg.backend)},
                  "baseline_seconds": cfg.baseline_seconds,
                  "speedup_over_baseline": cfg.baseline_seconds
                  / cfg.seconds, "measured": measured,
                  "attainment_table": table.splitlines(),
                  "tiled_ranked": tiled_ranks,
                  "second_search_from_cache": True,
                  "second_search_launches": cached_launches})

        # "tuned" through the drivers: bitwise a direct call of the winner
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        a = torch.randn(N, N, generator=gen, device=dev,
                        dtype=torch.float64)
        b = torch.randn(N, NRHS, generator=gen, device=dev,
                        dtype=torch.float64)
        spd = torch.matmul(a, a.mT) / N
        spd.diagonal().add_(1.0)
        # (the factor is the winner's; the solve keeps the caller's block)
        for name, drv, fac_fn, mat, cfg, fields in (
                ("gesv", gesv, lu_factor, a, winners["lu"], ("lu", "ipiv")),
                ("posv", posv, cholesky_factor, spd, winners["cholesky"],
                 ("l",))):
            got = fac_fn(mat, variant="tuned")
            want = fac_fn(mat, cfg.schedule, variant=cfg.variant)
            check(same(got, want, fields), f"{name} tuned: the factor is not "
                  f"bitwise the winner's, {cfg.variant} / b {cfg.schedule[0]}")
            x = drv(mat, b, variant="tuned")
            check(torch.equal(x, got.solve(b)), f"{name} tuned: the solve "
                  "differs from the tuned factor's")
            res = scaled_residual(mat, x, b, torch.float64)
            check(res < RESIDUAL_LIMIT, f"{name} tuned: residual {res}")
            emit({"phase": "tuned_dispatch", "driver": name, "n": N,
                  "dtype": "float64", "variant": cfg.variant,
                  "block": cfg.schedule[0], "bitwise_equal_to_winner": True,
                  "scaled_residual": res})
        del a, b, spd, x, got, want
        tune.set_default_cache(previous)
    bank(new_paths["tune"])
    check(new_paths["tune"].get("gemm_accum", 0) > 0,
          "kernel gemm_accum was not launched on the tune path")

    # ---- 9f. the trace export: a Chrome trace of one traced gesv ---------
    new_paths["obs_export"] = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(N, N, generator=gen, device=dev, dtype=torch.float64)
    b = torch.randn(N, NRHS, generator=gen, device=dev, dtype=torch.float64)
    with tracer.trace() as tr:
        gesv(a, b, BLOCK, variant="la")
    bank(new_paths["obs_export"])
    with tempfile.TemporaryDirectory() as tmp:
        path = export.write_chrome_trace(str(Path(tmp) / "gesv_la.json"),
                                         tr.spans, label="gesv la")
        with open(path) as f:
            loaded = json.load(f)
    events = loaded["traceEvents"]
    lanes = sorted({e["args"]["name"] for e in events
                    if e["name"] == "thread_name"})
    spans_x = sum(1 for e in events if e["ph"] == "X")
    check(spans_x == len(tr.spans) and {"panel (PF)", "update (TU)",
                                        "drivers"} <= set(lanes),
          f"chrome trace: {spans_x} events of {len(tr.spans)} spans, lanes "
          f"{lanes}")
    emit({"phase": "obs_export", "path": "gesv", "variant": "la", "n": N,
          "dtype": "float64", "events": len(events), "lanes": lanes,
          "overlap": report.overlap(tr.spans),
          "timeline": export.render_timeline(tr.spans).splitlines()})
    del a, b
    emit({"phase": "new_paths_launches", **new_paths})
    counts = {k: counts[k] + sum(p.get(k, 0) for p in new_paths.values())
              for k in counts}
    for name, count in counts.items():
        if name not in SERVING_KERNELS:   # checked on the serving paths
            check(count > 0, f"kernel {name} was not launched on the main "
                  "paths")

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

    def device_busy(fn, top=6, match=()):
        """Wall ms of ``fn`` under ``torch.profiler``, the ms in which the
        card ran a kernel or copy (the union of their intervals) and the
        device time by kernel name (the ``top`` longest), with the summed
        ms of the names containing each string of ``match``; the
        profiler's own host cost lengthens the wall time, so the busy ms
        are the number to read."""
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
        longest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        out = {"wall_ms": wall,
               "busy_ms": busy / 1e3 if spans else None,   # not measured
               "kernels": len(spans),
               "top_ms": {name[:60]: ms for name, ms in longest}}
        if match:
            out["ms_by_match"] = {m: sum(ms for name, ms in by_name.items()
                                         if m in name) for m in match}
        return out

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
            again, s_again = wkv.wkv6_fused(r, k, v, logw, u, s0=s0, chunk=c)
            sync()
            same_bits = bool(torch.equal(again, got)
                             and torch.equal(s_again, sfin))
            del again, s_again
            pl = wkv.plan(bsz, heads, seq, hd, c, dtype)
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
            check(same_bits, f"wkv6_fused {dtype} {key}: a second run gave "
                  "other bits")
            check(min(planted.values()) > 1.0,
                  f"wkv6_fused {dtype} {key}: the tolerance does not catch "
                  f"each planted fault: {planted}")
            res[key] = dict(
                shape=[bsz, heads, seq, hd], chunk=c, s0=s0 is not None,
                max_abs_err=float((got.double() - want).abs().max()),
                err_over_tol=worst, state_err_over_tol=s_worst,
                plain_err_over_tol=plain, split_at=cut,
                split_equals_unsplit=split_equal, same_bits=same_bits,
                planted_err_over_tol=planted,
                clipped_share=clipped,
                plan={key_: pl[key_] for key_ in (
                    "tiles", "grid", "blocks_per_sm", "threads",
                    "workspace_bytes", "flag_words", "smem_bytes",
                    "registers", "local_bytes")},
                # ms on a busy card, call_ms one call from an idle one
                ms=queued_ms(lambda: wkv.wkv6_fused(r, k, v, logw, u, s0=s0,
                                                    chunk=c), reps),
                call_ms=time_ms(lambda: wkv.wkv6_fused(r, k, v, logw, u,
                                                       s0=s0, chunk=c), reps),
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

    # ---- 15a. batched solves: B systems one after another -----------------
    def rel_over_bound(a, x, x_lib, dtype):
        """‖x − x_lib‖/‖x_lib‖ over the drivers' 200·max(m,n,8)·eps, that
        bound scaled by κ₂(A)/max(m,n,8) where A is worse conditioned than
        that (two backward-stable solvers then differ by up to κ·n·eps)."""
        m_, n_ = a.shape[-2], a.shape[-1]
        kappa = float(torch.linalg.cond(a.double()))
        tol = 200.0 * max(m_, n_, 8) * torch.finfo(dtype).eps \
            * max(1.0, kappa / max(m_, n_, 8))
        return float((x.double() - x_lib.double()).norm()
                     / x_lib.double().norm()) / tol

    new_paths["solve_batched"] = {}
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 20)
        ab = torch.randn(BATCH_B, BATCH_N, BATCH_N, generator=gen, device=dev,
                         dtype=dtype)
        spd = ab @ ab.mT + BATCH_N * torch.eye(BATCH_N, device=dev,
                                               dtype=dtype)
        bb = [torch.randn(BATCH_B, BATCH_N, NRHS, generator=gen, device=dev,
                          dtype=dtype) for _ in range(3)]
        rec = {"phase": "solve_batched", "dtype": str(dtype), "B": BATCH_B,
               "n": BATCH_N, "nrhs": NRHS, "block": BATCH_BLOCK}
        worst = 0.0
        for name, mat, fn, lib, factor, one in (
                ("gesv", ab, batched.gesv_batched, torch.linalg.solve,
                 batched.lu_factor_batched, gesv),
                ("posv", spd, batched.posv_batched,
                 lambda a_, b_: torch.cholesky_solve(
                     b_, torch.linalg.cholesky(a_)),
                 batched.cholesky_factor_batched, posv)):
            bank(new_paths["solve_batched"])
            sync()
            t0 = time.perf_counter()
            xb = fn(mat, bb[0], BATCH_BLOCK)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            launches = ops.launches()
            bank(new_paths["solve_batched"])
            t0 = time.perf_counter()
            fb = factor(mat, BATCH_BLOCK)
            sync()
            t1 = time.perf_counter()
            xs = [batched.solve_batched(fb, b_) for b_ in bb[1:]]
            sync()
            t2 = time.perf_counter()
            factor_ms, solve_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / 2
            bank(new_paths["solve_batched"])
            for i in range(BATCH_B):
                for x_, b_ in zip([xb] + xs, bb):
                    check(torch.equal(x_[i], one(mat[i], b_[i], BATCH_BLOCK)),
                          f"{name}_batched {dtype}: system {i} is not "
                          "bitwise the unbatched driver's")
                    res = scaled_residual(mat[i], x_[i], b_[i], dtype)
                    check(res < RESIDUAL_LIMIT, f"{name}_batched {dtype}: "
                          f"system {i} residual {res}")
                    worst = max(worst, res)
            ops.reset_launches()   # the unbatched checks are not the path's
            no_tf32()
            lib(mat, bb[0])
            sync()
            t0 = time.perf_counter()
            x_lib = lib(mat, bb[0])
            sync()
            lib_ms = (time.perf_counter() - t0) * 1e3
            rel = max(rel_over_bound(mat[i], xb[i], x_lib[i], dtype)
                      for i in range(BATCH_B))
            check(rel < 1.0, f"{name}_batched {dtype}: {rel} of the bound "
                  "from the library's answer")
            rec[name] = {"batched_ms": ms, "factor_batched_ms": factor_ms,
                         "solve_batched_ms_per_rhs_batch": solve_ms,
                         "library_ms": lib_ms, "library_call":
                             "torch.linalg.solve" if name == "gesv" else
                             "torch.linalg.cholesky + torch.cholesky_solve",
                         "rel_err_over_bound": rel,
                         "launches": {k: v for k, v in launches.items() if v},
                         "bitwise_equal_to_unbatched": True}
            del xb, fb, xs, x_lib
        rec["worst_scaled_residual"] = worst
        emit(rec)
        del ab, spd, bb
    for name in ("gemm_accum", "trsm", "lu_panel", "cholesky_panel"):
        check(new_paths["solve_batched"].get(name, 0) > 0,
              f"kernel {name} was not launched on the batched path")

    # ---- 15b. the solve server: two request mixes, answered in full --------
    def mix_requests(mix, count, dtype, seed):
        """``count`` requests drawn by weight from ``mix`` ((dmf, m, n,
        nrhs range, weight)), made on the host from ``seed`` and moved to
        the card before the clock starts."""
        rng = np.random.default_rng(seed)
        w = np.array([k[4] for k in mix], dtype=float)
        picks = rng.choice(len(mix), size=count, p=w / w.sum())
        out = []
        for k in picks:
            dmf, m_, n_, (r0, r1), _ = mix[k]
            a_ = rng.standard_normal((m_, n_))
            if dmf == "posv":
                a_ = a_ @ a_.T + n_ * np.eye(n_)
            nrhs = int(rng.integers(r0, r1 + 1))
            b_ = rng.standard_normal((m_, nrhs))
            out.append((dmf, torch.tensor(a_, dtype=dtype, device=dev),
                        torch.tensor(b_, dtype=dtype, device=dev)))
        return out

    def unbatched(dmf, a_, b_, block):
        if dmf == "geqp3":
            return gels(a_, b_, block, pivot=True)
        return {"gesv": gesv, "posv": posv, "gels": gels}[dmf](a_, b_, block)

    def library(dmf, a_, b_):
        no_tf32()
        if dmf in ("gesv", "posv"):
            return torch.linalg.solve(a_, b_)
        return torch.linalg.lstsq(a_, b_).solution

    def verify(reqs, xs, block, what):
        """Every response bitwise the unbatched driver on the raw shape and
        within the drivers' bound of the library's answer."""
        worst = 0.0
        for (dmf, a_, b_), x_ in zip(reqs, xs):
            check(torch.equal(x_, unbatched(dmf, a_, b_, block)),
                  f"{what}: a {dmf} {tuple(a_.shape)} response is not "
                  "bitwise the unbatched driver's")
            worst = max(worst, rel_over_bound(a_, x_, library(dmf, a_, b_),
                                             a_.dtype))
        check(worst < 1.0, f"{what}: {worst} of the bound from the library")
        return worst

    def closed_loop(cfg_, rounds, cache=False):
        """Each round's requests submitted (``pump`` after each), then
        ``drain``; the server, every response in submit order and the wall
        seconds."""
        srv = SolveServer(cfg_)
        xs = []
        sync()
        t0 = time.perf_counter()
        for reqs in rounds:
            ids = []
            for dmf, a_, b_ in reqs:
                ids.append(srv.submit(dmf, a_, b_, cache=cache))
                srv.pump()
            srv.drain()
            xs += [srv.take(i).x for i in ids]
        sync()
        return srv, xs, time.perf_counter() - t0

    def serve_record(srv, wall, count, launches):
        summ, snap = srv.summary(), srv.snapshot()
        return {"requests": count, "wall_s": wall, "req_per_s": count / wall,
                "p50_ms": summ["p50_ms"], "p99_ms": summ["p99_ms"],
                "gflops_per_s": summ["gflops_per_s"],
                "batches": snap["counter.batches"],
                "buckets": snap["counter.compiles"],
                "bucket_fill_mean": snap["hist.bucket_fill.mean"],
                "padding_waste_mean": snap["hist.padding_waste.mean"],
                "cache_hit_rate": summ["cache_hit_rate"],
                "launches": {k: v for k, v in launches.items() if v}}

    new_paths["solve_server"] = {}
    for mix_name, mix, count, dtypes, block in (
            ("A", SERVER_MIX_A, MIX_A_REQUESTS, (torch.float32, torch.float64),
             32),
            ("B", SERVER_MIX_B, MIX_B_REQUESTS, (torch.float64,), 128)):
        cfg_ = ServerConfig(max_batch=16, max_wait_s=0.005, block=block)
        for dtype in dtypes:
            reqs = mix_requests(mix, count, dtype, SEED)
            # warm-up: one request of every bucket shape (the plans' caches)
            first = {}
            for r_ in reqs:
                key = shape_class(r_[0], *r_[1].shape, 1, dtype)
                first.setdefault(key, r_)
            closed_loop(cfg_, [list(first.values())])
            ops.reset_launches()
            srv, xs, wall = closed_loop(cfg_, [reqs])
            launches = ops.launches()
            bank(new_paths["solve_server"])
            rec = {"phase": "solve_server", "mix": mix_name,
                   "dtype": str(dtype), "block": block, "nvidia_smi": smi,
                   **serve_record(srv, wall, count, launches)}
            rec["rel_err_over_bound_worst"] = verify(
                reqs, xs, block, f"solve_server mix {mix_name} {dtype}")
            rec["bitwise_equal_to_unbatched"] = True
            ops.reset_launches()
            if mix_name == "A":
                # factor once, solve many: distinct gesv/posv matrices, each
                # with CACHE_ROUNDS fresh right-hand sides
                square = [k for k in mix if k[0] in ("gesv", "posv")]
                mats = mix_requests(square, CACHE_MATRICES, dtype, SEED + 22)
                rng = np.random.default_rng(SEED + 23)
                rounds = [[(dmf, a_, torch.tensor(
                    rng.standard_normal(b_.shape), dtype=dtype, device=dev))
                    for dmf, a_, b_ in mats] for _ in range(CACHE_ROUNDS)]
                srv_c, got, wall_c = closed_loop(cfg_, rounds, cache=True)
                launches = ops.launches()
                bank(new_paths["solve_server"])
                asked = [r_ for round_ in rounds for r_ in round_]
                cached = serve_record(srv_c, wall_c, len(asked), launches)
                check(cached["cache_hit_rate"] == 1.0 - 1.0 / CACHE_ROUNDS,
                      f"solve_server cached {dtype}: hit rate "
                      f"{cached['cache_hit_rate']}")
                cached["rel_err_over_bound_worst"] = verify(
                    asked, got, block, f"solve_server cached {dtype}")
                rec["cached"] = cached
                ops.reset_launches()
                # the naive baseline: one gesv at a time at n 48
                a_, b_ = mix_requests([("gesv", 48, 48, (2, 2), 1)], 1,
                                      dtype, SEED + 24)[0][1:]
                gesv(a_, b_, block)
                sync()
                t0 = time.perf_counter()
                for _ in range(NAIVE_CALLS):
                    gesv(a_, b_, block)
                sync()
                rec["naive_gesv_n48_req_per_s"] = \
                    NAIVE_CALLS / (time.perf_counter() - t0)
                ops.reset_launches()
            emit(rec)
            del reqs, xs, srv
    for name in ("gemm_accum", "trsm", "lu_panel", "lu_solve_small",
                 "cholesky_panel", "qr_panel", "larft", "qrcp_panel"):
        check(new_paths["solve_server"].get(name, 0) > 0,
              f"kernel {name} was not launched on the solve server's path")

    # ---- 15c. the mesh engine: worlds of ranks on the one card ------------
    from repro_torch.launch import mesh as launch_mesh

    mesh_t0 = time.perf_counter()
    # the GEMM and TRSM kernels column-decomposable at the mesh's local
    # widths: a rank's run of blocks (nd 4 and 2) and one block (eq)
    decomp = {}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 30)
        ka = torch.randn(N - BLOCK, BLOCK, generator=gen, device=dev,
                         dtype=dtype)
        kb = torch.randn(BLOCK, N, generator=gen, device=dev, dtype=dtype)
        kc = torch.randn(N - BLOCK, N, generator=gen, device=dev, dtype=dtype)
        kl = torch.randn(BLOCK, BLOCK, generator=gen, device=dev,
                         dtype=dtype).tril_()
        kl.diagonal().add_(float(BLOCK))
        wide = blis_gemm.gemm_accum(kc, ka, kb, alpha=-1.0)
        wide_t = trsm.trsm(kl, kb, lower=True, unit_diagonal=True)
        wide_u = trsm.trsm(kl.mT.contiguous(), kb, lower=False)
        ok = True
        for c0, c1 in ((0, N // 4), (N // 4, N // 2), (N // 2, N),
                       (BLOCK, 2 * BLOCK), (N - BLOCK, N)):
            ok &= torch.equal(blis_gemm.gemm_accum(
                kc[:, c0:c1], ka, kb[:, c0:c1], alpha=-1.0), wide[:, c0:c1])
            ok &= torch.equal(trsm.trsm(kl, kb[:, c0:c1], lower=True,
                                        unit_diagonal=True), wide_t[:, c0:c1])
            ok &= torch.equal(trsm.trsm(kl.mT.contiguous(), kb[:, c0:c1],
                                        lower=False), wide_u[:, c0:c1])
        check(ok, f"mesh {dtype}: GEMM/TRSM not column-decomposable")
        decomp[str(dtype)] = True
        del ka, kb, kc, kl, wide, wide_t, wide_u
    ops.reset_launches()
    emit({"phase": "mesh_column_decomposable", "widths": [
        N // 4, N // 2, BLOCK], "bitwise": decomp})
    torch.cuda.empty_cache()
    new_paths["mesh"] = {}
    mesh_cfg = {"n": N, "block": BLOCK, "nrhs": NRHS, "seed": SEED + 40,
                "gels": (QR_M, QR_N)}
    for nprocs, meshes in MESH_WORLDS:
        t0 = time.perf_counter()
        backend = launch_mesh.world_backend("cuda", nprocs)
        out = launch_mesh.spawn(_mesh_job, nprocs,
                                ({**mesh_cfg, "meshes": meshes},),
                                device_type="cuda", timeout=900)
        world_s = time.perf_counter() - t0
        r0 = out[0]
        for k, v in r0["launches"].items():
            new_paths["mesh"][k] = new_paths["mesh"].get(k, 0) + v
        for rec in r0["records"]:
            emit({"phase": "mesh", "world": nprocs, "backend": backend,
                  **rec})
        emit({"phase": "mesh_world", "world": nprocs, "backend": backend,
              "meshes": [m_[0] for m_ in meshes], "seconds": world_s,
              "bcast": r0["traces"],
              "launches_rank0": {k: v for k, v in r0["launches"].items()
                                 if v}})
        for tr_ in r0["traces"]:
            panels = -(-N // BLOCK)
            check(tr_["bcast_count"] == panels
                  and tr_["bcast_bytes"] == panels * (tr_["nd"] - 1) * N
                  * BLOCK * 8, f"mesh {tr_['mesh']} {tr_['variant']}: "
                  f"{tr_['bcast_count']} BCAST spans of "
                  f"{tr_['bcast_bytes']} bytes")
    for name in ("gemm_accum", "trsm", "lu_panel", "cholesky_panel",
                 "qr_panel", "larft"):
        check(new_paths["mesh"].get(name, 0) > 0,
              f"kernel {name} was not launched on the mesh path")
    emit({"phase": "mesh_seconds", "seconds": time.perf_counter() - mesh_t0})

    # ---- 15d. a gels bucket taller than 32 rows an SM, bitwise raw --------
    from repro_torch.serve import bucketing

    tall = {}
    ops.reset_launches()
    for dtype in (torch.float64, torch.float32):
        tm, tn, tr_rhs, tseed = TALL_GELS
        gen = torch.Generator(device=dev).manual_seed(tseed)
        a = torch.randn(tm, tn, generator=gen, device=dev, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(tseed + 1)
        b = torch.randn(tm, tr_rhs, generator=gen, device=dev, dtype=dtype)
        key = bucketing.shape_class("gels", tm, tn, tr_rhs, dtype)
        ap, bp = bucketing.pad_request("gels", a, b, key)
        raw = gels(a, b, BLOCK)
        padded = bucketing.extract(gels(ap, bp, BLOCK), tn, tr_rhs)
        check(torch.equal(raw, padded), f"qr_bucket_tall {dtype}: the "
              f"{key.m} x {key.n} bucket is not bitwise the raw "
              f"{tm} x {tn} answer")
        ratio = ls_ratio(a, raw, b, dtype)
        check(ratio < RESIDUAL_LIMIT, f"qr_bucket_tall {dtype}: ratio {ratio}")
        plans = {f"{m_}x{n_}": {k: panel_qr.plan(m_, n_, dtype)[k] for k in
                                ("route", "grid", "chunk", "rows", "chain")}
                 for m_, n_ in ((tm, tn), (key.m, key.n))}
        check(plans[f"{key.m}x{key.n}"]["rows"] > 32,
              "qr_bucket_tall: the bucket is not taller than 32 rows an SM")
        tall[str(dtype)] = {"bucket": [key.m, key.n], "plans": plans,
                            "ls_ratio": ratio, "bitwise_equal_to_raw": True}
        del a, b, ap, bp, raw, padded
    bank(new_paths.setdefault("qr_bucket_tall", {}))
    emit({"phase": "qr_bucket_tall", "m": TALL_GELS[0], "n": TALL_GELS[1],
          "nrhs": TALL_GELS[2], "seed": TALL_GELS[3], "block": BLOCK,
          **tall})

    # ---- 15e. train_grad: the kernels' Functions against autograd --------
    from repro_torch import tree as T_
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import SyntheticTask
    from repro_torch.optim import shampoo as shampoo_mod
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def fn_vs_plain(fn, plain, ins, gouts, kernel):
        """Run ``fn`` (a Function route) and ``plain`` (its plain
        formulation) on copies of ``ins`` that require a gradient and
        back-propagate ``gouts`` through both: (the Function's outputs, its
        launches in the forward, in forward and backward, all gradients
        bitwise equal)."""
        a = [t.clone().requires_grad_(True) for t in ins]
        b = [t.clone().requires_grad_(True) for t in ins]
        ops.reset_launches()
        outs = _as_tuple(fn(*a))
        n_fwd = ops.launches()[kernel]
        torch.autograd.backward(outs, gouts)
        n_all = ops.launches()[kernel]
        torch.autograd.backward(_as_tuple(plain(*b)), gouts)
        same = all(torch.equal(x.grad, y.grad) for x, y in zip(a, b))
        return [o.detach() for o in outs], n_fwd, n_all, same

    def train_inputs(seed, dtype, *shapes):
        """N(0, 1) tensors of ``shapes``, the first three in ``dtype``."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=gen, device=dev).to(
            dtype if i < 3 else torch.float32) for i, s in enumerate(shapes)]

    def wkv_train_inputs(b, h, s, d, dtype, seed):
        """r, k, v, log w (drawn as phase 13's), u, s0, and the two output
        gradients."""
        r, k, v, z, u, s0, go, gs = train_inputs(
            seed, dtype, (b, h, s, d), (b, h, s, d), (b, h, s, d),
            (b, h, s, d), (h, d), (b, h, d, d), (b, h, s, d), (b, h, d, d))
        return (r, k, v, -torch.exp(-0.6 + 0.42 * z), 0.5 * u,
                0.1 * s0), (go, gs)

    grad_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        row = {}
        ck = {"chunk_q": 128, "chunk_k": 128}
        bq, hq, sq, dq = TRAIN_GRAD_ATTN
        q, k, v, g = train_inputs(SEED + 50, dtype, (bq, hq, sq, dq),
                                  (bq, 2, sq, dq), (bq, 2, sq, dq))[:3] + \
            train_inputs(SEED + 51, dtype, (bq, hq, sq, dq))
        (out,), n_fwd, n_all, same = fn_vs_plain(
            lambda *t: attention.flash_attention_train(*t, **ck),
            lambda *t: attention.chunked_attention_plain(*t, **ck),
            (q, k, v), (g,), "flash_attention")
        want, tol = attention.attn_expect(q, k, v)
        err, ratio = attn_err(out, want, tol)
        check(same and n_fwd == 1 and n_all == 1 and ratio <= 1.0,
              f"train_grad flash {dtype}: bitwise {same}, launches "
              f"{n_fwd}/{n_all}, error/bound {ratio}")
        row["flash_attention"] = {
            "shape": list(TRAIN_GRAD_ATTN), "kv_heads": 2, **ck,
            "grads": ["q", "k", "v"], "grads_bitwise_plain": same,
            "launches_forward": n_fwd, "launches_forward_backward": n_all,
            "max_abs_err": err, "err_over_tol": ratio}
        ins, gouts = wkv_train_inputs(*TRAIN_GRAD_WKV, dtype, SEED + 52)
        (out, sfin), n_fwd, n_all, same = fn_vs_plain(
            lambda *t: wkv.wkv6_train(*t[:5], s0=t[5], chunk=64),
            lambda *t: wkv.wkv6_fused_plain(*t[:5], s0=t[5], chunk=64),
            ins, gouts, "wkv6_fused")
        want, tol, s_want, s_tol = wkv.wkv6_expect(*ins[:5], s0=ins[5],
                                                   chunk=64)
        ratio = max(wkv_within(out, want, tol),
                    wkv_within(sfin, s_want, s_tol))
        check(same and n_fwd == 1 and n_all == 1 and ratio <= 1.0,
              f"train_grad wkv {dtype}: bitwise {same}, launches "
              f"{n_fwd}/{n_all}, error/bound {ratio}")
        row["wkv6_fused"] = {
            "shape": list(TRAIN_GRAD_WKV), "chunk": 64, "from_state": True,
            "grads": ["r", "k", "v", "logw", "u", "s0"],
            "grads_bitwise_plain": same, "launches_forward": n_fwd,
            "launches_forward_backward": n_all,
            "max_abs_err": float((out.double() - want).abs().max()),
            "err_over_tol": ratio}
        grad_rows[str(dtype)] = row
        del q, k, v, g, ins, gouts, out, sfin, want, tol

    # the Functions at the train step's shapes (bfloat16, one layer): the
    # kernel's forward, the Function's forward + backward (the plain
    # recompute's VJP) and the plain formulation's forward, on a busy card
    def fwd_bwd_ms(fn, ins, gouts):
        leaves_ = [t.clone().requires_grad_(True) for t in ins]

        def run():
            for t in leaves_:
                t.grad = None
            torch.autograd.backward(_as_tuple(fn(*leaves_)), gouts)
        return queued_ms(run, 3)

    ck = {"chunk_q": 512, "chunk_k": 1024}
    q, k, v, g = train_inputs(
        SEED + 53, torch.bfloat16, (TRAIN_B, 40, TRAIN_S, 128),
        (TRAIN_B, 10, TRAIN_S, 128), (TRAIN_B, 10, TRAIN_S, 128))[:3] + \
        train_inputs(SEED + 54, torch.bfloat16, (TRAIN_B, 40, TRAIN_S, 128))
    attn_cost = {
        "shape": [TRAIN_B, 40, TRAIN_S, 128], "kv_heads": 10, **ck,
        "kernel_forward_ms": queued_ms(lambda: attention.flash_attention(
            q, k, v, block_q=512, block_k=1024), 5),
        "forward_backward_ms": fwd_bwd_ms(
            lambda *t: attention.flash_attention_train(*t, **ck), (q, k, v),
            (g,)),
        "plain_forward_ms": queued_ms(
            lambda: attention.chunked_attention_plain(q, k, v, **ck), 3)}
    attn_cost["backward_ms"] = attn_cost["forward_backward_ms"] \
        - attn_cost["kernel_forward_ms"]
    ins, gouts = wkv_train_inputs(TRAIN_B, 64, TRAIN_S, 64, torch.bfloat16,
                                  SEED + 55)
    wkv_chunk = get_config(RWKV_ARCH).rwkv_chunk
    wkv_cost = {
        "shape": [TRAIN_B, 64, TRAIN_S, 64], "chunk": wkv_chunk,
        "kernel_forward_ms": queued_ms(lambda: wkv.wkv6_fused(
            *ins[:5], chunk=wkv_chunk), 5),
        "forward_backward_ms": fwd_bwd_ms(
            lambda *t: wkv.wkv6_train(*t, chunk=wkv_chunk)[0], ins[:5],
            gouts[:1]),
        "plain_forward_ms": queued_ms(lambda: wkv.wkv6_fused_plain(
            *ins[:5], chunk=wkv_chunk), 3)}
    wkv_cost["backward_ms"] = wkv_cost["forward_backward_ms"] \
        - wkv_cost["kernel_forward_ms"]
    del q, k, v, g, ins, gouts
    emit({"phase": "train_grad", "dtypes": grad_rows,
          "at_train_shapes_bf16": {"flash_attention": attn_cost,
                                   "wkv6_fused": wkv_cost},
          "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # ---- 15f. train: phi3-medium-14b and rwkv6-7b, full width, depth 4 -----
    def train_run(cfg, tc, kernel, label):
        """``tc.steps`` train steps of ``cfg`` (seeded random weights made on
        the card, batches of TRAIN_B x TRAIN_S tokens of the noiseless
        synthetic task over TRAIN_TASK_VOCAB tokens): gates every loss finite, the mean of the last two
        below the first, ``kernel`` launched layers x (forward + remat
        recompute) times a step and no other kernel; records step ms (p50
        after the first), tokens/s, peak memory, the optimizer's ms a step
        and the device ms by kernel of one profiled step.  Returns the
        trainer (its state the last step's) and the record."""
        src = SyntheticTask(vocab_size=TRAIN_TASK_VOCAB, seq_len=TRAIN_S,
                            noise=0.0)
        sync()
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc, src)
        sync()
        init_s = time.perf_counter() - t0
        remat = cfg.remat and cfg.num_layers > 1
        per_step = cfg.num_layers * (2 if remat else 1)
        # one reference to the state, so each step frees the one before
        state, tr.state = tr.state, None
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, counts = [], [], []
        for i in range(tc.steps):
            batch = tr._host_batch(i)
            ops.reset_launches()
            sync()
            t0 = time.perf_counter()
            state, metrics = tr.train_step(state, batch)
            losses.append(float(metrics["loss"]))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(ops.launches())
        peak = torch.cuda.max_memory_allocated()
        others = {n: c_ for cnt in counts for n, c_ in cnt.items()
                  if n != kernel and c_}
        launches = [cnt[kernel] for cnt in counts]
        check(all(np.isfinite(losses)), f"train {label}: losses {losses}")
        check(np.mean(losses[-2:]) < losses[0],
              f"train {label}: the loss did not fall: {losses}")
        check(all(n == per_step for n in launches) and not others,
              f"train {label}: {kernel} launches a step {launches}, "
              f"expected {per_step}; others {others}")
        batch = tr._host_batch(tc.steps)
        _, grads = tr.value_and_grad(state.params, batch)
        opt = tr.optimizer
        kron = [i for i, p in enumerate(T_.leaves(state.params))
                if isinstance(opt, shampoo_mod.DMFShampoo) and opt._is_kron(p)]
        opt_ms = {}
        if kron:
            # a step that refreshes a preconditioned leaf's roots and one
            # that refreshes none (the state's step set to the one before)
            hits = [s for s in range(1, opt.refresh_every + 1)
                    if any(opt.refreshes(s, i) for i in kron)]
            idle = [s for s in range(1, opt.refresh_every + 1)
                    if s not in hits]
            for key, steps_ in (("refresh", hits), ("no_refresh", idle)):
                if steps_:
                    st = state.opt_state._replace(step=torch.full_like(
                        state.opt_state.step, steps_[0] - 1))
                    opt_ms[key] = time_ms(lambda: opt.update(
                        grads, st, state.params), 3)
        else:
            opt_ms["update"] = time_ms(lambda: opt.update(
                grads, state.opt_state, state.params), 3)
        del grads
        prof = device_busy(lambda: tr.train_step(state, batch), top=8,
                           match=(KERNEL_SYMBOLS[kernel], "nvjet", "gemm",
                                  "elementwise", "reduce"))
        tr.state = state
        p50 = statistics.median(ms[1:])
        full = get_config(cfg.name).num_layers
        rec = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
               "reduced": {"num_layers": [full, cfg.num_layers],
                           "why": "the whole model's weights, gradients and "
                                  "AdamW moments (12 bytes a param) exceed "
                                  "one 80 GB card"},
               "params": sum(t.numel() for t in T_.leaves(state.params)),
               "optimizer": tc.optimizer, "preconditioned_leaves": len(kron),
               "batch": TRAIN_B, "seq": TRAIN_S, "steps": tc.steps,
               "peak_lr": tc.peak_lr, "warmup_steps": tc.warmup_steps,
               "remat": remat, "init_s": init_s, "losses": losses,
               "step_ms": ms, "step_ms_p50": p50,
               "tokens_per_s": TRAIN_B * TRAIN_S / (p50 / 1e3),
               "peak_memory_bytes": peak,
               "allocated_after_init_bytes": resident,
               f"{kernel}_launches_per_step": launches[0],
               "optimizer_ms": opt_ms, "profiled_step": prof,
               "nvidia_smi": smi}
        return tr, rec

    train_recs = {}
    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    tc = TrainerConfig(steps=TRAIN_STEPS, per_device_batch=TRAIN_B,
                       peak_lr=TRAIN_LR, warmup_steps=2)
    tr, train_recs["phi3_adamw"] = train_run(cfg, tc, "flash_attention",
                                             "phi3 adamw")
    del tr
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=TRAIN_LAYERS)
    tr, train_recs["rwkv6_adamw"] = train_run(cfg, tc, "wkv6_fused",
                                              "rwkv6 adamw")
    del tr
    torch.cuda.empty_cache()
    tcs = dataclasses.replace(tc, steps=SHAMPOO_STEPS, optimizer="shampoo")
    tr, train_recs["rwkv6_shampoo"] = train_run(cfg, tcs, "wkv6_fused",
                                                "rwkv6 shampoo")
    del tr
    torch.cuda.empty_cache()
    # one layer: a segment of one repeat keeps 2-D weights, which DMF-
    # Shampoo preconditions (the 4096-wide roots); at depth 4 the stacked
    # (4, d, d) weights take Adam, as in the reference
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    tr, train_recs["rwkv6_shampoo_1_layer"] = train_run(
        cfg1, tcs, "wkv6_fused", "rwkv6 shampoo 1 layer")
    kron_n = {k_: train_recs[k_]["preconditioned_leaves"]
              for k_ in ("rwkv6_shampoo", "rwkv6_shampoo_1_layer")}
    check(kron_n == {"rwkv6_shampoo": 0, "rwkv6_shampoo_1_layer": 9},
          f"train: preconditioned leaves {kron_n}")
    stat_leaf, stat = next(
        (path, st) for path, st in T_.flatten_with_paths(
            tr.state.opt_state.l_stats) if st.shape[0] == cfg.d_model)
    del tr
    torch.cuda.empty_cache()
    emit({"phase": "train", **train_recs})

    # ---- 15g. train_resume: checkpoint at step 4, restore, continue ------
    cfg_r = dataclasses.replace(reduced_config(get_config(ARCH)),
                                dtype="bfloat16", remat=True)
    src = SyntheticTask(vocab_size=cfg_r.vocab_size, seq_len=RESUME_S,
                        noise=0.0)
    with tempfile.TemporaryDirectory() as d:
        tcr = TrainerConfig(steps=8, per_device_batch=TRAIN_B, peak_lr=2e-3,
                            warmup_steps=2, ckpt_dir=d, ckpt_every=4,
                            log_every=100)
        first = Trainer(cfg_r, tcr, src)
        head = first.run(steps=4)
        saved = [t.detach().clone() for t in T_.leaves(first.state)]
        second = Trainer(cfg_r, tcr, src)
        restored, manifest = ckpt_mod.restore_checkpoint(
            ckpt_mod.latest_checkpoint(d), second.state)
        bitwise = manifest["step"] == 4 and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved, T_.leaves(restored)))
        resumed = second.run(steps=8)
        straight = first.run(steps=8, resume=False)
    dev_rel = [abs(a - b) / b for a, b in zip(resumed, straight)]
    check(bitwise, "train_resume: a restored leaf differs from the saved one")
    check(len(resumed) == len(straight) == 4
          and max(dev_rel) <= RESUME_TOL,
          f"train_resume: resumed losses {resumed} against {straight}")
    emit({"phase": "train_resume", "arch": cfg_r.name, "dtype": cfg_r.dtype,
          "layers": cfg_r.num_layers, "d_model": cfg_r.d_model,
          "batch": TRAIN_B, "seq": RESUME_S, "saved_step": 4,
          "restored_bitwise": bitwise, "first_losses": head,
          "resumed_losses": resumed, "uninterrupted_losses": straight,
          "max_rel_loss_deviation": max(dev_rel), "limit": RESUME_TOL,
          "first_resumed_loss_equal": resumed[0] == straight[0]})
    del first, second, restored, saved

    # ---- 15h. shampoo_seed: the Cholesky norm seed of a 4096 statistic ---
    gen = torch.Generator(device=dev).manual_seed(SEED + 56)
    g = torch.randn(cfg.d_model, 4 * cfg.d_model, generator=gen, device=dev)
    gram = (g @ g.mT) / g.shape[1]
    damped = stat + 1e-6 * torch.trace(stat) / stat.shape[0] \
        * torch.eye(stat.shape[0], device=dev)
    del g
    seeds = {}
    for name, a in (("random_gram", gram),
                    ("trained_l_stat_damped", damped)):
        ops.reset_launches()
        seed = float(shampoo_mod.cholesky_norm_seed(a))
        launched = {n: c_ for n, c_ in ops.launches().items() if c_}
        norm2 = float(torch.linalg.matrix_norm(a, 2))
        finite = bool(np.isfinite(seed))      # a float32 Cholesky can fail
        seeds[name] = {"seed": seed if finite else None, "finite": finite,
                       "norm2": norm2,
                       "seed_over_norm2": seed / norm2 if finite else None,
                       "bracket": finite and seed <= 1.001 * norm2
                       and norm2 <= a.shape[0] * seed,
                       "launches": launched}
    rec = seeds["random_gram"]
    check(rec["bracket"] and rec["launches"].get("cholesky_panel", 0) > 0,
          f"shampoo_seed: {rec}")
    seed_ms = time_ms(lambda: shampoo_mod.cholesky_norm_seed(gram), 3)
    chol_ms = time_ms(lambda: torch.linalg.cholesky(gram), 3)
    emit({"phase": "shampoo_seed", "n": gram.shape[0], "dtype": "float32",
          "block": 32, **seeds, "trained_leaf": stat_leaf,
          "gated": "random_gram", "ms": seed_ms,
          "library_cholesky_ms": chol_ms, "nvidia_smi": smi})
    del gram, damped, stat
    torch.cuda.empty_cache()

    # ---- 16. report --------------------------------------------------------
    sources = {"gemm_accum": "gemm.cu", "trsm": "trsm.cu",
               "lu_panel": "panel_lu.cu", "lu_solve_small": "trsm.cu",
               "trsm_right_lower_t": "trsm.cu",
               "fused_lu_panel_update": "fused_pu.cu",
               "fused_cholesky_panel_update": "fused_pu.cu",
               "cholesky_panel": "fused_pu.cu",
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
                # no pallas_call: the reference traces this panel as jnp ops
                "cholesky_panel": "src/repro/core/cholesky.py:50",
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
        for key in ("composed_ms", "composed_call_ms",
                    "bitwise_equal_to_chain", "chain_ms", "call_ms",
                    "library_call_ms", "pytorch_ops_ms"):
            if key in r:
                out[key] = r[key]
        for key in ("window", "k_half", "n_rtm", "streamed", "wide"):
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
            # of which on this slice's paths
            "new_paths_launches": {path: c.get(name, 0)
                                   for path, c in new_paths.items()},
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
        "train_launches_per_step":
            train_recs["phi3_adamw"]["flash_attention_launches_per_step"],
        **bf16_shape(attn_rows, "serve"),
        "shapes": {"prefill_32k": bf16_shape(attn_rows, "prefill_32k")}})

    kernels.append({
        "name": "wkv6_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:95",
        "launches": serve_rwkv_counts["wkv6_fused"],
        "train_launches_per_step":
            train_recs["rwkv6_adamw"]["wkv6_fused_launches_per_step"],
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
