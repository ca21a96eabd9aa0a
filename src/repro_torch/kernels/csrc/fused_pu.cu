// Fused panel updates for Hopper (sm_90a): the LA_MB PU(k+1) of LU and of
// Cholesky, each as one cooperative launch; the Cholesky kernel launched
// with no update terms is also the port's Cholesky panel (PF) kernel.
//
// Replaces the TPU kernels
//   repro/kernels/fused_panel_update.py::fused_lu_panel_update
//     U12 = L11^-1 * A1L (unit lower), panel = A2L - L21 * U12, then GETF2
//     with partial pivoting on the panel;
//   repro/kernels/fused_panel_update.py::fused_cholesky_panel_update
//     panel -= L21 * lrow^T, then POTF2 of the top bn x bn (lower, the
//     upper triangle zeroed) and X * L11^T = A21 for the rows below it.
// The Cholesky panel alone (b = 0) replaces no TPU kernel: the reference
// traces it as jnp ops (repro/core/cholesky.py::cholesky_panel).
// The TPU kernels compute in f32 whatever the input dtype; these compute at
// the input dtype.
//
// What bounds them on an H100: the panel step, as in panel_lu.cu -- a chain
// of bn dependent columns (GETF2) or of bn dependent POTF2 steps and a
// per-row substitution.  The update before it is a thin GEMM (K = b) over
// the m x bn panel.  Both are latency-bound at the main path's shapes
// (m = 8064, b = bn = 128): bytes and flops allow 0.0074 ms.
//
// LU design: the panel_lu.cu grid (one block an SM, each block a chunk of
// rows, resident in shared memory where they fit, else streamed from
// device memory; the plan picks), in three phases:
//   1. U12: the bn columns of A1L in tiles of FU_NC over the blocks, each
//      solved by strip.cuh's routines (the TRSM kernel's diagonal solve and
//      rank-R update: bitwise solve_vector; the TRSM's double-buffered walk,
//      segmented where b is wide) and written back in place.  The other
//      blocks load their rows of A2L into shared memory meanwhile
//      (cp.async; the solving blocks after their solve).  Then the launch's
//      one grid barrier besides GETF2's.  (Staging all of L11 at once in the
//      solving blocks was tried and took as long: the walk is bound by its
//      chain of dependent steps, not by staging.)
//   2. each block applies -L21 * U12 to its rows in place: a 64-row by
//      128-column tile at a time, the L21 and U12 slices of 32 terms of k
//      (8 where 32 would push the rows out of shared memory: f64 at b 384)
//      loaded by cp.async while the previous slice is used (U12 from L2:
//      other blocks wrote it).  The GEMM-accumulate kernel's order: chunks
//      of KC terms of k, chunk 0 from A2L and later ones from 0 added on in
//      order, each chunk one ascending chain with alpha = -1 folded into
//      L21.  f64 on DMMA (m16n8k4, bitwise the ascending DFMA chain, as in
//      gemm.cu), f32 on FFMA.
//   3. getf2_rows of dense.cuh on the same rows (panel_lu.cu's note), then
//      one write-back.
//
// Cholesky design: the same grid shape, planned by chol_pu_plan (one block
// an SM).  Block 0 holds the diagonal block (rows 0..bn-1), every other
// block a chunk of the rows below it (62 rows of 128 in f64 at m 8064:
// 62 KB), resident in shared memory from one load to one write-back where
// they fit beside the update's stages, else in device memory:
//   1. every block applies -L21 * lrow^T to its rows with the LU update's
//      routine (lrow^T staged where U12 is, k fastest); block 0 works on
//      its rows in device memory, the others on theirs in shared memory,
//      held transposed so that the solve can take them as its x tile;
//   2. block 0 factors the diagonal block right after its own update, with
//      no grid barrier before it: POTF2 blocked by 16 columns over all its
//      256 threads (potf2 below: the lower triangle in registers, a 16 x 16
//      grid, up to bn 128, in device memory past that; each 16 x 16
//      diagonal sub-block by one warp with shuffles, the rows below it a
//      thread a row, then a rank-16 update; four __syncthreads a block of
//      16 columns).  Its chain of bn square roots and divisions is the
//      kernel's critical path.  (On an H100, one column a step, with two or
//      one __syncthreads a step, measured 0.9 and 1.7 us a step against
//      about 0.75 us a column here: the step's fixed work, not the
//      arithmetic, bounded it).  Past bn 128 the rank-16 updates are
//      spread over the grid instead (spread_update): column block q >= 1
//      of the diagonal block belongs to one other block, which applies
//      each finished column block k < q to it as soon as it is published
//      and then sets a flag of q; block 0 waits for that flag before
//      factoring q.  One block's O(bn^3) trailing updates had made the
//      kernel slower than the PyTorch-op panel at bn 2048;
//   3. block 0 publishes each finished block of 16 columns of L11 through
//      a flag (release store; the launch is cooperative, so every block is
//      resident), and every other block solves its rows, X L11^T = rows, on
//      strip.cuh's routines (trsm_right_lower_t's right mode), each strip
//      of 16 columns as soon as it is published (acquire load), so the
//      solve runs under POTF2 instead of after one grid barrier: resident
//      rows in place as the x tile, the strips of L11 staged from L2 by
//      cp.async into the space the update's stages used, else tiles of
//      FU_NC rows from device memory (after the last strip) as the TRSM
//      kernel runs them.
// POTF2's array R (bn x 17 values) lives in shared memory where it fits
// beside the solve's buffers, else in a device-memory workspace (bn past
// about 1700 f64 / 3400 f32), so the plan takes any m and any bn the right
// TRSM takes (about 3100 f64 / 6300 f32) and refuses wider ones before any
// launch.  The flags live in a buffer that the last block to finish sets
// back to 0, so a launch needs no fill before it.
//
// Determinism: each phase rounds exactly as the composed path it replaces,
// because it runs the same element routines: the strip routines (bitwise
// solve_vector, as the TRSM kernel), gemm_step or DMMA over ascending k in
// KC chunks as the GEMM-accumulate kernel, getf2_rows as the panel kernel.  The
// Cholesky diagonal step repeats repro_torch.core.cholesky.cholesky_unblocked
// as PyTorch computes it on the card: an IEEE square root, a division, then
// the outer product and the difference each rounded once (no FMA), each
// element's differences in ascending j; which thread applies them and
// where the block lives do not change a rounding.  So la_mb gives bitwise
// the factors of la and mtb, and the panel entry those of the PyTorch-op
// panel (cholesky_unblocked, then the right TRSM kernel).
#include <type_traits>

#include "strip.cuh"

constexpr int FU_NC = 8;                          // U12 columns a block solves at once
constexpr int UPD_ROWS = 64, UPD_COLS = 128;      // an update tile of the block's rows
constexpr int UPD_KS = 32, UPD_KS_NARROW = 8;     // terms of k a stage holds
constexpr int UPD_USB = UPD_COLS + 4;             // padded row of the U12 slice

// One stage of the update, ks terms of k: an L21 slice [UPD_ROWS][ks + 4]
// (rows, k contiguous) and a U12 slice [ks][UPD_USB]; the update keeps two.
// The pads of 4 put the fragment loads of the DMMA core on distinct banks,
// as in gemm.cu.  ks is UPD_KS, or UPD_KS_NARROW where the wide stages
// would push the block's rows out of shared memory (the plan chooses).
__host__ __device__ constexpr size_t update_stage(int ks) {
  return static_cast<size_t>(UPD_ROWS * (ks + 4) + ks * UPD_USB);
}

// Bytes rounded up to 16.
__host__ __device__ constexpr size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// The fused LU kernel's shared memory: the GETF2 scratch, then the
// block's rows where they are resident (chunk x bn) and the update's two
// stages after them.  A block that solves a U12 tile does so first, in the
// space after the scratch (the TRSM's double-buffered walk of `seg` rows),
// and loads its rows after it.
template <typename T>
struct LuPuSmem {
  size_t scratch, rows;
  __host__ __device__ LuPuSmem(int64_t bn, int64_t chunk, bool resident)
      : scratch(getf2_scratch<T>(bn)),
        rows(resident ? round16(static_cast<size_t>(chunk * bn) * sizeof(T)) : 0) {}
  __host__ __device__ size_t total(int64_t b, int64_t seg, int ks) const {
    const size_t update = rows + 2 * update_stage(ks) * sizeof(T);
    const size_t solve = b <= 0 ? 0 : strip::Layout<T, FU_NC, false>::bytes(b, seg);
    return scratch + (update > solve ? update : solve);
  }
};

// The update's arithmetic on one tile (64 rows by 128 columns), 32 values
// a thread, each taking gemm_step's terms in ascending k with -L21 (alpha
// folded), as the GEMM-accumulate kernel does.  f64 on DMMA (dmma of
// dense.cuh, m16n8k4, bitwise the ascending DFMA chain of its four terms:
// gemm.cu's core), a warp a 32 x 32 part (warps 2 x 4); f32 on FFMA, warp
// w the rows w, w + 8, ... and lane l the columns l, l + 32, ... (the rows'
// L21 values read by the whole warp at once).  at(x) is the tile's row and
// column of value x.
template <typename T>
struct UpdateCore;

template <>
struct UpdateCore<double> {
  static constexpr int N = 32;
  double d[2][4][4];  // 16 x 8 tiles (i, j), four values each
  __device__ double& val(int x) { return d[x / 16][(x / 4) % 4][x % 4]; }
  __device__ static void at(int x, int* r, int* c) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int i = x / 16, j = (x / 4) % 4, e = x % 4;
    *r = (w / 4) * 32 + i * 16 + lane / 4 + 8 * (e >> 1);
    *c = (w % 4) * 32 + j * 8 + 2 * (lane % 4) + (e & 1);
  }
  __device__ void step(const double* ls, int lsa, const double* us, int ks) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane / 4, q = lane % 4;
    const int wr = (w / 4) * 32, wc = (w % 4) * 32;
    for (int kq = 0; kq < ks; kq += 4) {  // a ragged last step adds zeros: -0 * +0
      double a[2][2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[i][h] = -ls[(wr + i * 16 + g + 8 * h) * lsa + kq + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = us[(kq + q) * UPD_USB + wc + j * 8 + g];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(d[i][j], a[i], b[j]);
    }
  }
};

template <>
struct UpdateCore<float> {
  static constexpr int TM = 8, TN = 4, N = TM * TN;
  float d[N];
  __device__ float& val(int x) { return d[x]; }
  __device__ static void at(int x, int* r, int* c) {
    *r = (threadIdx.x >> 5) + GETF2_WARPS * (x / TN);
    *c = (threadIdx.x & 31) + 32 * (x % TN);
  }
  __device__ void step(const float* ls, int lsa, const float* us, int ks) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int k = 0; k < ks; ++k) {
      float lv[TM], uv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) lv[i] = -ls[(w + GETF2_WARPS * i) * lsa + k];
#pragma unroll
      for (int u = 0; u < TN; ++u) uv[u] = us[k * UPD_USB + lane + 32 * u];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) d[i * TN + u] = gemm_step(d[i * TN + u], lv[i], uv[u]);
    }
  }
};

// A (the block's rows of the panel, m x bn) -= L21[rows] (m x b) * U (b x bn),
// U[k, c] at u[k * uk + c * uc], in the GEMM-accumulate kernel's order:
// chunks of KC terms of k, chunk 0 from A and later ones from 0 added on in
// order.  The slices of L21 and U for stage s + 1 (kstage terms each) load
// by cp.async while stage s is used (two stages at `stage`).  A is a
// RowSpan or a ColSpan (its at(row, column) and r0, n); UT: U is stored
// transposed (uk = 1), so its slice loads with k fastest.
template <typename T, bool UT, typename Span>
__device__ void update_rows(const Span& A, int b, int bn, const T* __restrict__ l21,
                            int64_t ld21, const T* u, int64_t uk, int64_t uc, T* stage,
                            int kstage) {
  const int tid = threadIdx.x, lsa = kstage + 4;
  const size_t STAGE = update_stage(kstage);
  const T* l21b = l21 + A.r0 * ld21;
  for (int rt = 0; rt < A.n; rt += UPD_ROWS) {
    const int rows = min(UPD_ROWS, A.n - rt);
    for (int ct = 0; ct < bn; ct += UPD_COLS) {
      const int cols = min(UPD_COLS, bn - ct);
      for (int kc = 0; kc < b; kc += static_cast<int>(KC)) {
        const int ke = min(b, kc + static_cast<int>(KC));
        const int slices = (ke - kc + kstage - 1) / kstage;
        // slice sl of this chunk into stage sl % 2, zero past its rows,
        // columns and terms
        auto issue = [&](int sl) {
          T* ls = stage + (sl & 1) * STAGE;
          T* us = ls + UPD_ROWS * lsa;
          const int k0 = kc + sl * kstage, ks = min(kstage, ke - k0);
          for (int e = tid; e < UPD_ROWS * kstage; e += GETF2_THREADS) {
            const int rr = e / kstage, k = e % kstage;
            const bool ok = rr < rows && k < ks;
            cp_async_elem<sizeof(T)>(ls + rr * lsa + k,
                                     ok ? l21b + static_cast<int64_t>(rt + rr) * ld21 + k0 + k
                                        : l21b,
                                     ok ? static_cast<int>(sizeof(T)) : 0);
          }
          for (int e = tid; e < kstage * UPD_COLS; e += GETF2_THREADS) {
            const int k = UT ? e % kstage : e / UPD_COLS, c = UT ? e / kstage : e % UPD_COLS;
            const bool ok = k < ks && c < cols;
            cp_async_elem<sizeof(T)>(
                us + k * UPD_USB + c,
                ok ? u + static_cast<int64_t>(k0 + k) * uk + static_cast<int64_t>(ct + c) * uc : u,
                ok ? static_cast<int>(sizeof(T)) : 0);
          }
          cp_async_commit();
        };
        UpdateCore<T> core;
#pragma unroll
        for (int x = 0; x < UpdateCore<T>::N; ++x) {
          int r, c;
          UpdateCore<T>::at(x, &r, &c);
          core.val(x) = kc == 0 && r < rows && c < cols ? A.at(rt + r, ct + c) : T(0);
        }
        __syncthreads();  // the stages' last readers are done
        issue(0);
        for (int sl = 0; sl < slices; ++sl) {
          if (sl + 1 < slices) {
            issue(sl + 1);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const T* ls = stage + (sl & 1) * STAGE;
          core.step(ls, lsa, ls + UPD_ROWS * lsa, min(kstage, ke - kc - sl * kstage));
          __syncthreads();  // stage sl % 2 is free for slice sl + 2
        }
        // chunk 0 replaces A; a later chunk's sum is added on
#pragma unroll
        for (int x = 0; x < UpdateCore<T>::N; ++x) {
          int r, c;
          UpdateCore<T>::at(x, &r, &c);
          if (r < rows && c < cols) {
            T& y = A.at(rt + r, ct + c);
            y = kc == 0 ? core.val(x) : y + core.val(x);
          }
        }
      }
    }
  }
  __syncthreads();
}

// The LU phases (the note at the top); the shared memory is LuPuSmem's.
// RESIDENT: the block's rows of A2L live in shared memory, loaded by
// cp.async from the start, under phase 1.  VEC: L11 and A1L have 16-byte
// aligned rows.  Phase 1 stages seg rows of L11 a step; the update ks terms
// of k a stage.
template <typename T, bool RESIDENT, bool VEC>
__global__ void __launch_bounds__(GETF2_THREADS, 1)
fused_lu_pu_kernel(int b, int seg, int ks, int64_t m, int64_t bn64, const T* __restrict__ l11,
                   int64_t ld11, const T* __restrict__ l21, int64_t ld21, T* a1l, int64_t ld1,
                   T* a2l, int64_t ld2, int32_t* piv, unsigned char* ws) {
  using I = std::conditional_t<RESIDENT, int, int64_t>;
  using W = strip::Walk<true, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, bn = static_cast<int>(bn64);
  const Pub<T> pub(ws, G, bn);
  int64_t chunk, r0, r1;
  owned_rows(m, G, blockIdx.x, &chunk, &r0, &r1);
  const int n = static_cast<int>(r1 - r0);
  const LuPuSmem<T> sm(bn, chunk, RESIDENT);
  T* res = reinterpret_cast<T*>(smem_raw + sm.scratch);
  unsigned char* solve = smem_raw + sm.scratch;
  // the block's rows of A2L into the residency: under phase 1 where the
  // block solves no U12 tile, else after it (its solve waits for its own
  // copies only) and under the grid barrier
  const bool solver = b > 0 && static_cast<int64_t>(blockIdx.x) * FU_NC < bn;
  auto load_rows = [&] {
    for (int e = threadIdx.x; e < n * bn; e += GETF2_THREADS) {
      const int rr = e / bn, c = e % bn;
      cp_async_elem<sizeof(T)>(res + e, a2l + (r0 + rr) * ld2 + c, static_cast<int>(sizeof(T)));
    }
    cp_async_commit();
  };
  if (RESIDENT && !solver) load_rows();

  // 1. U12 = L11^-1 A1L, in place
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * FU_NC; b > 0 && c0 < bn; c0 += G * FU_NC) {
    if (seg < b)
      strip::solve_tile<T, false, FU_NC, VEC, true, GETF2_THREADS, W, void>(
          solve, b, seg, bn, c0, l11, ld11, a1l, ld1, a1l, ld1);
    else
      strip::solve_tile<T, false, FU_NC, VEC, false, GETF2_THREADS, W, void>(
          solve, b, seg, bn, c0, l11, ld11, a1l, ld1, a1l, ld1);
    __syncthreads();  // the tile is written back before the next one loads
  }
  if (RESIDENT && solver) load_rows();
  cg::this_grid().sync();
  cp_async_wait<0>();
  __syncthreads();

  // 2. the block's rows of A2L - L21 U12
  const RowSpan<T, I> A{RESIDENT ? res : a2l + r0 * ld2,
                        RESIDENT ? static_cast<I>(bn) : static_cast<I>(ld2), r0, n};
  update_rows<T, false>(A, b, bn, l21, ld21, a1l, ld1, 1,
                        reinterpret_cast<T*>(smem_raw + sm.scratch + sm.rows), ks);

  // 3. GETF2
  getf2_rows(A, m, bn, piv, pub, smem_raw);
  if (RESIDENT) move_rows<T, false>(res, a2l + r0 * ld2, ld2, n, bn);
}

// ---------------------------------------------------------------------------
// The Cholesky kernel.
// ---------------------------------------------------------------------------
constexpr int CHOL_THREADS = GETF2_THREADS;  // the update core's 8 warps
constexpr int64_t CHOL_MIN_ROWS = 32;        // rows below the diagonal a block at least
constexpr int POTF2_SIDE = 16;               // POTF2's threads: a 16 x 16 grid
constexpr int POTF2_SLOTS = 8;               // rows (and columns) a thread holds in registers
constexpr int POTF2_RS = POTF2_SIDE + 1;     // the row stride of POTF2's column block
constexpr int CHOL_REG_MAX = POTF2_SIDE * POTF2_SLOTS;  // the widest bn POTF2 keeps in registers

// The rows [r0, r1) that block `blk` owns: block 0 the diagonal block
// [0, bn), block k >= 1 the (k - 1)-th chunk of the rows below it.
__device__ __forceinline__ void chol_rows(int64_t m, int64_t bn, int64_t chunk, int blk,
                                          int64_t* r0, int64_t* r1) {
  if (blk == 0) {
    *r0 = 0;
    *r1 = bn;
    return;
  }
  *r0 = min(m, bn + (blk - 1) * chunk);
  *r1 = min(m, *r0 + chunk);
}

// A block's rows held transposed in shared memory: row rr, column c at
// p[c * ld + rr] (ld odd, so a column's rows fall on distinct banks).  The
// strip solve takes it as its x tile, a right-hand side a row.
template <typename T>
struct ColSpan {
  T* p;
  int ld;
  int64_t r0;
  int n;
  __device__ __forceinline__ T& at(int rr, int c) const { return p[c * ld + rr]; }
};

// The flags between the blocks (a release store or add by one thread after
// a barrier over the block's writes; an acquire load by one thread, then a
// barrier): flag[0], the column blocks of L11 that block 0 has finished;
// flag[1], the 64-row tiles of the diagonal block whose update is done;
// flag[2], the blocks that have finished; flag[3 + q], the column blocks
// applied to column block q of a spread POTF2.  The last block to finish
// sets them all back to 0, so one buffer serves every launch on a stream.
__device__ __forceinline__ void flag_release(unsigned* f, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(f), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned flag_acquire(const unsigned* f) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
  return v;
}
__device__ __forceinline__ void flag_add(unsigned* f, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(f), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned flag_arrive(unsigned* f) {
  unsigned v;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(v) : "l"(f) : "memory");
  return v;
}
// One thread waits until *f >= v, then the block goes on.
__device__ __forceinline__ void flag_wait(const unsigned* f, unsigned v) {
  if (threadIdx.x == 0)
    while (flag_acquire(f) < v) __nanosleep(64);
  __syncthreads();
}

// The staging of spread_update (below): 16 columns' and SPREAD_ROWS rows'
// 16 values of L.
constexpr int SPREAD_ROWS = 128;
template <typename T>
__host__ __device__ constexpr size_t spread_bytes() {
  return static_cast<size_t>((POTF2_SIDE + SPREAD_ROWS) * POTF2_RS) * sizeof(T);
}

// Shared memory: the rows where they are resident (bn x ld), then a region
// that the update's two stages and, after them, block 0's POTF2 array
// (bn x POTF2_RS values; in a device-memory workspace instead where it does
// not fit: bn past about 1700 f64 / 3400 f32) or the other blocks' solve
// buffers (resident: two of the triangle's strips; else strip.cuh's tile of
// FU_NC rows and its buffers) take in turn.
template <typename T>
struct CholSmem {
  size_t rows;
  __host__ __device__ CholSmem(int64_t bn, int64_t ld, bool resident)
      : rows(resident ? round16(static_cast<size_t>(bn * ld) * sizeof(T)) : 0) {}
  __host__ __device__ static size_t solve(int64_t bn, int64_t seg, bool resident) {
    return resident ? 2 * strip::Layout<T, 1, true>::strip(bn, seg) * sizeof(T)
                    : strip::Layout<T, FU_NC, true>::bytes(bn, seg);
  }
  __host__ __device__ static size_t cols(int64_t bn) {
    return static_cast<size_t>(bn * POTF2_RS) * sizeof(T);
  }
  __host__ __device__ size_t total(int64_t b, int64_t bn, int64_t seg, int ks, bool resident,
                                   bool cols_shared) const {
    size_t work = solve(bn, seg, resident);
    if (bn > CHOL_REG_MAX && work < spread_bytes<T>()) work = spread_bytes<T>();
    const size_t update = b > 0 ? 2 * update_stage(ks) * sizeof(T) : 0;
    const size_t r = cols_shared ? cols(bn) : 0;
    work = work > update ? work : update;
    return rows + (work > r ? work : r);
  }
};

// POTF2 of the bn x bn diagonal block at a (device memory) by one block,
// in place, lower; the upper triangle is left as it is.  Blocked by 16
// columns: the elements are spread over a 16 x 16 grid of threads, (tr, tc)
// = (tid % 16, tid / 16) holding a[r][c] for r = tr + 16p, c = tc + 16q,
// r >= c, so that column block k (columns 16k..16k+15) is slot q = k of
// every thread.  For each column block, with R (shared, bn x POTF2_RS) its
// columns as rows:
//   1. every thread writes its elements of the block into R;
//   2. warp 0 factors the 16 x 16 diagonal sub-block, a lane a row, the
//      pivot and the columns passed by shuffles (no barrier inside);
//   3. one thread a row finishes the rows below it: for each column c in
//      turn, the differences with the columns before it, then the division;
//   4. every thread applies the block's 16 columns, in turn, to its
//      elements of the columns after it (the rank-16 update).
// A barrier after each, so four a block of 16 columns; done(k) after step
// 3 of block k, whose columns are then final in a.  Each a[r][c] still
// takes sub_rn(a, mul_rn(L[r][j], L[c][j])) for j = 0, 1, ..., c - 1 in
// turn, then div_rn by sqrt_rn of the diagonal: cholesky_unblocked's
// roundings, whatever thread applies them.  Store<T> holds the thread's
// elements: in registers where the block is at most CHOL_REG_MAX wide,
// else in the panel in device memory (L2).
template <typename T>
struct RegStore {
  static constexpr int P = POTF2_SLOTS;
  T v[P * (P + 1) / 2];  // slot (p, q) at p * (p + 1) / 2 + q
  // f(p, q, value) on the thread's elements of the columns [c0, c1]
  template <typename F>
  __device__ __forceinline__ void each(int bn, int c0, int c1, F f) {
    const int tr = threadIdx.x % POTF2_SIDE, tc = threadIdx.x / POTF2_SIDE;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int c = tc + POTF2_SIDE * q;
      if (c < c0 || c > c1) continue;
#pragma unroll
      for (int p = q; p < P; ++p) {
        const int r = tr + POTF2_SIDE * p;
        if (r >= c && r < bn) f(p, q, v[p * (p + 1) / 2 + q]);
      }
    }
  }
  // step 4 for the columns from c0 on: the block's columns from R, one at a
  // time, each applied to every element
  __device__ __forceinline__ void update(int bn, int c0, const T* R) {
    const int tr = threadIdx.x % POTF2_SIDE, tc = threadIdx.x / POTF2_SIDE;
    for (int i = 0; i < POTF2_SIDE; ++i) {
      T lr[P], lc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        lr[p] = R[min(tr + POTF2_SIDE * p, bn - 1) * POTF2_RS + i];
        lc[p] = R[min(tc + POTF2_SIDE * p, bn - 1) * POTF2_RS + i];
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int c = tc + POTF2_SIDE * q;
        if (c < c0) continue;
#pragma unroll
        for (int p = q; p < P; ++p) {
          const int r = tr + POTF2_SIDE * p;
          T& y = v[p * (p + 1) / 2 + q];
          const T x = sub_rn(y, mul_rn(lr[p], lc[q]));
          y = r >= c && r < bn ? x : y;
        }
      }
    }
  }
};

// The elements in device memory, a column's POTF2_BATCH at a time.
constexpr int POTF2_BATCH = 8;
template <typename T>
struct MemStore {
  T* a;
  int64_t lda;
  template <typename F>
  __device__ __forceinline__ void each(int bn, int c0, int c1, F f) {
    const int tr = threadIdx.x % POTF2_SIDE, tc = threadIdx.x / POTF2_SIDE;
    int c = tc;
    if (c < c0) c += (c0 - tc + POTF2_SIDE - 1) / POTF2_SIDE * POTF2_SIDE;
    for (; c <= c1 && c < bn; c += POTF2_SIDE) {
      int r = tr + POTF2_SIDE * (c / POTF2_SIDE);
      if (r < c) r += POTF2_SIDE;
      for (; r < bn; r += POTF2_SIDE) f(r / POTF2_SIDE, c / POTF2_SIDE, a[r * lda + c]);
    }
  }
  __device__ __forceinline__ void update(int bn, int c0, const T* R) {
    const int tr = threadIdx.x % POTF2_SIDE, tc = threadIdx.x / POTF2_SIDE;
    int c = tc;
    if (c < c0) c += (c0 - tc + POTF2_SIDE - 1) / POTF2_SIDE * POTF2_SIDE;
    for (; c < bn; c += POTF2_SIDE) {
      T lc[POTF2_SIDE];
#pragma unroll
      for (int i = 0; i < POTF2_SIDE; ++i) lc[i] = R[c * POTF2_RS + i];
      int r0 = tr + POTF2_SIDE * (c / POTF2_SIDE);
      if (r0 < c) r0 += POTF2_SIDE;
      for (int r = r0; r < bn; r += POTF2_SIDE * POTF2_BATCH) {
        T y[POTF2_BATCH];
#pragma unroll
        for (int u = 0; u < POTF2_BATCH; ++u)
          if (r + POTF2_SIDE * u < bn) y[u] = a[(r + POTF2_SIDE * u) * lda + c];
#pragma unroll
        for (int i = 0; i < POTF2_SIDE; ++i)
#pragma unroll
          for (int u = 0; u < POTF2_BATCH; ++u)
            y[u] = sub_rn(y[u], mul_rn(R[min(r + POTF2_SIDE * u, bn - 1) * POTF2_RS + i], lc[i]));
#pragma unroll
        for (int u = 0; u < POTF2_BATCH; ++u)
          if (r + POTF2_SIDE * u < bn) a[(r + POTF2_SIDE * u) * lda + c] = y[u];
      }
    }
  }
};

//
// Spread (the device-memory store with other blocks to help): step 4 is
// left to the other blocks (spread_update), and ready(k) waits, before
// column block k, until they have applied blocks 0..k-1 to it.
template <typename T, typename Store, typename Done, typename Ready>
__device__ void potf2(T* a, int64_t lda, int bn, T* R, Store& st, Done done, bool spread,
                      Ready ready) {
  constexpr int S = POTF2_SIDE;
  const int tid = threadIdx.x, tr = tid % S, tc = tid / S;
  for (int k0 = 0; k0 < bn; k0 += S) {
    const int w = min(S, bn - k0);  // the block's columns
    if (spread) ready(k0 / S);
    // 1. the block's columns into R (row r, column k0 + i at R[r][i])
    st.each(bn, k0, k0 + S - 1, [&](int p, int, T& y) { R[(tr + S * p) * POTF2_RS + tc] = y; });
    __syncthreads();
    // 2. the diagonal sub-block: lane l holds row k0 + l; at step c, d from
    // lane c, then column c scaled, then passed to the later columns
    if (tid < 32) {
      const int l = tid, row = k0 + min(l, w - 1);
      T x[S];
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = R[row * POTF2_RS + i];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        if (c >= w) break;
        const T d = sqrt_rn(__shfl_sync(0xffffffffu, x[c], c));
        x[c] = l == c ? d : div_rn(x[c], d);
#pragma unroll
        for (int c2 = c + 1; c2 < S; ++c2) {
          const T t = __shfl_sync(0xffffffffu, x[c], c2);  // L[k0 + c2][k0 + c]
          if (l >= c2) x[c2] = sub_rn(x[c2], mul_rn(x[c], t));
        }
      }
      if (l < w) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          R[row * POTF2_RS + i] = x[i];
          if (i <= l) a[row * lda + k0 + i] = x[i];
        }
      }
    }
    __syncthreads();
    // 3. the rows below the sub-block, a thread a row
    for (int row = k0 + S + tid; row < bn; row += CHOL_THREADS) {
      T x[S];
#pragma unroll
      for (int i = 0; i < S; ++i) x[i] = R[row * POTF2_RS + i];
#pragma unroll
      for (int c = 0; c < S; ++c) {
        if (c >= w) break;
#pragma unroll
        for (int i = 0; i < c; ++i) x[c] = sub_rn(x[c], mul_rn(x[i], R[(k0 + c) * POTF2_RS + i]));
        x[c] = div_rn(x[c], R[(k0 + c) * POTF2_RS + c]);
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        R[row * POTF2_RS + i] = x[i];
        if (i < w) a[row * lda + k0 + i] = x[i];
      }
    }
    __syncthreads();
    done(k0 / S);  // the block's columns are final in a
    // 4. the block's columns applied to the columns after it
    if (!spread && k0 + S < bn) st.update(bn, k0 + S, R);
    __syncthreads();
  }
}

// Step 4 of POTF2 spread over the grid: column block k of L (final in a)
// applied to column block q > k (columns 16q.., rows r >= c) by one block,
// in a: each element y -= L[r][j] * L[c][j] for the block's 16 values of j
// in ascending order, each product and difference rounded once, as
// RegStore/MemStore::update apply it.  A thread a column and every 16th
// row; L's rows staged SPREAD_ROWS at a time in buf (spread_bytes).
template <typename T>
__device__ void spread_update(T* a, int64_t lda, int bn, int k, int q, T* buf) {
  constexpr int S = POTF2_SIDE, RS = POTF2_RS, LANES = CHOL_THREADS / S;
  const int tid = threadIdx.x, tc = tid % S, tr = tid / S;
  const int c0 = q * S, w = min(S, bn - c0), j0 = k * S, c = c0 + tc;
  T* lcs = buf;           // L[c0 + i][j0 + jj] at lcs[i * RS + jj]
  T* lrs = buf + S * RS;  // L[r0 + rr][j0 + jj] at lrs[rr * RS + jj]
  for (int e = tid; e < S * S; e += CHOL_THREADS) {
    const int i = e / S, jj = e % S;
    if (i < w) lcs[i * RS + jj] = a[(c0 + i) * lda + j0 + jj];
  }
  __syncthreads();
  T lc[S];
#pragma unroll
  for (int jj = 0; jj < S; ++jj) lc[jj] = lcs[min(tc, w - 1) * RS + jj];
  for (int r0 = c0; r0 < bn; r0 += SPREAD_ROWS) {
    const int nr = min(SPREAD_ROWS, bn - r0);
    for (int e = tid; e < nr * S; e += CHOL_THREADS) {
      const int rr = e / S, jj = e % S;
      lrs[rr * RS + jj] = a[(r0 + rr) * lda + j0 + jj];
    }
    __syncthreads();
    if (tc < w) {
      for (int rr = tr; rr < nr; rr += LANES) {
        const int r = r0 + rr;
        if (r < c) continue;
        T y = a[r * lda + c];
#pragma unroll
        for (int jj = 0; jj < S; ++jj) y = sub_rn(y, mul_rn(lrs[rr * RS + jj], lc[jj]));
        a[r * lda + c] = y;
      }
    }
    __syncthreads();  // the rows are used before the next ones load
  }
}

// PU(k+1) of Cholesky (b > 0), or the Cholesky panel alone (b = 0: the
// update adds nothing), of the m x bn panel p, in place; the shared memory
// is CholSmem's.  Block 0 holds the diagonal block, the others chunk rows
// below it each (chol_rows).  RESIDENT: those rows live in shared memory,
// transposed (ld odd), from one load to one write-back; else they stay in
// device memory.  vec: the panel's rows are 16-byte aligned (the strips of
// L11 load 16 bytes a copy).  seg: rows of L11 a solve step stages; ks:
// terms of k an update stage holds.  colw: POTF2's array in device memory
// (bn x POTF2_RS), or null where it is in shared memory.  flag: three
// counters, 0 at the launch and left 0.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(CHOL_THREADS, 1)
fused_chol_pu_kernel(int b, int seg, int ks, int vec, int64_t m, int64_t bn64, int64_t chunk,
                     int ld, const T* __restrict__ lrow, int64_t ldr,
                     const T* __restrict__ l21, int64_t ld21, T* p, int64_t ldp,
                     T* colw, unsigned* flag) {
  using W = strip::Walk<true, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bn = static_cast<int>(bn64), tid = threadIdx.x;
  const CholSmem<T> sm(bn, ld, RESIDENT);
  T* xs = reinterpret_cast<T*>(smem_raw);
  unsigned char* work = smem_raw + sm.rows;
  T* stage = reinterpret_cast<T*>(work);
  T* col = stage;  // block 0's POTF2 array R, after its update (else colw)
  int64_t r0, r1;
  chol_rows(m, bn64, chunk, blockIdx.x, &r0, &r1);
  const int n = static_cast<int>(r1 - r0);

  // 1. the block's rows -= L21[rows] lrow^T; the diagonal block's 64-row
  // tiles by the first other blocks, before their own rows (block 0 alone
  // where it is the only block); block 0 then factors the diagonal block
  const int tiles = b > 0 ? (bn + UPD_ROWS - 1) / UPD_ROWS : 0;
  const int helpers = static_cast<int>(gridDim.x) - 1;
  // POTF2 in device memory with other blocks: they apply its rank-16
  // updates (spread_update), column block q >= 1 by block
  // 1 + (tiles + q - 1) % helpers, after its own rows' update
  const int nq = (bn + POTF2_SIDE - 1) / POTF2_SIDE;
  const bool spread = bn > CHOL_REG_MAX && helpers > 0;
  unsigned* applied = flag + 3;  // applied[q]: column blocks applied to q
  if (blockIdx.x > 0 && RESIDENT) {  // the block's rows load meanwhile
    for (int e = tid; e < n * bn; e += CHOL_THREADS) {
      const int rr = e / bn, c = e % bn;
      cp_async_elem<sizeof(T)>(xs + c * ld + rr, p + (r0 + rr) * ldp + c,
                               static_cast<int>(sizeof(T)));
    }
    cp_async_commit();
  }
  if (blockIdx.x > 0 && blockIdx.x <= tiles) {
    for (int t = blockIdx.x - 1; t < tiles; t += helpers) {
      const RowSpan<T, int64_t> D{p + static_cast<int64_t>(t) * UPD_ROWS * ldp, ldp,
                                  static_cast<int64_t>(t) * UPD_ROWS,
                                  min(UPD_ROWS, bn - t * UPD_ROWS)};
      update_rows<T, true>(D, b, bn, l21, ld21, lrow, 1, ldr, stage, ks);
      if (tid == 0) flag_add(flag + 1, 1);
    }
  }
  if (blockIdx.x == 0) {
    if (helpers == 0) {
      const RowSpan<T, int64_t> A{p, ldp, 0, bn};
      update_rows<T, true>(A, b, bn, l21, ld21, lrow, 1, ldr, stage, ks);
    } else {
      flag_wait(flag + 1, static_cast<unsigned>(tiles));
    }
    auto done = [&](int k) {
      if (tid == 0) flag_release(flag, static_cast<unsigned>(k + 1));
    };
    auto ready = [&](int k) {
      if (k > 0) flag_wait(applied + k, static_cast<unsigned>(k));
    };
    if (bn <= CHOL_REG_MAX) {
      RegStore<T> st;
      st.each(bn, 0, bn - 1, [&](int pp, int q, T& y) {
        y = p[(tid % POTF2_SIDE + POTF2_SIDE * pp) * ldp + tid / POTF2_SIDE + POTF2_SIDE * q];
      });
      potf2(p, ldp, bn, col, st, done, false, ready);
    } else if (colw == nullptr) {
      MemStore<T> st{p, ldp};
      potf2(p, ldp, bn, col, st, done, spread, ready);
    } else {
      MemStore<T> st{p, ldp};
      potf2(p, ldp, bn, colw, st, done, spread, ready);
    }
    for (int e = tid; e < bn * bn; e += CHOL_THREADS) {
      const int r = e / bn, c = e % bn;
      if (c > r) p[r * ldp + c] = T(0);
    }
  } else if (RESIDENT) {
    cp_async_wait<0>();
    __syncthreads();
    const ColSpan<T> A{xs, ld, r0, n};
    update_rows<T, true>(A, b, bn, l21, ld21, lrow, 1, ldr, stage, ks);
  } else {
    const RowSpan<T, int64_t> A{p + r0 * ldp, ldp, r0, n};
    update_rows<T, true>(A, b, bn, l21, ld21, lrow, 1, ldr, stage, ks);
  }
  if (blockIdx.x > 0 && spread) {
    // the block's column blocks q of the diagonal block: column block k
    // applied to each as soon as block 0 has published it
    const int first = ((static_cast<int>(blockIdx.x) - 1 - tiles) % helpers + helpers) % helpers + 1;
    for (int k = 0; k + 1 < nq; ++k) {
      int q = first;
      while (q <= k) q += helpers;
      if (q >= nq) break;
      flag_wait(flag, static_cast<unsigned>(k + 1));
      for (; q < nq; q += helpers) {
        spread_update(p, ldp, bn, k, q, reinterpret_cast<T*>(work));
        if (tid == 0) flag_release(applied + q, static_cast<unsigned>(k + 1));
      }
    }
  }
  if (blockIdx.x > 0 && n > 0) {
    // 2. X L11^T = the block's rows, on strip.cuh's routines, each strip of
    // L11 as soon as block 0 has published its columns
    auto ready = [&](int k) { flag_wait(flag, static_cast<unsigned>(k + 1)); };
    if (RESIDENT) {
      T* ts = reinterpret_cast<T*>(work);
      if (seg < bn) {
        if (vec)
          strip::solve_resident<T, true, true, CHOL_THREADS, W>(ts, xs, ld, n, bn, seg, p, ldp,
                                                                 ready);
        else
          strip::solve_resident<T, false, true, CHOL_THREADS, W>(ts, xs, ld, n, bn, seg, p, ldp,
                                                                  ready);
      } else {
        if (vec)
          strip::solve_resident<T, true, false, CHOL_THREADS, W>(ts, xs, ld, n, bn, seg, p, ldp,
                                                                  ready);
        else
          strip::solve_resident<T, false, false, CHOL_THREADS, W>(ts, xs, ld, n, bn, seg, p,
                                                                   ldp, ready);
      }
      for (int e = tid; e < n * bn; e += CHOL_THREADS) {
        const int rr = e / bn, c = e % bn;
        p[(r0 + rr) * ldp + c] = xs[c * ld + rr];
      }
    } else {
      ready((bn - 1) / strip::R);  // all of L11
      for (int64_t c0 = r0; c0 < r1; c0 += FU_NC) {
        if (seg < bn) {
          if (vec)
            strip::solve_tile<T, true, FU_NC, true, true, CHOL_THREADS, W, void>(
                work, bn, seg, r1, c0, p, ldp, p, ldp, p, ldp);
          else
            strip::solve_tile<T, true, FU_NC, false, true, CHOL_THREADS, W, void>(
                work, bn, seg, r1, c0, p, ldp, p, ldp, p, ldp);
        } else {
          if (vec)
            strip::solve_tile<T, true, FU_NC, true, false, CHOL_THREADS, W, void>(
                work, bn, seg, r1, c0, p, ldp, p, ldp, p, ldp);
          else
            strip::solve_tile<T, true, FU_NC, false, false, CHOL_THREADS, W, void>(
                work, bn, seg, r1, c0, p, ldp, p, ldp, p, ldp);
        }
        __syncthreads();  // the tile is written back before the next one loads
      }
    }
  }

  // the last block to finish sets the flags back to 0 for the next launch
  // (every wait of every block is over by then)
  if (__syncthreads_or(tid == 0 && flag_arrive(flag + 2) == gridDim.x - 1))
    for (int i = tid; i < 3 + nq; i += CHOL_THREADS) flag[i] = 0;
}

// ---------------------------------------------------------------------------
// Plans and launches.
// ---------------------------------------------------------------------------

// How PU(k+1) of LU runs for L11 b x b and an m x bn panel: out = {blocks,
// resident (1) or streamed (0), rows a block (chunk), dynamic shared memory
// bytes, workspace bytes, threads a block, rows a U12 segment stages, the
// widest b the card takes, terms of k an update stage holds}.  The rows
// stay resident where they fit;
// cudaErrorInvalidValue, with out[7] set, where b is wider than the card
// takes.
template <typename T>
static cudaError_t lu_pu_plan(int64_t b, int64_t m, int64_t bn, int64_t* out) {
  if (b < 0 || m <= 0 || bn <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = panel_card(&sms, &optin);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(optin);
  out[7] = strip::widest<T, FU_NC, false>(limit - getf2_scratch<T>(bn));
  // b = 0: no U12 to solve, the update adds nothing
  if (b > out[7]) return cudaErrorInvalidValue;
  int64_t g = (m + GETF2_MIN_ROWS - 1) / GETF2_MIN_ROWS;
  g = g < sms ? g : sms;
  g = g < GETF2_MAX_BLOCKS ? g : GETF2_MAX_BLOCKS;
  const int64_t chunk = (m + g - 1) / g;
  // the rows resident with wide update stages, resident with narrow ones,
  // else streamed; a route runs where both its instantiations (aligned or
  // not) fit
  for (int k = 0; k < 3; ++k) {
    const bool resident = k < 2;
    const int ks = k == 1 ? UPD_KS_NARROW : UPD_KS;
    const LuPuSmem<T> sm(bn, chunk, resident);
    if (sm.scratch >= limit) continue;
    const int64_t seg = b > 0 ? strip::segment_rows<T, FU_NC, false>(b, limit - sm.scratch)
                              : strip::R;
    if (seg <= 0) continue;
    const size_t smem = sm.total(b, seg, ks);
    if (smem > limit) continue;
    bool ok = false;
    if (resident) {
      err = fits_one_block(fused_lu_pu_kernel<T, true, true>, GETF2_THREADS, smem, &ok);
      if (err == cudaSuccess && ok)
        err = fits_one_block(fused_lu_pu_kernel<T, true, false>, GETF2_THREADS, smem, &ok);
    } else {
      err = fits_one_block(fused_lu_pu_kernel<T, false, true>, GETF2_THREADS, smem, &ok);
      if (err == cudaSuccess && ok)
        err = fits_one_block(fused_lu_pu_kernel<T, false, false>, GETF2_THREADS, smem, &ok);
    }
    if (err != cudaSuccess) return err;
    if (!ok) continue;
    out[0] = g;
    out[1] = resident ? 1 : 0;
    out[2] = chunk;
    out[3] = static_cast<int64_t>(smem);
    out[4] = static_cast<int64_t>(Pub<T>::bytes(g, bn));
    out[5] = GETF2_THREADS;
    out[6] = seg;
    out[8] = ks;
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T>
static cudaError_t launch_lu_pu(int64_t b, int64_t m, int64_t bn, const void* l11, int64_t ld11,
                                const void* l21, int64_t ld21, void* a1l, int64_t ld1, void* a2l,
                                int64_t ld2, void* piv, int grid, int resident, int64_t smem,
                                int64_t seg, int ks, void* ws, cudaStream_t stream) {
  if (m <= 0 || bn <= 0) return cudaSuccess;
  if (b < 0 || seg < strip::R) return cudaErrorInvalidValue;
  int bi = static_cast<int>(b), si = static_cast<int>(seg);
  const T* l11p = static_cast<const T*>(l11);
  const T* l21p = static_cast<const T*>(l21);
  T* a1p = static_cast<T*>(a1l);
  T* a2p = static_cast<T*>(a2l);
  int32_t* pp = static_cast<int32_t*>(piv);
  unsigned char* wp = static_cast<unsigned char*>(ws);
  if (ks != UPD_KS && ks != UPD_KS_NARROW) return cudaErrorInvalidValue;
  void* args[] = {&bi, &si, &ks, &m, &bn, &l11p, &ld11, &l21p, &ld21, &a1p, &ld1,
                  &a2p, &ld2, &pp, &wp};
  const bool vec = aligned16(l11, ld11, sizeof(T)) && aligned16(a1l, ld1, sizeof(T));
  auto kernel = resident ? (vec ? fused_lu_pu_kernel<T, true, true> : fused_lu_pu_kernel<T, true, false>)
                         : (vec ? fused_lu_pu_kernel<T, false, true> : fused_lu_pu_kernel<T, false, false>);
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(GETF2_THREADS), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Rows a step of the resident solve stages for a bn-row triangle in `room`
// bytes: all of them (one segment a strip) where two buffers of the whole
// triangle fit, else the most whole strips that do; 0 where not one does.
template <typename T>
static int64_t resident_segment(int64_t bn, size_t room) {
  using L = strip::Layout<T, 1, true>;
  const int64_t full = (bn + strip::R - 1) / strip::R * strip::R;
  if (2 * L::strip(bn, full) * sizeof(T) <= room) return full;
  const int64_t rows = static_cast<int64_t>(room / (2 * L::RS * sizeof(T)));  // seg + R
  const int64_t seg = (rows - strip::R) / strip::R * strip::R;
  return seg >= strip::R ? seg : 0;
}

// How the Cholesky kernel runs for b terms of update (0: the panel alone) on
// an m x bn panel: out = {blocks, resident (1) or streamed (0), rows a block
// below the diagonal (chunk), dynamic shared memory bytes, threads a block,
// rows of L11 a solve step stages, POTF2 in registers (1) or in device
// memory (0), terms of k an update stage holds, the widest bn the card
// takes, the resident rows' stride, POTF2's array in shared memory (1) or
// in a device-memory workspace (0), that workspace's bytes, the int32 flags
// it needs (3 + bn / 16, zeroed before the first launch)}.  The rows stay
// resident where they fit with wide update stages, else with narrow ones,
// else they stream; each with POTF2's array in shared memory where it fits
// beside them, else in device memory.
// cudaErrorInvalidValue, with out[8] set, where bn is wider than the card
// takes; cudaErrorInvalidConfiguration where no route fits one block an SM.
template <typename T>
static cudaError_t chol_pu_plan(int64_t b, int64_t m, int64_t bn, int64_t* out) {
  if (b < 0 || bn <= 0 || m < bn) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = panel_card(&sms, &optin);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(optin);
  out[8] = strip::widest<T, FU_NC, true>(limit);  // the streamed solve's, as the TRSM's
  if (bn > out[8]) return cudaErrorInvalidValue;
  // block 0 the diagonal block, one block an SM for the rows below it
  const int64_t below = m - bn;
  int64_t g = (below + CHOL_MIN_ROWS - 1) / CHOL_MIN_ROWS;
  g = g < sms - 1 ? g : sms - 1;
  g = g < PANEL_MAX_BLOCKS - 1 ? g : PANEL_MAX_BLOCKS - 1;
  const int64_t chunk = g > 0 ? (below + g - 1) / g : 0;
  if (chunk > 0) g = (below + chunk - 1) / chunk;
  const int64_t ld = chunk | 1;
  for (int k = 0; k < 8; ++k) {
    const bool cols_shared = k < 4, resident = k % 4 < 2;
    const int ks = k % 2 == 0 ? UPD_KS : UPD_KS_NARROW;
    if (!cols_shared && bn <= CHOL_REG_MAX) continue;  // the register POTF2 reads R in shared
    const CholSmem<T> sm(bn, ld, resident);
    if (sm.rows >= limit) continue;
    const size_t room = limit - sm.rows;
    const int64_t seg = resident ? resident_segment<T>(bn, room)
                                 : strip::segment_rows<T, FU_NC, true>(bn, room);
    if (seg <= 0) continue;
    const size_t smem = sm.total(b, bn, seg, ks, resident, cols_shared);
    if (smem > limit) continue;
    bool ok = false;
    err = resident ? fits_one_block(fused_chol_pu_kernel<T, true>, CHOL_THREADS, smem, &ok)
                   : fits_one_block(fused_chol_pu_kernel<T, false>, CHOL_THREADS, smem, &ok);
    if (err != cudaSuccess) return err;
    if (!ok) continue;
    out[0] = 1 + g;
    out[1] = resident ? 1 : 0;
    out[2] = chunk;
    out[3] = static_cast<int64_t>(smem);
    out[4] = CHOL_THREADS;
    out[5] = seg;
    out[6] = bn <= CHOL_REG_MAX ? 1 : 0;
    out[7] = ks;
    out[9] = ld;
    out[10] = cols_shared ? 1 : 0;
    out[11] = cols_shared ? 0 : static_cast<int64_t>(CholSmem<T>::cols(bn));
    out[12] = 3 + (bn + POTF2_SIDE - 1) / POTF2_SIDE;
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T>
static cudaError_t launch_chol_pu(int64_t b, int64_t m, int64_t bn, const void* lrow,
                                  int64_t ldr, const void* l21, int64_t ld21, void* p,
                                  int64_t ldp, int grid, int resident, int64_t chunk,
                                  int64_t smem, int64_t seg, int ks, void* colw, void* flag,
                                  cudaStream_t stream) {
  if (m <= 0 || bn <= 0) return cudaSuccess;
  if (m < bn || b < 0 || grid < 1 || seg < strip::R) return cudaErrorInvalidValue;
  if (ks != UPD_KS && ks != UPD_KS_NARROW) return cudaErrorInvalidValue;
  int bi = static_cast<int>(b), si = static_cast<int>(seg);
  int vec = aligned16(p, ldp, sizeof(T)) ? 1 : 0;
  int ld = static_cast<int>(chunk | 1);
  const T* lrp = static_cast<const T*>(lrow);
  const T* l21p = static_cast<const T*>(l21);
  T* pp = static_cast<T*>(p);
  T* cp = static_cast<T*>(colw);
  unsigned* fp = static_cast<unsigned*>(flag);
  void* args[] = {&bi, &si, &ks, &vec, &m, &bn, &chunk, &ld, &lrp, &ldr, &l21p, &ld21,
                  &pp, &ldp, &cp, &fp};
  auto kernel = resident ? fused_chol_pu_kernel<T, true> : fused_chol_pu_kernel<T, false>;
  return launch_cooperative(kernel, grid, static_cast<size_t>(smem), args, stream, CHOL_THREADS);
}

#define REPRO_FUSED_ENTRIES(T, SFX)                                                         \
  extern "C" int repro_fused_lu_plan_##SFX(int64_t b, int64_t m, int64_t bn, int64_t* out) { \
    return lu_pu_plan<T>(b, m, bn, out);                                                    \
  }                                                                                         \
  extern "C" int repro_fused_lu_##SFX(int64_t b, int64_t m, int64_t bn, const void* l11,    \
                                      int64_t ld11, const void* l21, int64_t ld21,          \
                                      void* a1l, int64_t ld1, void* a2l, int64_t ld2,       \
                                      void* piv, int grid, int resident, int64_t smem,      \
                                      int64_t seg, int ks, void* ws, void* stream) {        \
    return launch_lu_pu<T>(b, m, bn, l11, ld11, l21, ld21, a1l, ld1, a2l, ld2, piv, grid,   \
                           resident, smem, seg, ks, ws, static_cast<cudaStream_t>(stream)); \
  }                                                                                         \
  extern "C" int repro_fused_chol_plan_##SFX(int64_t b, int64_t m, int64_t bn,             \
                                             int64_t* out) {                                \
    return chol_pu_plan<T>(b, m, bn, out);                                                  \
  }                                                                                         \
  extern "C" int repro_fused_chol_##SFX(int64_t b, int64_t m, int64_t bn, const void* lrow, \
                                        int64_t ldr, const void* l21, int64_t ld21,         \
                                        void* p, int64_t ldp, int grid, int resident,       \
                                        int64_t chunk, int64_t smem, int64_t seg, int ks,   \
                                        void* colw, void* flag, void* stream) {             \
    return launch_chol_pu<T>(b, m, bn, lrow, ldr, l21, ld21, p, ldp, grid, resident, chunk, \
                             smem, seg, ks, colw, flag, static_cast<cudaStream_t>(stream)); \
  }

REPRO_FUSED_ENTRIES(float, f32)
REPRO_FUSED_ENTRIES(double, f64)
