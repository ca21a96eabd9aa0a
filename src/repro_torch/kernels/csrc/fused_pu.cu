// Fused panel updates for Hopper (sm_90a): the LA_MB PU(k+1) of LU and of
// Cholesky, each as one cooperative launch.
//
// Replaces the TPU kernels
//   repro/kernels/fused_panel_update.py::fused_lu_panel_update
//     U12 = L11^-1 * A1L (unit lower), panel = A2L - L21 * U12, then GETF2
//     with partial pivoting on the panel;
//   repro/kernels/fused_panel_update.py::fused_cholesky_panel_update
//     panel -= L21 * lrow^T, then POTF2 of the top bn x bn (lower, the
//     upper triangle zeroed) and X * L11^T = A21 for the rows below it.
// The TPU kernels compute in f32 whatever the input dtype; these compute at
// the input dtype.
//
// What bounds them on an H100: the panel step, as in panel_lu.cu -- a chain
// of bn dependent columns (GETF2) or of bn dependent POTF2 steps and a
// per-row substitution.  The update before it is a thin GEMM (K = b) over
// the m x bn panel.  Both are latency-bound at the main path's shapes
// (m = 8064, b = bn = 128).
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
// Cholesky design: a cooperative grid over the panel's rows (two blocks an
// SM); each block owns the same contiguous chunk in every phase, a grid
// barrier between phases:
//   1. each block updates its rows of the panel;
//   2. block 0 factors the top bn x bn: in shared memory where bn*(bn+1)
//      values fit (bn 169 in f64, 240 in f32), else in place in device
//      memory; upper triangle zeroed;
//   3. every block solves its rows below bn, one thread a row, with L11 in
//      shared memory where it fits, else read from device memory.
//
// Determinism: each phase rounds exactly as the composed path it replaces,
// because it runs the same element routines: the strip routines (bitwise
// solve_vector, as the TRSM kernel), gemm_step or DMMA over ascending k in
// KC chunks as the GEMM-accumulate kernel, getf2_rows as the panel kernel.  The
// Cholesky diagonal step repeats repro_torch.core.cholesky.cholesky_unblocked
// as PyTorch computes it on the card: an IEEE square root, a division, then
// the outer product and the difference each rounded once (no FMA); where
// the block lives does not change a rounding.  So la_mb gives bitwise the
// factors of la and mtb.
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
// U[k, c] at u[k * ldu + c], in the GEMM-accumulate kernel's order: chunks
// of KC terms of k, chunk 0 from A and later ones from 0 added on in order.
// The slices of L21 and U for stage s + 1 (kstage terms each) load by
// cp.async while stage s is used (two stages at `stage`).
template <typename T, typename I>
__device__ void update_rows(const RowSpan<T, I>& A, int b, int bn, const T* __restrict__ l21,
                            int64_t ld21, const T* u, int64_t ldu, T* stage, int kstage) {
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
            const int k = e / UPD_COLS, c = e % UPD_COLS;
            const bool ok = k < ks && c < cols;
            cp_async_elem<sizeof(T)>(us + k * UPD_USB + c,
                                     ok ? u + static_cast<int64_t>(k0 + k) * ldu + ct + c : u,
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
  update_rows(A, b, bn, l21, ld21, a1l, ld1,
              reinterpret_cast<T*>(smem_raw + sm.scratch + sm.rows), ks);

  // 3. GETF2
  getf2_rows(A, m, bn, piv, pub, smem_raw);
  if (RESIDENT) move_rows<T, false>(res, a2l + r0 * ld2, ld2, n, bn);
}

// The Cholesky update: a2l (m x bn) -= l21 (m x b) . u (b x bn), where
// u[k, c] = u[k * su + c * sc]: the rows this block owns, one element a
// thread at a time.
template <typename T>
__device__ void chol_update_rows(int64_t m, int64_t b, int64_t bn, const T* __restrict__ l21,
                                 int64_t ld21, const T* u, int64_t su, int64_t sc, T* a,
                                 int64_t lda) {
  int64_t chunk, r0, r1;
  owned_rows(m, gridDim.x, blockIdx.x, &chunk, &r0, &r1);
  const int64_t total = (r1 - r0) * bn;
  for (int64_t e = threadIdx.x; e < total; e += PANEL_THREADS) {
    const int64_t r = r0 + e / bn, c = e % bn;
    T acc = a[r * lda + c];
    for (int64_t k = 0; k < b; ++k)
      acc = gemm_step(acc, T(-1) * l21[r * ld21 + k], u[k * su + c * sc]);
    a[r * lda + c] = acc;
  }
}

template <typename T>
__host__ __device__ constexpr size_t chol_pu_smem(int64_t bn) {
  return static_cast<size_t>(bn) * (bn + 1) * sizeof(T);
}

// SMEM: the diagonal block in shared memory (chol_pu_smem(bn) bytes), else
// in place in device memory (bn values of shared memory for the column).
template <typename T, bool SMEM>
__global__ void __launch_bounds__(PANEL_THREADS)
fused_chol_pu_kernel(int64_t b, int64_t m, int64_t bn, const T* __restrict__ lrow,
                     int64_t ldr, const T* __restrict__ l21, int64_t ld21, T* p,
                     int64_t ldp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* l = SMEM ? reinterpret_cast<T*>(smem_raw) : p;  // the diagonal block
  const int64_t ldl = SMEM ? bn : ldp;
  T* col = reinterpret_cast<T*>(smem_raw) + (SMEM ? bn * bn : 0);  // [bn] scaled column
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, warps = PANEL_THREADS / 32;

  // 1. panel -= L21 lrow^T
  chol_update_rows<T>(m, b, bn, l21, ld21, lrow, 1, ldr, p, ldp);
  grid.sync();

  // 2. POTF2 of the top bn x bn by block 0
  if (blockIdx.x == 0) {
    if (SMEM) {
      for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) l[e] = p[(e / bn) * ldp + e % bn];
      __syncthreads();
    }
    for (int64_t j = 0; j < bn; ++j) {
      const T d = sqrt_rn(l[j * ldl + j]);
      for (int64_t r = j + 1 + tid; r < bn; r += PANEL_THREADS) col[r] = div_rn(l[r * ldl + j], d);
      __syncthreads();
      // lower trailing triangle: a[r, c] -= col[r] * col[c], j < c <= r
      for (int64_t r = j + 1 + warp; r < bn; r += warps)
        for (int64_t c = j + 1 + lane; c <= r; c += 32)
          l[r * ldl + c] = sub_rn(l[r * ldl + c], mul_rn(col[r], col[c]));
      for (int64_t r = j + 1 + tid; r < bn; r += PANEL_THREADS) l[r * ldl + j] = col[r];
      if (tid == 0) l[j * ldl + j] = d;
      __syncthreads();
    }
    for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) {
      const int64_t r = e / bn, c = e % bn;
      if (SMEM) p[r * ldp + c] = c <= r ? l[e] : T(0);
      else if (c > r) p[r * ldp + c] = T(0);
    }
  }
  grid.sync();

  // 3. X L11^T = A21, one row a thread
  if (SMEM && blockIdx.x != 0) {
    for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) l[e] = __ldcg(p + (e / bn) * ldp + e % bn);
    __syncthreads();
  }
  int64_t chunk, r0, r1;
  owned_rows(m, gridDim.x, blockIdx.x, &chunk, &r0, &r1);
  for (int64_t r = max(r0, bn) + tid; r < r1; r += PANEL_THREADS)
    solve_vector<T, true, false>(bn, l, ldl, p + r * ldp, 1);
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

// The Cholesky kernel's route: the diagonal block in shared memory where it
// fits the card's limit.
template <typename T>
static bool chol_smem_route(int64_t bn) {
  int sms = 0, optin = 0;
  return panel_card(&sms, &optin) == cudaSuccess &&
         chol_pu_smem<T>(bn) <= static_cast<size_t>(optin);
}

template <typename T>
static cudaError_t chol_grid(int64_t m, int64_t bn, int* grid) {
  return chol_smem_route<T>(bn)
             ? cooperative_grid(fused_chol_pu_kernel<T, true>, chol_pu_smem<T>(bn), m, grid)
             : cooperative_grid(fused_chol_pu_kernel<T, false>, bn * sizeof(T), m, grid);
}

template <typename T>
static cudaError_t launch_chol_pu(int64_t b, int64_t m, int64_t bn, const void* lrow,
                                  int64_t ldr, const void* l21, int64_t ld21, void* p,
                                  int64_t ldp, int grid, cudaStream_t stream) {
  if (m <= 0 || bn <= 0) return cudaSuccess;
  if (m < bn) return cudaErrorInvalidValue;
  const T* lrp = static_cast<const T*>(lrow);
  const T* l21p = static_cast<const T*>(l21);
  T* pp = static_cast<T*>(p);
  void* args[] = {&b, &m, &bn, &lrp, &ldr, &l21p, &ld21, &pp, &ldp};
  return chol_smem_route<T>(bn)
             ? launch_cooperative(fused_chol_pu_kernel<T, true>, grid, chol_pu_smem<T>(bn), args, stream)
             : launch_cooperative(fused_chol_pu_kernel<T, false>, grid, bn * sizeof(T), args, stream);
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
  extern "C" int repro_fused_chol_grid_##SFX(int64_t m, int64_t bn, int* grid) {           \
    return chol_grid<T>(m, bn, grid);                                                       \
  }                                                                                         \
  extern "C" int repro_fused_chol_##SFX(int64_t b, int64_t m, int64_t bn, const void* lrow, \
                                        int64_t ldr, const void* l21, int64_t ld21,         \
                                        void* p, int64_t ldp, int grid, void* stream) {     \
    return launch_chol_pu<T>(b, m, bn, lrow, ldr, l21, ld21, p, ldp, grid,                  \
                             static_cast<cudaStream_t>(stream));                            \
  }

REPRO_FUSED_ENTRIES(float, f32)
REPRO_FUSED_ENTRIES(double, f64)
