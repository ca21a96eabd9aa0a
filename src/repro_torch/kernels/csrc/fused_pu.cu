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
// Design: the TPU kernels kept the whole panel in one VMEM residency and
// fell back to composed kernels when it did not fit.  Here an 8064 x 128
// f64 panel (8 MiB) is far above one block's 227 KB of shared memory, so
// there is no residency and no fallback: a cooperative grid over the
// panel's rows, as in panel_lu.cu, takes every m.  Each block owns the same
// contiguous chunk of rows in every phase; a grid barrier separates phases.
//
//   LU        1. U12: the bn columns of A1L, NC per block, one thread each,
//               solved in shared memory (b x NC values) and written back
//               in place; grid barrier.
//             2. each block updates its rows of the panel; grid barrier.
//             3. getf2_grid of dense.cuh on the panel.
//   Cholesky  1. each block updates its rows of the panel; grid barrier.
//             2. block 0 factors the top bn x bn in shared memory (bn*bn
//               values: 128 KiB in f64 at bn = 128, so one block per SM)
//               and writes it back, upper triangle zeroed; grid barrier.
//             3. every block loads L11 into shared memory and solves its
//               rows below bn, one thread per row, in place.
//
// Determinism: each phase rounds exactly as the composed path it replaces,
// because it runs the same element routines (dense.cuh): solve_vector,
// whose order the TRSM kernel's strips keep bitwise, gemm_step over ascending k with alpha = -1 folded into
// L21 as the GEMM-accumulate kernel, getf2_grid as the panel kernel.  The
// Cholesky diagonal step repeats repro_torch.core.cholesky.cholesky_unblocked
// as PyTorch computes it on the card: an IEEE square root, a division, then
// the outer product and the difference each rounded once (no FMA).  So
// la_mb gives bitwise the factors of la and mtb.
#include "dense.cuh"

constexpr int NC = 32;  // U12 columns per block in the LU phase 1

template <typename T>
__host__ __device__ constexpr size_t lu_pu_smem(int64_t b, int64_t bn) {
  return getf2_smem<T>(bn) > static_cast<size_t>(b) * NC * sizeof(T)
             ? getf2_smem<T>(bn) : static_cast<size_t>(b) * NC * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t chol_pu_smem(int64_t bn) {
  return static_cast<size_t>(bn) * (bn + 1) * sizeof(T);
}

// a2l (m x bn) -= l21 (m x b) . u (b x bn), where u[k, c] = u[k * su + c * sc]:
// the rows this block owns, one element a thread at a time.
template <typename T>
__device__ void update_rows(int64_t m, int64_t b, int64_t bn, const T* __restrict__ l21,
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
__global__ void __launch_bounds__(PANEL_THREADS)
fused_lu_pu_kernel(int64_t b, int64_t m, int64_t bn, const T* __restrict__ l11,
                   int64_t ld11, const T* __restrict__ l21, int64_t ld21, T* a1l,
                   int64_t ld1, T* a2l, int64_t ld2, int32_t* piv, T* cand, T* rowj,
                   T* pval, int64_t* pidx) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, tid = threadIdx.x;

  // 1. U12 = L11^-1 A1L, one column a thread
  T* x = reinterpret_cast<T*>(smem_raw) + tid;
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * NC; c0 < bn; c0 += G * NC) {
    const int64_t col = c0 + tid;
    if (tid < NC && col < bn) {
      for (int64_t i = 0; i < b; ++i) x[i * NC] = a1l[i * ld1 + col];
      solve_vector<T, true, true>(b, l11, ld11, x, NC);
      for (int64_t i = 0; i < b; ++i) a1l[i * ld1 + col] = x[i * NC];
    }
  }
  grid.sync();

  // 2. panel = A2L - L21 U12
  update_rows<T>(m, b, bn, l21, ld21, a1l, ld1, 1, a2l, ld2);
  grid.sync();

  // 3. GETF2
  getf2_grid<T>(m, bn, a2l, ld2, piv, cand, rowj, pval, pidx, smem_raw);
}

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
fused_chol_pu_kernel(int64_t b, int64_t m, int64_t bn, const T* __restrict__ lrow,
                     int64_t ldr, const T* __restrict__ l21, int64_t ld21, T* p,
                     int64_t ldp) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* l = reinterpret_cast<T*>(smem_raw);  // [bn][bn] diagonal block
  T* col = l + bn * bn;                    // [bn] scaled column
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, warps = PANEL_THREADS / 32;

  // 1. panel -= L21 lrow^T
  update_rows<T>(m, b, bn, l21, ld21, lrow, 1, ldr, p, ldp);
  grid.sync();

  // 2. POTF2 of the top bn x bn, in shared memory, by block 0
  if (blockIdx.x == 0) {
    for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) l[e] = p[(e / bn) * ldp + e % bn];
    __syncthreads();
    for (int64_t j = 0; j < bn; ++j) {
      const T d = sqrt_rn(l[j * bn + j]);
      for (int64_t r = j + 1 + tid; r < bn; r += PANEL_THREADS) col[r] = div_rn(l[r * bn + j], d);
      __syncthreads();
      // lower trailing triangle: a[r, c] -= col[r] * col[c], j < c <= r
      for (int64_t r = j + 1 + warp; r < bn; r += warps)
        for (int64_t c = j + 1 + lane; c <= r; c += 32)
          l[r * bn + c] = sub_rn(l[r * bn + c], mul_rn(col[r], col[c]));
      for (int64_t r = j + 1 + tid; r < bn; r += PANEL_THREADS) l[r * bn + j] = col[r];
      if (tid == 0) l[j * bn + j] = d;
      __syncthreads();
    }
    for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) {
      const int64_t r = e / bn, c = e % bn;
      p[r * ldp + c] = c <= r ? l[e] : T(0);
    }
  }
  grid.sync();

  // 3. X L11^T = A21, one row a thread
  if (blockIdx.x != 0) {
    for (int64_t e = tid; e < bn * bn; e += PANEL_THREADS) l[e] = p[(e / bn) * ldp + e % bn];
    __syncthreads();
  }
  int64_t chunk, r0, r1;
  owned_rows(m, gridDim.x, blockIdx.x, &chunk, &r0, &r1);
  for (int64_t r = max(r0, bn) + tid; r < r1; r += PANEL_THREADS)
    solve_vector<T, true, false>(bn, l, bn, p + r * ldp, 1);
}

template <typename T>
static cudaError_t launch_lu_pu(int64_t b, int64_t m, int64_t bn, const void* l11,
                                int64_t ld11, const void* l21, int64_t ld21, void* a1l,
                                int64_t ld1, void* a2l, int64_t ld2, void* piv, int grid,
                                void* cand, void* rowj, void* pval, void* pidx,
                                cudaStream_t stream) {
  if (m <= 0 || bn <= 0) return cudaSuccess;
  if (b > 256) return cudaErrorInvalidValue;
  const T* l11p = static_cast<const T*>(l11);
  const T* l21p = static_cast<const T*>(l21);
  T* a1p = static_cast<T*>(a1l);
  T* a2p = static_cast<T*>(a2l);
  int32_t* pp = static_cast<int32_t*>(piv);
  T* cp = static_cast<T*>(cand);
  T* rp = static_cast<T*>(rowj);
  T* vp = static_cast<T*>(pval);
  int64_t* ip = static_cast<int64_t*>(pidx);
  void* args[] = {&b, &m, &bn, &l11p, &ld11, &l21p, &ld21, &a1p, &ld1,
                  &a2p, &ld2, &pp, &cp, &rp, &vp, &ip};
  return launch_cooperative(fused_lu_pu_kernel<T>, grid, lu_pu_smem<T>(b, bn), args, stream);
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
  return launch_cooperative(fused_chol_pu_kernel<T>, grid, chol_pu_smem<T>(bn), args, stream);
}

#define REPRO_FUSED_ENTRIES(T, SFX)                                                        \
  extern "C" int repro_fused_lu_grid_##SFX(int64_t b, int64_t m, int64_t bn, int* grid) { \
    return cooperative_grid(fused_lu_pu_kernel<T>, lu_pu_smem<T>(b, bn), m, grid);        \
  }                                                                                        \
  extern "C" int repro_fused_lu_##SFX(int64_t b, int64_t m, int64_t bn, const void* l11,   \
                                      int64_t ld11, const void* l21, int64_t ld21,         \
                                      void* a1l, int64_t ld1, void* a2l, int64_t ld2,      \
                                      void* piv, int grid, void* cand, void* rowj,         \
                                      void* pval, void* pidx, void* stream) {              \
    return launch_lu_pu<T>(b, m, bn, l11, ld11, l21, ld21, a1l, ld1, a2l, ld2, piv, grid,  \
                           cand, rowj, pval, pidx, static_cast<cudaStream_t>(stream));     \
  }                                                                                        \
  extern "C" int repro_fused_chol_grid_##SFX(int64_t m, int64_t bn, int* grid) {          \
    return cooperative_grid(fused_chol_pu_kernel<T>, chol_pu_smem<T>(bn), m, grid);       \
  }                                                                                        \
  extern "C" int repro_fused_chol_##SFX(int64_t b, int64_t m, int64_t bn, const void* lrow,\
                                        int64_t ldr, const void* l21, int64_t ld21,        \
                                        void* p, int64_t ldp, int grid, void* stream) {    \
    return launch_chol_pu<T>(b, m, bn, lrow, ldr, l21, ld21, p, ldp, grid,                 \
                             static_cast<cudaStream_t>(stream));                           \
  }

REPRO_FUSED_ENTRIES(float, f32)
REPRO_FUSED_ENTRIES(double, f64)
