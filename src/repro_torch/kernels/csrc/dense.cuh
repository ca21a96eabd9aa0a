// Element routines shared by the kernels that must round alike.
//
// The look-ahead schedules are bitwise equal to the blocked one only if
// every kernel that computes part of a step rounds exactly as the kernel it
// stands in for.  The fused panel updates (fused_pu.cu) replace a TRSM, a
// GEMM-accumulate and a panel factorization, so they share these routines
// with gemm.cu and panel_lu.cu instead of retyping them.  trsm.cu runs
// solve_vector only in its chain kernel (the contract, on no path) and in
// the small LU solve; its strip kernel keeps solve_vector's order term for
// term and is held to the chain kernel bitwise:
//
//   gemm_step     one term of the GEMM accumulator: acc + a*b in one FMA,
//                 with alpha already folded into a, k ascending;
//   solve_vector  one right-hand side of a triangular solve: the row sums of
//                 x[i] = (b[i] - sum_j T[i, j] * x[j]) / T[i, i], one FMA a
//                 term, ascending j for a lower and descending j for an upper
//                 triangle;
//   getf2_grid    the GETF2 column loop of a cooperative grid over a panel in
//                 device memory (the note in panel_lu.cu says how it works);
//                 products and differences rounded once each, no FMA.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ T gemm_step(T acc, T a, T b) { return fma(a, b, acc); }

// x[i * xs], i < b, is one right-hand side, solved in place.  The triangle
// may live in device or shared memory.
template <typename T, bool LOWER, bool UNIT>
__device__ void solve_vector(int64_t b, const T* t, int64_t ldt, T* x, int64_t xs) {
  if (LOWER) {
    for (int64_t i = 0; i < b; ++i) {
      T acc = x[i * xs];
      for (int64_t j = 0; j < i; ++j) acc = fma(-t[i * ldt + j], x[j * xs], acc);
      if (!UNIT) acc = div_rn(acc, t[i * ldt + i]);
      x[i * xs] = acc;
    }
  } else {
    for (int64_t i = b - 1; i >= 0; --i) {
      T acc = x[i * xs];
      for (int64_t j = b - 1; j > i; --j) acc = fma(-t[i * ldt + j], x[j * xs], acc);
      if (!UNIT) acc = div_rn(acc, t[i * ldt + i]);
      x[i * xs] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Cooperative grids over the rows of a panel.
// ---------------------------------------------------------------------------
constexpr int PANEL_THREADS = 256;
constexpr int64_t ROWS_PER_BLOCK = 32;
constexpr int MAX_BLOCKS_PER_SM = 2;

// The rows [r0, r1) that block `blk` of `G` owns in an m-row panel.
__device__ __forceinline__ void owned_rows(int64_t m, int G, int blk, int64_t* chunk,
                                           int64_t* r0, int64_t* r1) {
  *chunk = (m + G - 1) / G;
  *r0 = min(m, blk * *chunk);
  *r1 = min(m, *r0 + *chunk);
}

// Blocks of a cooperative grid over m rows: enough for ROWS_PER_BLOCK rows
// each, at most MAX_BLOCKS_PER_SM per SM and never more than can be
// resident at once with `smem` bytes of dynamic shared memory each.
template <typename Kernel>
static cudaError_t cooperative_grid(Kernel kernel, size_t smem, int64_t m, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PANEL_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int64_t cap = static_cast<int64_t>(sms) * (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM);
  const int64_t g = want < cap ? want : cap;
  *grid = static_cast<int>(g > 1 ? g : 1);
  return cudaSuccess;
}

template <typename Kernel>
static cudaError_t launch_cooperative(Kernel kernel, int grid, size_t smem, void** args,
                                      cudaStream_t stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(PANEL_THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GETF2 with partial pivoting on a cooperative grid.
// ---------------------------------------------------------------------------
// (v, i) ranks above (bv, bi): larger value, or the same value at a smaller
// row.  NaN never ranks above anything.
template <typename T>
__device__ __forceinline__ bool better(T v, int64_t i, T bv, int64_t bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__host__ __device__ constexpr size_t getf2_smem(int64_t nb) {
  return PANEL_THREADS * (sizeof(int64_t) + sizeof(T)) + nb * sizeof(T);
}

// Factor the m x nb panel `a` in place; piv[j] gets the panel-relative pivot
// of column j.  Every block of the grid calls it; `smem` holds getf2_smem(nb)
// bytes; cand/rowj/pval/pidx are the double-buffered publication slots
// (2*G*nb, 2*nb, 2*G, 2*G elements).
template <typename T>
__device__ void getf2_grid(int64_t m, int64_t nb, T* a, int64_t lda, int32_t* piv,
                           T* cand, T* rowj, T* pval, int64_t* pidx, unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  int64_t* ri = reinterpret_cast<int64_t*>(smem);  // [PANEL_THREADS]
  T* rv = reinterpret_cast<T*>(ri + PANEL_THREADS); // [PANEL_THREADS]
  T* urow = rv + PANEL_THREADS;                      // [nb] pivot row
  __shared__ int64_t s_p;

  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  int64_t chunk, r0, r1;
  owned_rows(m, G, blk, &chunk, &r0, &r1);
  const int64_t steps = min(m, nb);

  for (int64_t j = 0; j < steps; ++j) {
    const int64_t buf = j & 1;
    T* cand_b = cand + buf * G * nb;   // [G][nb] candidate rows
    T* rowj_b = rowj + buf * nb;       // row j before the interchange
    T* pval_b = pval + buf * G;        // [G] block maxima
    int64_t* pidx_b = pidx + buf * G;  // [G] their rows

    // A. block-local pivot search over rows max(r0, j) .. r1-1
    T bv = T(-1);
    int64_t bi = m;
    for (int64_t i = max(r0, j) + tid; i < r1; i += PANEL_THREADS) {
      const T v = fabs(a[i * lda + j]);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    rv[tid] = bv;
    ri[tid] = bi;
    __syncthreads();
    for (int s = PANEL_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s && better(rv[tid + s], ri[tid + s], rv[tid], ri[tid])) {
        rv[tid] = rv[tid + s];
        ri[tid] = ri[tid + s];
      }
      __syncthreads();
    }
    const int64_t lbi = ri[0];
    if (tid == 0) {
      pval_b[blk] = rv[0];
      pidx_b[blk] = lbi;
    }
    if (lbi < m)
      for (int64_t c = tid; c < nb; c += PANEL_THREADS) cand_b[blk * nb + c] = a[lbi * lda + c];
    if (j >= r0 && j < r1)
      for (int64_t c = tid; c < nb; c += PANEL_THREADS) rowj_b[c] = a[j * lda + c];
    grid.sync();

    // B. global pivot, in the same order in every block
    if (tid == 0) {
      T gv = T(-1);
      int64_t gi = m;
      for (int g = 0; g < G; ++g) {
        const int64_t i = pidx_b[g];
        const T v = pval_b[g];
        if (i < m && better(v, i, gv, gi)) { gv = v; gi = i; }
      }
      s_p = gi < m ? gi : j;  // an all-NaN column keeps row j
    }
    __syncthreads();
    const int64_t p = s_p;
    const T* src = p == j ? rowj_b : cand_b + (p / chunk) * nb;
    for (int64_t c = tid; c < nb; c += PANEL_THREADS) urow[c] = src[c];
    if (blk == 0 && tid == 0) piv[j] = static_cast<int32_t>(p);
    __syncthreads();

    if (p != j) {  // row interchange j <-> p, each row by its owner
      if (j >= r0 && j < r1)
        for (int64_t c = tid; c < nb; c += PANEL_THREADS) a[j * lda + c] = urow[c];
      if (p >= r0 && p < r1)
        for (int64_t c = tid; c < nb; c += PANEL_THREADS) a[p * lda + c] = rowj_b[c];
    }
    __syncthreads();

    const T pivot = urow[j];
    const int64_t i0 = max(r0, j + 1);
    for (int64_t i = i0 + tid; i < r1; i += PANEL_THREADS)
      a[i * lda + j] = div_rn(a[i * lda + j], pivot);
    __syncthreads();

    const int64_t w = nb - j - 1;
    if (r1 > i0 && w > 0) {
      const int64_t total = (r1 - i0) * w;
      for (int64_t e = tid; e < total; e += PANEL_THREADS) {
        const int64_t i = i0 + e / w, c = j + 1 + e % w;
        a[i * lda + c] = sub_rn(a[i * lda + c], mul_rn(a[i * lda + j], urow[c]));
      }
    }
    __syncthreads();
  }
}
