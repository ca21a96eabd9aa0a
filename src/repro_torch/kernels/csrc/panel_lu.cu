// GETF2 panel factorization with partial pivoting for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_lu.py::lu_panel, whose body is
// repro/core/lu.py::lu_unblocked: factor an m x nb panel in place into the
// packed L\U and return panel-relative int32 pivots.
//
// What bounds it on an H100: the panel is a chain of nb dependent columns,
// each a pivot search over the column, a row interchange and a rank-1 update
// of what is left -- m*nb^2 flops over 2*m*nb elements, a few flops per
// byte, and every column waits for the one before.  So it is bound by
// latency: the per-column synchronisation, not bytes or flops.
//
// Design: the TPU kernel held the whole panel in one VMEM residency.  At the
// main path's 8192 x 128 the panel is 4 MiB in f32 and 8 MiB in f64, far
// above the 227 KB of shared memory of one block, so here the panel stays in
// device memory (it fits the 50 MB L2) and a cooperative grid of up to two
// blocks per SM factors it together.  Each block owns a contiguous chunk of
// rows.  Per column j:
//   A. each block finds the first largest |a[i, j]| over its rows i >= j,
//      publishes (value, index) and a copy of that candidate row, and the
//      owner of row j publishes row j; one grid-wide barrier;
//   B. every block reduces the published maxima in the same order (first
//      index on ties, as jnp.argmax), takes the pivot row from its owner's
//      copy, swaps rows j and p where it owns them, scales its rows below j
//      by the pivot (a division, as the reference) and applies the rank-1
//      update to its own rows.
// The published buffers alternate between two slots by the parity of j, so
// one barrier per column suffices.  No atomics take part in any reduction:
// the result is deterministic.  Products and differences of the update are
// rounded once each (no FMA), so the kernel repeats its plain PyTorch
// version bit for bit and the pivots agree.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int PANEL_THREADS = 256;
constexpr int64_t ROWS_PER_BLOCK = 32;
constexpr int MAX_BLOCKS_PER_SM = 2;

// (v, i) ranks above (bv, bi): larger value, or the same value at a smaller
// row.  NaN never ranks above anything.
template <typename T>
__device__ __forceinline__ bool better(T v, int64_t i, T bv, int64_t bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
panel_lu_kernel(int64_t m, int64_t nb, T* a, int64_t lda, int32_t* piv,
                T* cand, T* rowj, T* pval, int64_t* pidx) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* ri = reinterpret_cast<int64_t*>(smem_raw);  // [PANEL_THREADS]
  T* rv = reinterpret_cast<T*>(ri + PANEL_THREADS);    // [PANEL_THREADS]
  T* urow = rv + PANEL_THREADS;                         // [nb] pivot row
  __shared__ int64_t s_p;

  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int64_t chunk = (m + G - 1) / G;
  const int64_t r0 = min(m, blk * chunk), r1 = min(m, r0 + chunk);
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

template <typename T>
static size_t panel_smem(int64_t nb) {
  return PANEL_THREADS * (sizeof(int64_t) + sizeof(T)) + nb * sizeof(T);
}

// Blocks of the cooperative grid: enough for ROWS_PER_BLOCK rows each, at
// most MAX_BLOCKS_PER_SM per SM and never more than can be resident at once.
template <typename T>
static cudaError_t panel_grid(int64_t m, int64_t nb, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = panel_smem<T>(nb);
  if (err == cudaSuccess) err = allow_smem(panel_lu_kernel<T>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, panel_lu_kernel<T>,
                                                        PANEL_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int64_t cap = static_cast<int64_t>(sms) * std::min(per_sm, MAX_BLOCKS_PER_SM);
  *grid = static_cast<int>(std::max<int64_t>(1, std::min(want, cap)));
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_panel(int64_t m, int64_t nb, void* a, int64_t lda,
                                void* piv, int grid, void* cand, void* rowj,
                                void* pval, void* pidx, cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  if (grid < 1) return cudaErrorInvalidValue;
  T* ap = static_cast<T*>(a);
  int32_t* pp = static_cast<int32_t*>(piv);
  T* cp = static_cast<T*>(cand);
  T* rp = static_cast<T*>(rowj);
  T* vp = static_cast<T*>(pval);
  int64_t* ip = static_cast<int64_t*>(pidx);
  void* args[] = {&m, &nb, &ap, &lda, &pp, &cp, &rp, &vp, &ip};
  const size_t smem = panel_smem<T>(nb);
  cudaError_t err = allow_smem(panel_lu_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(panel_lu_kernel<T>),
                                    dim3(grid), dim3(PANEL_THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int repro_panel_lu_grid_f32(int64_t m, int64_t nb, int* grid) {
  return panel_grid<float>(m, nb, grid);
}

extern "C" int repro_panel_lu_grid_f64(int64_t m, int64_t nb, int* grid) {
  return panel_grid<double>(m, nb, grid);
}

extern "C" int repro_panel_lu_f32(int64_t m, int64_t nb, void* a, int64_t lda,
                                  void* piv, int grid, void* cand, void* rowj,
                                  void* pval, void* pidx, void* stream) {
  return launch_panel<float>(m, nb, a, lda, piv, grid, cand, rowj, pval, pidx,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_panel_lu_f64(int64_t m, int64_t nb, void* a, int64_t lda,
                                  void* piv, int grid, void* cand, void* rowj,
                                  void* pval, void* pidx, void* stream) {
  return launch_panel<double>(m, nb, a, lda, piv, grid, cand, rowj, pval, pidx,
                              static_cast<cudaStream_t>(stream));
}
