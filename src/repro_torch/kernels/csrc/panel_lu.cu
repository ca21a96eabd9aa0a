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
// version bit for bit and the pivots agree.  The column loop is getf2_grid
// of dense.cuh, which the fused LU panel update (fused_pu.cu) shares.
#include "dense.cuh"

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
panel_lu_kernel(int64_t m, int64_t nb, T* a, int64_t lda, int32_t* piv,
                T* cand, T* rowj, T* pval, int64_t* pidx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  getf2_grid<T>(m, nb, a, lda, piv, cand, rowj, pval, pidx, smem_raw);
}

template <typename T>
static cudaError_t launch_panel(int64_t m, int64_t nb, void* a, int64_t lda,
                                void* piv, int grid, void* cand, void* rowj,
                                void* pval, void* pidx, cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  T* ap = static_cast<T*>(a);
  int32_t* pp = static_cast<int32_t*>(piv);
  T* cp = static_cast<T*>(cand);
  T* rp = static_cast<T*>(rowj);
  T* vp = static_cast<T*>(pval);
  int64_t* ip = static_cast<int64_t*>(pidx);
  void* args[] = {&m, &nb, &ap, &lda, &pp, &cp, &rp, &vp, &ip};
  return launch_cooperative(panel_lu_kernel<T>, grid, getf2_smem<T>(nb), args, stream);
}

extern "C" int repro_panel_lu_grid_f32(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(panel_lu_kernel<float>, getf2_smem<float>(nb), m, grid);
}

extern "C" int repro_panel_lu_grid_f64(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(panel_lu_kernel<double>, getf2_smem<double>(nb), m, grid);
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
