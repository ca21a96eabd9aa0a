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
// Design: a cooperative grid of G blocks of GETF2_THREADS threads, one
// block an SM (G = SMs for tall panels, fewer for short ones: at least
// GETF2_MIN_ROWS rows a block).  Each block owns a contiguous chunk of rows.
//   * Rows resident: where the chunk fits shared memory (62 rows of 128 in
//     f64 at 8192 rows, 63.5 KB; up to about 27000 rows on 132 SMs) the
//     block loads it once, factors all nb columns there and writes it back
//     once.  Otherwise the same code runs on the rows in device memory (the
//     streamed route); the plan picks the route by shape and takes every m
//     and nb.
//   * One grid barrier a column.  The pass that applies column j's update
//     also finds the block's first largest |a[i, j+1]| (the lane of column
//     j + 1 keeps its warp's); the block then publishes (value, row) and a
//     copy of that row, and the owner of row j + 1 publishes that row.
//     After the barrier warp 0 of every block reduces the G maxima (first
//     index on ties, as jnp.argmax; NaN never wins) with a shuffle
//     butterfly and reads the pivot row from the winner's copy in L2 into
//     shared memory: one dependent read.  The slots alternate by the parity
//     of the column, so a block that runs ahead never overwrites a slot
//     another still reads.  Two lighter barriers were tried on the card and
//     not kept, both slower at 8192 x 128: a flag a block, polled by every
//     block, which carries its data (the reads of the published maxima
//     after the polling became the slowest step), and an arrival count with
//     release/acquire instead of the cooperative-groups sync.
//   * The column pass: warps over rows, lanes over columns, 32-bit indices
//     inside the block where its rows are resident; the multipliers
//     div_rn(a[i, j], pivot), the update sub_rn(a, mul_rn(l, u)): each
//     product and difference rounded once, no FMA.
// The grid size comes from the plan (kernels/panel_lu.py::plan), not from
// the kernel body, so a caller can cap it.  A cluster route for short
// panels (distributed shared memory, barrier.cluster) was not built.
//
// Determinism: no atomics take part in any reduction and every comparison
// runs in a fixed order, so the result is the same on every run, bitwise
// lu_unblocked's with equal pivots.  The column loop is getf2_rows of
// dense.cuh, which the fused LU panel update (fused_pu.cu) runs on its own
// residency.
#include <type_traits>

#include "dense.cuh"

// RESIDENT: the block's rows live in shared memory after the GETF2 scratch.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(GETF2_THREADS, 1)
panel_lu_kernel(int64_t m, int64_t nb64, T* a, int64_t lda, int32_t* piv, unsigned char* ws) {
  using I = std::conditional_t<RESIDENT, int, int64_t>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, nb = static_cast<int>(nb64);
  int64_t chunk, r0, r1;
  owned_rows(m, G, blockIdx.x, &chunk, &r0, &r1);
  const Pub<T> pub(ws, G, nb);
  T* res = reinterpret_cast<T*>(smem_raw + getf2_scratch<T>(nb));
  const int n = static_cast<int>(r1 - r0);
  const RowSpan<T, I> A{RESIDENT ? res : a + r0 * lda,
                        RESIDENT ? static_cast<I>(nb) : static_cast<I>(lda), r0, n};
  if (RESIDENT) {
    move_rows<T, true>(res, a + r0 * lda, lda, n, nb);
    __syncthreads();
  }
  getf2_rows(A, m, nb, piv, pub, smem_raw);
  if (RESIDENT) move_rows<T, false>(res, a + r0 * lda, lda, n, nb);
}

// How an m x nb panel runs: out = {blocks, resident (1) or streamed (0),
// rows a block (chunk), dynamic shared memory bytes, workspace bytes,
// threads a block}.
template <typename T>
static cudaError_t lu_plan(int64_t m, int64_t nb, int64_t* out) {
  if (m <= 0 || nb <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = panel_card(&sms, &optin);
  if (err != cudaSuccess) return err;
  int64_t g = (m + GETF2_MIN_ROWS - 1) / GETF2_MIN_ROWS;
  g = g < sms ? g : sms;
  g = g < GETF2_MAX_BLOCKS ? g : GETF2_MAX_BLOCKS;
  const int64_t chunk = (m + g - 1) / g;
  const size_t scratch = getf2_scratch<T>(nb);
  const size_t whole = scratch + static_cast<size_t>(chunk * nb) * sizeof(T);
  bool resident = whole <= static_cast<size_t>(optin);
  if (resident) err = fits_one_block(panel_lu_kernel<T, true>, GETF2_THREADS, whole, &resident);
  if (err != cudaSuccess) return err;
  bool streamed = true;
  if (!resident)
    err = fits_one_block(panel_lu_kernel<T, false>, GETF2_THREADS, scratch, &streamed);
  if (err != cudaSuccess) return err;
  if (!streamed) return cudaErrorInvalidConfiguration;
  out[0] = g;
  out[1] = resident ? 1 : 0;
  out[2] = chunk;
  out[3] = static_cast<int64_t>(resident ? whole : scratch);
  out[4] = static_cast<int64_t>(Pub<T>::bytes(g, nb));
  out[5] = GETF2_THREADS;
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_panel(int64_t m, int64_t nb, void* a, int64_t lda, void* piv, int grid,
                                int resident, int64_t smem, void* ws, cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  T* ap = static_cast<T*>(a);
  int32_t* pp = static_cast<int32_t*>(piv);
  unsigned char* wp = static_cast<unsigned char*>(ws);
  void* args[] = {&m, &nb, &ap, &lda, &pp, &wp};
  auto kernel = resident ? panel_lu_kernel<T, true> : panel_lu_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(GETF2_THREADS), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int repro_panel_lu_plan_f32(int64_t m, int64_t nb, int64_t* out) {
  return lu_plan<float>(m, nb, out);
}

extern "C" int repro_panel_lu_plan_f64(int64_t m, int64_t nb, int64_t* out) {
  return lu_plan<double>(m, nb, out);
}

extern "C" int repro_panel_lu_f32(int64_t m, int64_t nb, void* a, int64_t lda, void* piv,
                                  int grid, int resident, int64_t smem, void* ws, void* stream) {
  return launch_panel<float>(m, nb, a, lda, piv, grid, resident, smem, ws,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_panel_lu_f64(int64_t m, int64_t nb, void* a, int64_t lda, void* piv,
                                  int grid, int resident, int64_t smem, void* ws, void* stream) {
  return launch_panel<double>(m, nb, a, lda, piv, grid, resident, smem, ws,
                              static_cast<cudaStream_t>(stream));
}
