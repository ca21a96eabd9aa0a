// Householder QR panel (GEQR2 + LARFT) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_qr.py::qr_panel, whose body is
// repro/core/qr.py::qr_unblocked + build_t_matrix: factor an m x nb panel in
// place into R and the Householder vectors below the diagonal, and return
// tau and the compact-WY T with H_1...H_nb = I - V*T*V^T.  A second entry,
// larft, runs only the LARFT part on an explicit (unpacked) V, for the
// solve's Q^T apply, form_q and the qrcp_local panels.
//
// What bounds it on an H100: the panel is a chain of nb dependent columns.
// Each needs two reductions over all m rows (the column norm, then
// w = tau * v^T A[:, j+1:]) before the rank-1 update can start: about
// 2*m*nb^2 flops over 2*m*nb elements, a few flops per byte, and every
// column waits for the one before.  So it is bound by latency (two
// grid-wide barriers a column), not by bytes or flops.
//
// Design: the TPU kernel held the panel in one VMEM residency.  The main
// path's panel is 16384 x 128, 16 MiB in f64, far above one block's 227 KB
// of shared memory, so the panel stays in device memory (it fits the 50 MB
// L2) and a cooperative grid over its rows factors it, as panel_lu.cu does.
// Each block owns a contiguous chunk of rows.  Per column j:
//   1. every block sums the published partial norms in the same order,
//      forms beta, tau and the reflector (beta = -sign(alpha)*|x|, sign(0)
//      = +1; a zero column gives tau = 0 and H = I), scales its rows of v,
//      and publishes its partial of v^T A[:, j+1:]; one grid barrier;
//   2. every block sums those partials in the same order, applies the
//      rank-1 update to its rows, and publishes its partial norm of column
//      j+1; one grid barrier.
// LARFT then follows in the same launch: each block publishes its partial
// Gram V^T V over its rows (the strict upper triangle), the grid sums the
// partials in block order, and block 0 runs the nb-step T recurrence
// T[:j, j] = -tau_j * T[:j, :j] * (V^T V)[:j, j], T[j, j] = tau_j.
//
// Determinism: every cross-block reduction goes through per-block partials
// in device memory, summed in a fixed order; no floating-point atomics.  The
// same input gives the same bits on every run, which keeps la, la2 and rtm
// bitwise equal to mtb.  The kernel is not bitwise equal to its plain
// version (the reductions group differently); it is held to it within a
// relative bound.
#include "dense.cuh"

template <typename T>
__host__ __device__ constexpr size_t qr_smem(int64_t nb) {
  return (nb + PANEL_THREADS) * sizeof(T);
}

// Sum of x over the block's threads in a fixed tree order; every thread
// gets the result.  `red` holds PANEL_THREADS values.
template <typename T>
__device__ T block_sum(T x, T* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = PANEL_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const T r = red[0];
  __syncthreads();
  return r;
}

// V[r, i]: read as stored (an unpacked V), or from a packed panel (unit
// diagonal, zero above it).
template <typename T, bool PACKED>
__device__ __forceinline__ T v_at(const T* v, int64_t ldv, int64_t r, int64_t i) {
  if (!PACKED) return v[r * ldv + i];
  return r > i ? v[r * ldv + i] : (r == i ? T(1) : T(0));
}

// LARFT over a cooperative grid: T (nb x nb, row-major) from V (m x nb) and
// tau.  Pairs (i, j), i < j, are numbered p = j*(j-1)/2 + i.
template <typename T, bool PACKED>
__device__ void larft_grid(int64_t m, int64_t nb, const T* v, int64_t ldv, const T* tau,
                           T* t, T* pgram, T* gram) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  int64_t chunk, r0, r1;
  owned_rows(m, G, blk, &chunk, &r0, &r1);
  const int64_t P = nb * (nb - 1) / 2;

  // partial Gram over the block's rows
  int64_t j = 1, base = 0;  // pair p = base + i lies in column j
  for (int64_t p = tid; p < P; p += PANEL_THREADS) {
    while (p >= base + j) { base += j; ++j; }
    const int64_t i = p - base;
    T acc = T(0);
    for (int64_t r = r0; r < r1; ++r)
      acc = fma(v_at<T, PACKED>(v, ldv, r, i), v_at<T, PACKED>(v, ldv, r, j), acc);
    pgram[blk * P + p] = acc;
  }
  grid.sync();

  // the Gram, summed over the blocks in block order
  for (int64_t p = static_cast<int64_t>(blk) * PANEL_THREADS + tid; p < P;
       p += static_cast<int64_t>(G) * PANEL_THREADS) {
    T acc = T(0);
    for (int g = 0; g < G; ++g) acc += pgram[g * P + p];
    gram[p] = acc;
  }
  grid.sync();
  if (blk != 0) return;

  // the recurrence; row i of T is written and read by one thread only
  for (int64_t jj = 0; jj < nb; ++jj) {
    const T tj = tau[jj];
    const int64_t col = jj * (jj - 1) / 2;
    for (int64_t i = tid; i < nb; i += PANEL_THREADS) {
      T val = T(0);
      if (i < jj) {
        T acc = T(0);
        for (int64_t l = i; l < jj; ++l) acc = fma(t[i * nb + l], gram[col + l], acc);
        val = -tj * acc;
      } else if (i == jj) {
        val = tj;
      }
      t[i * nb + jj] = val;
    }
  }
}

// GEQR2 over a cooperative grid (the note at the top says how).
template <typename T>
__device__ void geqr2_grid(int64_t m, int64_t nb, T* a, int64_t lda, T* tau, T* pw,
                           T* pn, unsigned char* smem) {
  cg::grid_group grid = cg::this_grid();
  T* w = reinterpret_cast<T*>(smem);  // [nb]
  T* red = w + nb;                     // [PANEL_THREADS]
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  int64_t chunk, r0, r1;
  owned_rows(m, G, blk, &chunk, &r0, &r1);
  const int64_t steps = min(m, nb);

  {  // partial norm of column 0
    T s = T(0);
    for (int64_t r = r0 + tid; r < r1; r += PANEL_THREADS) s = fma(a[r * lda], a[r * lda], s);
    s = block_sum(s, red);
    if (tid == 0) pn[blk] = s;
  }
  grid.sync();

  for (int64_t j = 0; j < steps; ++j) {
    // 1. the reflector, the same in every block
    T ss = T(0);
    for (int g = 0; g < G; ++g) ss += pn[g];
    const T alpha = a[j * lda + j];
    const T xnorm = sqrt(ss);
    const bool safe = xnorm > T(0);
    const T beta = alpha >= T(0) ? -xnorm : xnorm;
    const T tj = safe ? (beta - alpha) / beta : T(0);
    const T denom = safe ? alpha - beta : T(1);
    for (int64_t r = max(r0, j + 1) + tid; r < r1; r += PANEL_THREADS)
      a[r * lda + j] = a[r * lda + j] / denom;
    __syncthreads();
    const int64_t rs = max(r0, j);
    for (int64_t i = j + 1 + tid; i < nb; i += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t r = rs; r < r1; ++r)
        acc = fma(r == j ? T(1) : a[r * lda + j], a[r * lda + i], acc);
      pw[blk * nb + i] = acc;
    }
    grid.sync();

    // 2. w = tau * v^T A[:, j+1:], then the rank-1 update of own rows
    for (int64_t i = j + 1 + tid; i < nb; i += PANEL_THREADS) {
      T acc = T(0);
      for (int g = 0; g < G; ++g) acc += pw[g * nb + i];
      w[i] = tj * acc;
    }
    __syncthreads();
    const int64_t wc = nb - j - 1;
    if (rs < r1 && wc > 0) {
      const int64_t total = (r1 - rs) * wc;
      for (int64_t e = tid; e < total; e += PANEL_THREADS) {
        const int64_t r = rs + e / wc, i = j + 1 + e % wc;
        const T vr = r == j ? T(1) : a[r * lda + j];
        a[r * lda + i] = fma(-vr, w[i], a[r * lda + i]);
      }
    }
    if (tid == 0 && j >= r0 && j < r1) a[j * lda + j] = safe ? beta : alpha;
    if (tid == 0 && blk == 0) tau[j] = tj;
    __syncthreads();
    if (j + 1 < steps) {  // partial norm of column j+1 over rows >= j+1
      T s = T(0);
      for (int64_t r = max(r0, j + 1) + tid; r < r1; r += PANEL_THREADS)
        s = fma(a[r * lda + j + 1], a[r * lda + j + 1], s);
      s = block_sum(s, red);
      if (tid == 0) pn[blk] = s;
    }
    grid.sync();
  }
}

// The workspace `ws` of one launch of G blocks holds, in this order, the
// partials of w (G*nb), of the norm (G), of the Gram (G*P) and the Gram
// itself (P), P = nb*(nb-1)/2 pairs; the wrapper sizes it.
template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
qr_panel_kernel(int64_t m, int64_t nb, T* a, int64_t lda, T* tau, T* t, T* ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t G = gridDim.x, P = nb * (nb - 1) / 2;
  T* pw = ws;
  T* pn = pw + G * nb;
  T* pgram = pn + G;
  T* gram = pgram + G * P;
  geqr2_grid<T>(m, nb, a, lda, tau, pw, pn, smem_raw);
  larft_grid<T, true>(m, nb, a, lda, tau, t, pgram, gram);
}

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
larft_kernel(int64_t m, int64_t nb, const T* v, int64_t ldv, const T* tau, T* t, T* ws) {
  const int64_t G = gridDim.x, P = nb * (nb - 1) / 2;
  T* pgram = ws + G * nb + G;
  larft_grid<T, false>(m, nb, v, ldv, tau, t, pgram, pgram + G * P);
}

template <typename T>
static cudaError_t launch_qr(int64_t m, int64_t nb, void* a, int64_t lda, void* tau,
                             void* t, int grid, void* ws, cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  T* ap = static_cast<T*>(a);
  T* tp = static_cast<T*>(tau);
  T* tt = static_cast<T*>(t);
  T* wp = static_cast<T*>(ws);
  void* args[] = {&m, &nb, &ap, &lda, &tp, &tt, &wp};
  return launch_cooperative(qr_panel_kernel<T>, grid, qr_smem<T>(nb), args, stream);
}

template <typename T>
static cudaError_t launch_larft(int64_t m, int64_t nb, const void* v, int64_t ldv,
                                const void* tau, void* t, int grid, void* ws,
                                cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  const T* vp = static_cast<const T*>(v);
  const T* tp = static_cast<const T*>(tau);
  T* tt = static_cast<T*>(t);
  T* wp = static_cast<T*>(ws);
  void* args[] = {&m, &nb, &vp, &ldv, &tp, &tt, &wp};
  return launch_cooperative(larft_kernel<T>, grid, 0, args, stream);
}

extern "C" int repro_qr_panel_grid_f32(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(qr_panel_kernel<float>, qr_smem<float>(nb), m, grid);
}

extern "C" int repro_qr_panel_grid_f64(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(qr_panel_kernel<double>, qr_smem<double>(nb), m, grid);
}

extern "C" int repro_larft_grid_f32(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(larft_kernel<float>, 0, m, grid);
}

extern "C" int repro_larft_grid_f64(int64_t m, int64_t nb, int* grid) {
  return cooperative_grid(larft_kernel<double>, 0, m, grid);
}

extern "C" int repro_qr_panel_f32(int64_t m, int64_t nb, void* a, int64_t lda, void* tau,
                                  void* t, int grid, void* ws, void* stream) {
  return launch_qr<float>(m, nb, a, lda, tau, t, grid, ws, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_qr_panel_f64(int64_t m, int64_t nb, void* a, int64_t lda, void* tau,
                                  void* t, int grid, void* ws, void* stream) {
  return launch_qr<double>(m, nb, a, lda, tau, t, grid, ws, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_larft_f32(int64_t m, int64_t nb, const void* v, int64_t ldv,
                               const void* tau, void* t, int grid, void* ws, void* stream) {
  return launch_larft<float>(m, nb, v, ldv, tau, t, grid, ws, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_larft_f64(int64_t m, int64_t nb, const void* v, int64_t ldv,
                               const void* tau, void* t, int grid, void* ws, void* stream) {
  return launch_larft<double>(m, nb, v, ldv, tau, t, grid, ws, static_cast<cudaStream_t>(stream));
}
