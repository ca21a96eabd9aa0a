// Hessenberg panel (xLAHR2) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_hessenberg.py::hessenberg_panel,
// whose body is repro/kernels/panels.py::_hessenberg_sweep: reduce columns
// k .. k+bk-1 of an n x n matrix A.  For panel column j (kj = k + j):
//
//   col  = A[:, kj] - W * (T * V[kj, :]^T)     right update, W = A0 * V
//   col -= V * (T^T * (V^T * col))             left compact-WY apply
//   v_j, tau_j, beta: the reflector zeroing col[kj+2:], v_j[kj+1] = 1
//   A[:, kj] = col with beta at kj+1 and v_j below it
//   T[:j, j] = -tau_j * T[:j, :j] * (V^T v_j),  T[j, j] = tau_j
//   W[:, j]  = A * v_j    (columns kj+1 .. n-1 only: v_j is zero at <= kj)
//
// The last two columns of the matrix (kj >= n-2) have no rows to reduce:
// tau_j = 0, v_j = 0, and the updated column is written back.  A is updated
// in place (only its columns k .. k+bk-1 change); V, W (n x bk), T (bk x bk)
// and tau are outputs.  k is a runtime argument, so one build serves every
// panel of a factorization.
//
// What bounds it on an H100: W[:, j] = A * v_j is a GEMV over the columns
// right of kj of every row, so each column streams the trailing part of the
// matrix from device memory once.  At n = 8192 f64 the first panel streams
// 128 * 8192 * 8128 * 8 B, about 68 GB: 20.4 ms at 3.35 TB/s, and a whole
// reduction about 2.2 TB.  The TPU kernel held the whole matrix in VMEM; a
// 512 MiB matrix cannot stay in any on-chip memory of this card (50 MB of
// L2), so the per-column pass over the matrix is this kernel's bound, by
// bytes.  Everything else a column needs is O(n * bk).
//
// Design: a cooperative grid over the matrix's rows, as panel_qrcp.cu.  Each
// block owns a contiguous chunk of rows and streams their contiguous row
// segments in the GEMV, one warp per group of four rows (each v_j element is
// read once per four rows).  Per column, four grid-wide barriers:
//   A. every block forms s = T * V[kj, :]^T, brings its rows of the column
//      through the right update and publishes its partials of V^T col;
//   B. every block sums those partials, forms z = T^T u, applies the left
//      update to its rows and publishes the partial norm of rows > kj;
//   C. every block forms the same reflector from the summed norm, writes its
//      rows of v_j, of A[:, kj] and of a contiguous copy of v_j, and
//      publishes its partials of V^T v_j;
//   D. every block runs the GEMV for its rows; block 0 sums the partials of
//      V^T v_j and writes T's column j.
// Every cross-block sum goes through per-block partials summed in block
// order, with no atomics, and each GEMV row is summed in a fixed lane order
// and a fixed shuffle tree: the same input gives the same bits on every run,
// so the rtm schedule stays bitwise equal to mtb.  The kernel is held to its
// plain PyTorch version within a relative bound (the sums group differently).
#include "dense.cuh"

constexpr int HESS_WARPS = PANEL_THREADS / 32;
constexpr int HESS_ROWS = 4;  // rows a warp streams at once in the GEMV

template <typename T>
__host__ __device__ constexpr size_t hess_smem(int64_t bk) {
  return (2 * bk + PANEL_THREADS) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
hessenberg_panel_kernel(int64_t n, int64_t k, int64_t bk, T* a, int64_t lda, T* v, T* t,
                        T* w, T* tau, T* cw, T* vb, T* pu, T* pn, T* pt) {
  // cw: n (the column being reduced); vb: n (v_j, contiguous);
  // pu, pt: G*bk (partials of V^T col, V^T v_j); pn: G (partial norms)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s1 = reinterpret_cast<T*>(smem_raw);  // [bk] s, then u, then V^T v_j
  T* s2 = s1 + bk;                         // [bk] z
  T* red = s2 + bk;                        // [PANEL_THREADS]
  __shared__ T s_norm, s_alpha;

  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  int64_t chunk, r0, r1;
  owned_rows(n, G, blk, &chunk, &r0, &r1);

  for (int64_t j = 0; j < bk; ++j) {
    const int64_t kj = k + j;

    // A. right update of the own rows of column kj; partials of V^T col
    for (int64_t l = tid; l < j; l += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t i = l; i < j; ++i) acc = fma(t[l * bk + i], v[kj * bk + i], acc);
      s1[l] = acc;
    }
    __syncthreads();
    for (int64_t r = r0 + tid; r < r1; r += PANEL_THREADS) {
      T x = a[r * lda + kj];
      for (int64_t l = 0; l < j; ++l) x = fma(-w[r * bk + l], s1[l], x);
      cw[r] = x;
    }
    __syncthreads();
    for (int64_t i = tid; i < j; i += PANEL_THREADS) {
      T acc = T(0);  // v_i is zero at rows <= k + i
      for (int64_t r = max(r0, k + i + 1); r < r1; ++r) acc = fma(v[r * bk + i], cw[r], acc);
      pu[blk * bk + i] = acc;
    }
    grid.sync();

    // B. u = V^T col, z = T^T u; left update of the own rows; partial norm
    for (int64_t i = tid; i < j; i += PANEL_THREADS) {
      T acc = T(0);
      for (int g = 0; g < G; ++g) acc += pu[g * bk + i];
      s1[i] = acc;
    }
    __syncthreads();
    for (int64_t l = tid; l < j; l += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t i = 0; i <= l; ++i) acc = fma(t[i * bk + l], s1[i], acc);
      s2[l] = acc;
    }
    __syncthreads();
    T ss = T(0);
    for (int64_t r = r0 + tid; r < r1; r += PANEL_THREADS) {
      T x = cw[r];
      if (r > k) {
        for (int64_t l = 0; l < j; ++l) x = fma(-v[r * bk + l], s2[l], x);
        cw[r] = x;
      }
      if (r > kj) ss = fma(x, x, ss);
    }
    red[tid] = ss;
    __syncthreads();
    for (int s = PANEL_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) pn[blk] = red[0];
    grid.sync();

    // C. the reflector, the same in every block; v_j and A[:, kj]
    if (tid == 0) {
      T s = T(0);
      for (int g = 0; g < G; ++g) s += pn[g];
      s_norm = s;
      s_alpha = kj + 1 < n ? cw[kj + 1] : T(0);
    }
    __syncthreads();
    const bool valid = kj < n - 2;  // rows kj+2.. exist: reduce them
    const T alpha = s_alpha;
    const T xnorm = sqrt(s_norm);
    const bool safe = xnorm > T(0);
    const T beta = alpha >= T(0) ? -xnorm : xnorm;
    const T tj = valid && safe ? (beta - alpha) / beta : T(0);
    const T denom = safe ? alpha - beta : T(1);
    const T diag = safe ? beta : alpha;
    for (int64_t r = r0 + tid; r < r1; r += PANEL_THREADS) {
      const T x = cw[r];
      T vr = T(0), an = x;
      if (valid && r > kj + 1) {
        vr = x / denom;
        an = vr;
      } else if (valid && r == kj + 1) {
        vr = T(1);
        an = diag;
      }
      a[r * lda + kj] = an;
      v[r * bk + j] = vr;
      vb[r] = vr;
    }
    __syncthreads();
    for (int64_t i = tid; i < j; i += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t r = max(r0, kj + 1); r < r1; ++r) acc = fma(v[r * bk + i], vb[r], acc);
      pt[blk * bk + i] = acc;
    }
    if (blk == 0 && tid == 0) tau[j] = tj;
    grid.sync();

    // D. W[:, j] = A * v_j over columns kj+1.., four rows per warp; T[:, j]
    for (int64_t r = r0 + warp * HESS_ROWS; r < r1; r += HESS_WARPS * HESS_ROWS) {
      const int nr = static_cast<int>(min(static_cast<int64_t>(HESS_ROWS), r1 - r));
      const T* row = a + r * lda;
      T acc[HESS_ROWS];
#pragma unroll
      for (int q = 0; q < HESS_ROWS; ++q) acc[q] = T(0);
#pragma unroll 4
      for (int64_t c = kj + 1 + lane; c < n; c += 32) {
        const T y = vb[c];
#pragma unroll
        for (int q = 0; q < HESS_ROWS; ++q)
          if (q < nr) acc[q] = fma(row[q * lda + c], y, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < HESS_ROWS; ++q) {
        T x = acc[q];
        for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0 && q < nr) w[(r + q) * bk + j] = x;
      }
    }
    if (blk == 0) {
      for (int64_t i = tid; i < j; i += PANEL_THREADS) {
        T acc = T(0);
        for (int g = 0; g < G; ++g) acc += pt[g * bk + i];
        s1[i] = acc;
      }
      __syncthreads();
      for (int64_t i = tid; i < j; i += PANEL_THREADS) {
        T acc = T(0);
        for (int64_t l = i; l < j; ++l) acc = fma(t[i * bk + l], s1[l], acc);
        t[i * bk + j] = -tj * acc;
      }
      if (tid == 0) t[j * bk + j] = tj;
    }
    grid.sync();
  }
}

template <typename T>
static cudaError_t launch_hessenberg(int64_t n, int64_t k, int64_t bk, void* a, int64_t lda,
                                     void* v, void* t, void* w, void* tau, int grid, void* ws,
                                     cudaStream_t stream) {
  if (n <= 0 || bk <= 0) return cudaSuccess;
  T* ap = static_cast<T*>(a);
  T* vp = static_cast<T*>(v);
  T* tp = static_cast<T*>(t);
  T* wp = static_cast<T*>(w);
  T* taup = static_cast<T*>(tau);
  T* cw = static_cast<T*>(ws);
  T* vb = cw + n;
  T* pu = vb + n;
  T* pn = pu + static_cast<int64_t>(grid) * bk;
  T* pt = pn + grid;
  void* args[] = {&n, &k, &bk, &ap, &lda, &vp, &tp, &wp, &taup, &cw, &vb, &pu, &pn, &pt};
  return launch_cooperative(hessenberg_panel_kernel<T>, grid, hess_smem<T>(bk), args, stream);
}

extern "C" int repro_hessenberg_panel_grid_f32(int64_t n, int64_t bk, int* grid) {
  return cooperative_grid(hessenberg_panel_kernel<float>, hess_smem<float>(bk), n, grid);
}

extern "C" int repro_hessenberg_panel_grid_f64(int64_t n, int64_t bk, int* grid) {
  return cooperative_grid(hessenberg_panel_kernel<double>, hess_smem<double>(bk), n, grid);
}

extern "C" int repro_hessenberg_panel_f32(int64_t n, int64_t k, int64_t bk, void* a,
                                          int64_t lda, void* v, void* t, void* w, void* tau,
                                          int grid, void* ws, void* stream) {
  return launch_hessenberg<float>(n, k, bk, a, lda, v, t, w, tau, grid, ws,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int repro_hessenberg_panel_f64(int64_t n, int64_t k, int64_t bk, void* a,
                                          int64_t lda, void* v, void* t, void* w, void* tau,
                                          int grid, void* ws, void* stream) {
  return launch_hessenberg<double>(n, k, bk, a, lda, v, t, w, tau, grid, ws,
                                   static_cast<cudaStream_t>(stream));
}
