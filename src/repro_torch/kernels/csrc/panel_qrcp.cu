// QR panel with column pivoting (xLAQPS) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_qrcp.py::qrcp_panel, whose body
// is repro/kernels/panels.py::_qrcp_sweep: over an r x c trailing block, for
// `steps` columns j, pick the trailing column of largest partial norm
// (first index on ties), swap it into place (B, F and the norms), bring
// column j current (B[j:, j] -= V[j:, :j] * F[j, :j]), form its Householder
// reflector, extend F = B0^T * V * T by one column
// (F[:, j] = tau * (B^T v - F * (V^T v))), complete pivot row j of every
// trailing column (B[j, i] -= V[j, :j+1] * F[i, :j+1]) and downdate the
// norms exactly (vn[i] = max(vn[i] - B[j, i]^2, 0)).  The block is updated
// in place; V (r x steps), F (c x steps, stored as F^T: steps x c), tau and
// the panel-relative int32 pivots are outputs.  Global QRCP hands it the
// whole trailing block, qrcp_local the bare panel window.
//
// What bounds it on an H100: F[:, j] needs B^T v over the whole block at
// every step, so each step streams the block from device memory once.  At
// the main path's first panel the block is 16384 x 4096 f64, 512 MiB; 128
// steps read it 128 times, about 64 GiB, some 20 ms at 3.35 TB/s.  The TPU
// kernel kept the block in VMEM for the whole sweep; 512 MiB cannot stay in
// any on-chip memory of this card (50 MB of L2), so the per-step pass over
// the block is this kernel's bound, by bytes.  A window of 128 columns
// (qrcp_local) is 16 MiB and stays in L2.
//
// Design: a cooperative grid over the block's rows, as panel_qr.cu.  Each
// block owns a contiguous chunk of rows, and the columns are spread over
// all threads of the grid.  Per step j, three grid-wide barriers:
//   A. every block finds the pivot p from the norms (the same result in
//      every block), swaps columns j and p of its rows, brings its rows of
//      column j current and publishes the partial norm of the new column;
//   B. every block forms the reflector, writes its rows of v, and publishes
//      its partials of B^T v (every column) and V^T v; block 0 swaps rows j
//      and p of F;
//   C. each column's owner sums those partials in block order, writes
//      F[i, j], completes B[j, i] and downdates its norm.
// The norms alternate between two buffers by the parity of j, so no step
// overwrites norms another block may still be reading.  Every cross-block
// sum goes through per-block partials summed in a fixed order, with no
// atomics: the same input gives the same bits, and the same pivots, on every
// run.  The kernel is held to its plain version within a relative bound,
// pivots equal.
#include "dense.cuh"

template <typename T>
__host__ __device__ constexpr size_t qrcp_smem(int64_t steps) {
  return 3 * steps * sizeof(T) + PANEL_THREADS * (sizeof(T) + sizeof(int64_t));
}

template <typename T>
__global__ void __launch_bounds__(PANEL_THREADS)
qrcp_panel_kernel(int64_t r, int64_t c, int64_t steps, T* b, int64_t ldb, T* v, T* ft,
                  T* tau, int32_t* piv, T* vn, T* pw, T* pu, T* pn) {
  // vn: 2*c (two buffers); pw: G*c; pu: G*steps; pn: G
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* ri = reinterpret_cast<int64_t*>(smem_raw);  // [PANEL_THREADS]
  T* rv = reinterpret_cast<T*>(ri + PANEL_THREADS);     // [PANEL_THREADS]
  T* fp = rv + PANEL_THREADS;                           // [steps] F[p, :j]
  T* u = fp + steps;                                    // [steps] V^T v
  T* vrow = u + steps;                                  // [steps] V[j, :]
  __shared__ int64_t s_p;
  __shared__ T s_sum;

  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int64_t gt = static_cast<int64_t>(blk) * PANEL_THREADS + tid;
  const int64_t gstride = static_cast<int64_t>(G) * PANEL_THREADS;
  int64_t chunk, r0, r1;
  owned_rows(r, G, blk, &chunk, &r0, &r1);

  // initial norms: partials over own rows, then summed per column
  for (int64_t i = tid; i < c; i += PANEL_THREADS) {
    T s = T(0);
    for (int64_t q = r0; q < r1; ++q) s = fma(b[q * ldb + i], b[q * ldb + i], s);
    pw[blk * c + i] = s;
  }
  grid.sync();
  for (int64_t i = gt; i < c; i += gstride) {
    T s = T(0);
    for (int g = 0; g < G; ++g) s += pw[g * c + i];
    vn[i] = s;
  }
  grid.sync();

  for (int64_t j = 0; j < steps; ++j) {
    const T* vcur = vn + (j & 1) * c;
    T* vnext = vn + ((j + 1) & 1) * c;

    // A. the pivot: the first largest norm over columns >= j
    T bv = T(-1);
    int64_t bi = c;
    for (int64_t i = j + tid; i < c; i += PANEL_THREADS) {
      const T x = vcur[i];
      if (better(x, i, bv, bi)) { bv = x; bi = i; }
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
    if (tid == 0) s_p = ri[0] < c ? ri[0] : j;
    for (int64_t l = tid; l < j; l += PANEL_THREADS) fp[l] = ft[l * c + (ri[0] < c ? ri[0] : j)];
    __syncthreads();
    const int64_t p = s_p;
    if (blk == 0 && tid == 0) piv[j] = static_cast<int32_t>(p);

    // swap columns j and p of own rows; bring rows >= j of column j current
    T ss = T(0);
    for (int64_t q = r0 + tid; q < r1; q += PANEL_THREADS) {
      T x = b[q * ldb + p];
      if (p != j) b[q * ldb + p] = b[q * ldb + j];
      if (q >= j) {
        for (int64_t l = 0; l < j; ++l) x = fma(-v[q * steps + l], fp[l], x);
        ss = fma(x, x, ss);
      }
      b[q * ldb + j] = x;
    }
    rv[tid] = ss;
    __syncthreads();
    for (int s = PANEL_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) rv[tid] += rv[tid + s];
      __syncthreads();
    }
    if (tid == 0) pn[blk] = rv[0];
    grid.sync();

    // B. the reflector, the same in every block
    if (tid == 0) {
      T s = T(0);
      for (int g = 0; g < G; ++g) s += pn[g];
      s_sum = s;
    }
    __syncthreads();
    const T alpha = b[j * ldb + j];
    const T xnorm = sqrt(s_sum);
    const bool safe = xnorm > T(0);
    const T beta = alpha >= T(0) ? -xnorm : xnorm;
    const T tj = safe ? (beta - alpha) / beta : T(0);
    const T denom = safe ? alpha - beta : T(1);
    const T diag = safe ? beta : alpha;
    const int64_t rs = max(r0, j);
    for (int64_t q = rs + tid; q < r1; q += PANEL_THREADS) {
      if (q == j) {
        v[q * steps + j] = T(1);
      } else {
        const T vq = b[q * ldb + j] / denom;
        v[q * steps + j] = vq;
        b[q * ldb + j] = vq;
      }
    }
    __syncthreads();
    // partials of B^T v (column j as its new value: beta on the diagonal)
    for (int64_t i = tid; i < c; i += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t q = rs; q < r1; ++q) {
        const T bq = (q == j && i == j) ? diag : b[q * ldb + i];
        acc = fma(v[q * steps + j], bq, acc);
      }
      pw[blk * c + i] = acc;
    }
    // partials of V^T v over the earlier reflectors
    for (int64_t l = tid; l < j; l += PANEL_THREADS) {
      T acc = T(0);
      for (int64_t q = rs; q < r1; ++q) acc = fma(v[q * steps + l], v[q * steps + j], acc);
      pu[blk * steps + l] = acc;
    }
    if (blk == 0) {
      if (p != j)
        for (int64_t l = tid; l < j; l += PANEL_THREADS) {
          const T x = ft[l * c + j];
          ft[l * c + j] = ft[l * c + p];
          ft[l * c + p] = x;
        }
      if (tid == 0) tau[j] = tj;
    }
    grid.sync();

    // C. F[:, j], pivot row j and the norm downdate, per column
    for (int64_t l = tid; l < j; l += PANEL_THREADS) {
      T acc = T(0);
      for (int g = 0; g < G; ++g) acc += pu[g * steps + l];
      u[l] = acc;
    }
    for (int64_t l = tid; l <= j; l += PANEL_THREADS) vrow[l] = v[j * steps + l];
    __syncthreads();
    for (int64_t i = gt; i < c; i += gstride) {
      T w = T(0);
      for (int g = 0; g < G; ++g) w += pw[g * c + i];
      for (int64_t l = 0; l < j; ++l) w = fma(-ft[l * c + i], u[l], w);
      const T fij = tj * w;
      ft[j * c + i] = fij;
      if (i > j) {
        T x = b[j * ldb + i];
        for (int64_t l = 0; l < j; ++l) x = fma(-vrow[l], ft[l * c + i], x);
        x = fma(-vrow[j], fij, x);
        b[j * ldb + i] = x;
        const int64_t src = i == p ? j : i;
        const T d = vcur[src] - x * x;
        vnext[i] = d > T(0) ? d : T(0);
      } else {
        if (i == j) b[j * ldb + j] = diag;
        vnext[i] = T(0);
      }
    }
    grid.sync();
  }
}

template <typename T>
static cudaError_t launch_qrcp(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                               void* v, void* ft, void* tau, void* piv, int grid, void* ws,
                               cudaStream_t stream) {
  if (r <= 0 || c <= 0 || steps <= 0) return cudaSuccess;
  T* bp = static_cast<T*>(b);
  T* vp = static_cast<T*>(v);
  T* fp = static_cast<T*>(ft);
  T* tp = static_cast<T*>(tau);
  int32_t* pp = static_cast<int32_t*>(piv);
  T* vn = static_cast<T*>(ws);
  T* pw = vn + 2 * c;
  T* pu = pw + static_cast<int64_t>(grid) * c;
  T* pn = pu + static_cast<int64_t>(grid) * steps;
  void* args[] = {&r, &c, &steps, &bp, &ldb, &vp, &fp, &tp, &pp, &vn, &pw, &pu, &pn};
  return launch_cooperative(qrcp_panel_kernel<T>, grid, qrcp_smem<T>(steps), args, stream);
}

extern "C" int repro_qrcp_panel_grid_f32(int64_t r, int64_t steps, int* grid) {
  return cooperative_grid(qrcp_panel_kernel<float>, qrcp_smem<float>(steps), r, grid);
}

extern "C" int repro_qrcp_panel_grid_f64(int64_t r, int64_t steps, int* grid) {
  return cooperative_grid(qrcp_panel_kernel<double>, qrcp_smem<double>(steps), r, grid);
}

extern "C" int repro_qrcp_panel_f32(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                                    void* v, void* ft, void* tau, void* piv, int grid, void* ws,
                                    void* stream) {
  return launch_qrcp<float>(r, c, steps, b, ldb, v, ft, tau, piv, grid, ws,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int repro_qrcp_panel_f64(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                                    void* v, void* ft, void* tau, void* piv, int grid, void* ws,
                                    void* stream) {
  return launch_qrcp<double>(r, c, steps, b, ldb, v, ft, tau, piv, grid, ws,
                             static_cast<cudaStream_t>(stream));
}
