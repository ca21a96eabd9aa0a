// Triangular solves for Hopper (sm_90a): left TRSM, right transposed TRSM
// and the fused small LU solve.
//
// Replaces the TPU kernels repro/kernels/trsm.py::trsm_left_lower (L*X = B,
// unit or not) -- here with an upper mode too, for the back sweep that the
// reference sends to its library solve -- ::trsm_right_lower_t (X*L^T = B,
// the Cholesky L21 solve, which the reference computes by transposing around
// trsm_left_lower) and ::lu_solve_small (forward unit-lower then backward
// upper substitution on a packed LU in one residency).
//
// What bounds it on an H100: at b = 128 the solve does b*b flops per
// right-hand side against 2*b*8 bytes of it in f64 -- about 8 flop/byte,
// bytes-bound in principle, but the substitution is a chain of dependent
// steps per right-hand side, so in practice it is bound by latency.
//
// Design: one thread per right-hand side, NC = 32 of them (one warp) per
// block, so every right-hand side is independent of the others and the
// kernel is column-decomposable like the GEMM.  A left solve's right-hand
// side is a column of B; a right transposed solve's is a row of B, since
// X*L^T = B is L*x = b for every row -- so the right mode only reads and
// writes B and X by the other stride, with no transposed copy.  The thread's
// vector lives in shared memory (b x NC values, conflict-free since each
// thread reads its own bank); the triangle is read through the cache, every
// lane of a warp reading the same element (a broadcast).  The row sums are
// solve_vector of dense.cuh, which the fused Cholesky panel update shares:
//   x[i] = (b[i] - sum_j T[i, j] * x[j]) / T[i, i]
// with the sum taken in ascending j for a lower and descending j for an
// upper triangle -- the order in which the plain column-sweep version
// subtracts -- so the two differ only by FMA rounding.  X may alias B.
// b * NC * sizeof(T) of dynamic shared memory reaches 64 KiB at b = 256 in
// f64, above the 48 KiB default, so the launch raises the limit first.
#include "dense.cuh"

constexpr int NC = 32;        // right-hand-side columns per block
constexpr int64_t MAX_B = 256;

// RIGHT: the right-hand side `rhs` is row `rhs` of B (X*L^T = B, LOWER
// only); otherwise column `rhs` of B.
template <typename T, bool LOWER, bool UNIT, bool RIGHT>
__global__ void __launch_bounds__(NC)
trsm_kernel(int64_t b, int64_t n, const T* __restrict__ t, int64_t ldt,
            const T* B, int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int64_t rhs = static_cast<int64_t>(blockIdx.x) * NC + threadIdx.x;
  if (rhs >= n) return;
  for (int64_t i = 0; i < b; ++i) x[i * NC] = RIGHT ? B[rhs * ldb + i] : B[i * ldb + rhs];
  solve_vector<T, LOWER, UNIT>(b, t, ldt, x, NC);
  for (int64_t i = 0; i < b; ++i) {
    if (RIGHT) X[rhs * ldx + i] = x[i * NC];
    else X[i * ldx + rhs] = x[i * NC];
  }
}

template <typename T>
__global__ void __launch_bounds__(NC)
lu_solve_kernel(int64_t n, int64_t nrhs, const T* __restrict__ lu, int64_t ldl,
                const T* B, int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * NC + threadIdx.x;
  if (col >= nrhs) return;
  for (int64_t i = 0; i < n; ++i) x[i * NC] = B[i * ldb + col];
  solve_vector<T, true, true>(n, lu, ldl, x, NC);    // L*y = b (unit lower)
  solve_vector<T, false, false>(n, lu, ldl, x, NC);  // U*x = y
  for (int64_t i = 0; i < n; ++i) X[i * ldx + col] = x[i * NC];
}

template <typename Kernel, typename... Args>
static cudaError_t launch_columns(Kernel kernel, int64_t rows, int64_t cols,
                                  size_t elem, cudaStream_t stream,
                                  Args... args) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  if (rows > MAX_B) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(rows) * NC * elem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((cols + NC - 1) / NC), NC, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_trsm(int64_t b, int64_t n, int lower, int unit,
                               const void* t, int64_t ldt, const void* B,
                               int64_t ldb, void* X, int64_t ldx,
                               cudaStream_t s) {
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  if (lower && unit)
    return launch_columns(trsm_kernel<T, true, true, false>, b, n, sizeof(T), s, b, n, tp, ldt, bp, ldb, xp, ldx);
  if (lower)
    return launch_columns(trsm_kernel<T, true, false, false>, b, n, sizeof(T), s, b, n, tp, ldt, bp, ldb, xp, ldx);
  if (unit)
    return launch_columns(trsm_kernel<T, false, true, false>, b, n, sizeof(T), s, b, n, tp, ldt, bp, ldb, xp, ldx);
  return launch_columns(trsm_kernel<T, false, false, false>, b, n, sizeof(T), s, b, n, tp, ldt, bp, ldb, xp, ldx);
}

// X*L^T = B for B with m rows: m right-hand sides of length b.
template <typename T>
static cudaError_t launch_trsm_right(int64_t b, int64_t m, int unit,
                                     const void* t, int64_t ldt, const void* B,
                                     int64_t ldb, void* X, int64_t ldx,
                                     cudaStream_t s) {
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  if (unit)
    return launch_columns(trsm_kernel<T, true, true, true>, b, m, sizeof(T), s, b, m, tp, ldt, bp, ldb, xp, ldx);
  return launch_columns(trsm_kernel<T, true, false, true>, b, m, sizeof(T), s, b, m, tp, ldt, bp, ldb, xp, ldx);
}

template <typename T>
static cudaError_t launch_lu_solve(int64_t n, int64_t nrhs, const void* lu,
                                   int64_t ldl, const void* B, int64_t ldb,
                                   void* X, int64_t ldx, cudaStream_t s) {
  return launch_columns(lu_solve_kernel<T>, n, nrhs, sizeof(T), s, n, nrhs,
                        static_cast<const T*>(lu), ldl, static_cast<const T*>(B),
                        ldb, static_cast<T*>(X), ldx);
}

extern "C" int repro_trsm_f32(int64_t b, int64_t n, int lower, int unit,
                              const void* t, int64_t ldt, const void* B,
                              int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_trsm<float>(b, n, lower, unit, t, ldt, B, ldb, X, ldx,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_f64(int64_t b, int64_t n, int lower, int unit,
                              const void* t, int64_t ldt, const void* B,
                              int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_trsm<double>(b, n, lower, unit, t, ldt, B, ldb, X, ldx,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_right_f32(int64_t b, int64_t m, int unit,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx,
                                    void* stream) {
  return launch_trsm_right<float>(b, m, unit, t, ldt, B, ldb, X, ldx,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_right_f64(int64_t b, int64_t m, int unit,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx,
                                    void* stream) {
  return launch_trsm_right<double>(b, m, unit, t, ldt, B, ldb, X, ldx,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int repro_lu_solve_f32(int64_t n, int64_t nrhs, const void* lu,
                                  int64_t ldl, const void* B, int64_t ldb,
                                  void* X, int64_t ldx, void* stream) {
  return launch_lu_solve<float>(n, nrhs, lu, ldl, B, ldb, X, ldx,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_lu_solve_f64(int64_t n, int64_t nrhs, const void* lu,
                                  int64_t ldl, const void* B, int64_t ldb,
                                  void* X, int64_t ldx, void* stream) {
  return launch_lu_solve<double>(n, nrhs, lu, ldl, B, ldb, X, ldx,
                                 static_cast<cudaStream_t>(stream));
}
