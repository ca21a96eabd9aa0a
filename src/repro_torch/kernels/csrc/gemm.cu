// GEMM / GEMM-accumulate for Hopper (sm_90a): O = beta*C + alpha*A*B.
//
// Replaces the TPU kernels repro/kernels/blis_gemm.py::blis_gemm (C = A*B)
// and ::blis_gemm_accum (O = C + alpha*A*B, the DMF trailing update).
//
// What bounds it on an H100: the trailing update of LU at b = 128 has
// K = 128, so per output element it does 2*128 flops against the read and
// write of C -- 16 flop/byte in f64, 32 in f32, around the card's ridge of
// 67 TFLOP/s over 3.35 TB/s = 20 flop/byte.  The large f64 updates are
// bound by bytes, the f32 ones by operations; small tiles by latency.
//
// Design: each block computes a BM x BN tile of O from BK-deep slices of A
// and B staged in shared memory (alpha folded into the A slice), and each
// thread keeps a TM x TN register block of accumulators, its rows and
// columns strided across the tile so loads and stores coalesce.  FP32/FP64
// FMA on the CUDA cores; no tensor cores, so no TF32 for float.
//
// Determinism: an element's sum starts from beta*C and adds its K products
// in ascending k with one accumulator, whatever M, N or the tile -- no
// split-K, no shape-dependent K blocking.  So a column (or row) of O does
// not depend on which other columns share the call, which is what keeps the
// look-ahead schedules bitwise equal to the blocked one.  O may alias C
// (in-place trailing update): each element is read once and written once by
// the same thread.  The accumulator step is gemm_step of dense.cuh, which
// the fused panel updates (fused_pu.cu) share.
#include "dense.cuh"

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(int64_t M, int64_t N, int64_t K, T alpha,
            const T* __restrict__ A, int64_t lda,
            const T* __restrict__ B, int64_t ldb,
            T beta, const T* C, int64_t ldc, T* O, int64_t ldo) {
  constexpr int TX = BN / TN;            // threads along N
  constexpr int TY = BM / TM;            // threads along M
  constexpr int NT = TX * TY;
  __shared__ T As[BK][BM + 1];           // alpha*A slice, transposed
  __shared__ T Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = m0 + ty + i * TY, c = n0 + tx + j * TX;
      acc[i][j] = (beta != T(0) && r < M && c < N) ? beta * C[r * ldc + c] : T(0);
    }
  }

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = e / BK, kk = e % BK;
      const int64_t r = m0 + mm, k = k0 + kk;
      As[kk][mm] = (r < M && k < K) ? alpha * A[r * lda + k] : T(0);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, nn = e % BN;
      const int64_t k = k0 + kk, c = n0 + nn;
      Bs[kk][nn] = (k < K && c < N) ? B[k * ldb + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = gemm_step(acc[i][j], a[i], b[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t r = m0 + ty + i * TY, c = n0 + tx + j * TX;
      if (r < M && c < N) O[r * ldo + c] = acc[i][j];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static cudaError_t launch_gemm(int64_t M, int64_t N, int64_t K, double alpha,
                               const void* A, int64_t lda, const void* B,
                               int64_t ldb, double beta, const void* C,
                               int64_t ldc, void* O, int64_t ldo,
                               cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int64_t gy = (M + BM - 1) / BM;
  if (gy > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((N + BN - 1) / BN), static_cast<unsigned>(gy));
  dim3 block((BM / TM) * (BN / TN));
  gemm_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      M, N, K, static_cast<T>(alpha), static_cast<const T*>(A), lda,
      static_cast<const T*>(B), ldb, static_cast<T>(beta),
      static_cast<const T*>(C), ldc, static_cast<T*>(O), ldo);
  return cudaGetLastError();
}

extern "C" int repro_gemm_f32(int64_t M, int64_t N, int64_t K, double alpha,
                              const void* A, int64_t lda, const void* B,
                              int64_t ldb, double beta, const void* C,
                              int64_t ldc, void* O, int64_t ldo, void* stream) {
  return launch_gemm<float, 128, 128, 8, 8, 8>(
      M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, O, ldo,
      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_gemm_f64(int64_t M, int64_t N, int64_t K, double alpha,
                              const void* A, int64_t lda, const void* B,
                              int64_t ldb, double beta, const void* C,
                              int64_t ldc, void* O, int64_t ldo, void* stream) {
  return launch_gemm<double, 64, 64, 8, 4, 4>(
      M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, O, ldo,
      static_cast<cudaStream_t>(stream));
}
