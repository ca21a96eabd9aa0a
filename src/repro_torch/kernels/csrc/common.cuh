// Shared helpers of the port's CUDA sources (plain C interface, no PyTorch
// headers).  Every library exports repro_error_string so the Python loader
// can turn a returned cudaError_t into text.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Raise the dynamic shared-memory limit of `kernel` when a launch needs more
// than the default 48 KiB; a launch above the limit is refused otherwise.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Products and differences rounded once each, never contracted into an FMA,
// where a kernel must repeat its plain PyTorch version bit for bit.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies where the source rows are 16-byte aligned, one
// element a copy where they are not; the bytes past `bytes` are zero-filled.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

template <int SIZE>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(SIZE), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// A row-major matrix (base `ptr`, leading dimension `ld`) whose rows all
// start 16-byte aligned.
static inline bool aligned16(const void* ptr, int64_t ld, size_t size) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (ld * static_cast<int64_t>(size)) % 16 == 0;
}
