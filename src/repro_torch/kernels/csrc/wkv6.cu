// WKV6 chunked recurrence (RWKV6 "Finch" time mix), forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6_fused (_wkv_kernel).
// For each (batch, head) the state S (dk x dv, float32) is carried across
// chunks of c rows; per chunk, with cum the inclusive cumulative sum of
// logw over the chunk's rows, wtot its last row and clip(x) = min(max(x,
// -80), 80):
//   r_in  = r * exp(clip(cum - logw)),  k_out = k * exp(clip(-cum)),
//   out   = r_in S + tril(r_in k_out^T, -1) v + (sum_i r u k) v,
//   S    <- exp(clip(wtot))^T * S + (k * exp(clip(wtot - cum)))^T v.
// Two differences from the TPU kernel, both needed by
// repro_torch.models.rwkv6.wkv6_chunked: the state starts from s0 (the TPU
// kernel starts from zero), and S need not be a multiple of c (the TPU
// kernel asserts it): a short last chunk is processed as it is, which
// equals the reference's zero padding exactly (padded rows have logw = 0
// and k = v = 0, so they add nothing and leave wtot as it is).  r, k, v are
// float32 or bfloat16, converted to float32 on load; logw, u, s0, out and
// the final state are float32; dk = dv = D, 32 or 64; c <= 128.
//
// What bounds it on an H100: per chunk and head 2 c dk dv (r_in S) +
// c(c-1) dk (the strict score triangle) + c(c-1) dv (scores times v) +
// 2 c dk dv (the state update) flops, about 4.2 Mflop at c 128, D 64, over
// c (3 dk + dv) input elements: some 60 flops a byte with bfloat16 r, k, v,
// above the ridge of the CUDA cores' 67 TFLOP/s in float32, so it is bound
// by operations.  This version computes in float32 FMA on the CUDA cores;
// tensor cores are later work.
//
// Design: the TPU grid is (B*H, S/c), the chunk axis sequential, S in VMEM
// scratch.  Hopper's blocks run in no order, so here one block of 256
// threads owns one (batch*head) stream and loops over its chunks, keeping
// S in shared memory.  The columns of S evolve independently (column j
// reads only v[:, j]), so the grid also splits dv into 32-column slices:
// (B*H, D/32) blocks, each recomputing only the cumsum, the factors and the
// score tile.  Per chunk, in shared memory (float32, rows padded by 4):
// r then r_in, k then k_fwd, k_out, logw then cum (whose space then holds
// the 128 x 128 score tile), the block's v columns and S slice: 197 KiB at
// D 64, one block an SM.  The cumsum runs in 256/D segments per channel
// (segment sums, then each segment from its offset).  The products use
// register tiles: r_in S and the scores times v 4 rows x 4 columns a
// thread, the score tile 8 x 8 (rows 8py.., columns px + 16b, so a quarter
// warp reads eight consecutive k_out rows without bank conflicts), the
// state update 2 x 4; score columns at or above the diagonal are skipped
// and rows at or past the chunk's end are skipped a warp (16 rows) at a
// time.  Each product sums in the order of its index, in float32 FMA.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int C = 128;          // the most rows of a chunk
constexpr int JB = 32;          // columns of S, v and out a block owns
constexpr int THREADS = 256;
constexpr int LDV = JB + 4;     // row stride of v and S in shared memory
constexpr int LDP = C + 4;      // row stride of the score tile
constexpr float CLIP = 80.0f;

// Offsets into shared memory, in floats (each a multiple of 4).
template <int D>
struct Layout {
  static constexpr int LD = D + 4;                // row stride of r, k, logw
  static constexpr int R = 0;                     // r, then r_in
  static constexpr int K = R + C * LD;            // k, then k_fwd
  static constexpr int KO = K + C * LD;           // k_out
  static constexpr int W = KO + C * LD;           // logw, cum, then scores
  static constexpr int V = W + (C * LDP > C * LD ? C * LDP : C * LD);
  static constexpr int S = V + C * LDV;           // D x JB slice of S
  static constexpr int PART = S + D * LDV;        // segment sums of logw
  static constexpr int WTOT = PART + THREADS;
  static constexpr int DECAY = WTOT + D;
  static constexpr int U = DECAY + D;
  static constexpr int BONUS = U + D;
  static constexpr int TOTAL = BONUS + C;
};

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -CLIP), CLIP));
}

__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Load the 16 bytes at src as floats.
__device__ __forceinline__ void load16(const float* src, float* out) {
  float4 x = *reinterpret_cast<const float4*>(src);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* out) {
  uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// rows x WIDTH elements at src (row stride ld_src) into a float tile of
// row stride LD.
template <typename T, int LD, int WIDTH>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t ld_src, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = WIDTH / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int row = i / PER_ROW;
    const int col = (i % PER_ROW) * VEC;
    float vals[VEC];
    load16(src + int64_t(row) * ld_src + col, vals);
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dst + row * LD + col + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sfin, int64_t H,
            int64_t S, int c) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int NSEG = THREADS / D;     // cumsum segments: 4 (D 64), 8 (D 32)
  constexpr int SEG = C / NSEG;         // rows a segment
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Rs = sm + L::R;
  float* Ks = sm + L::K;
  float* KOs = sm + L::KO;
  float* Ws = sm + L::W;
  float* Ps = sm + L::W;                // over logw/cum once those are done
  float* Vs = sm + L::V;
  float* Ss = sm + L::S;
  float* part = sm + L::PART;
  float* wtot = sm + L::WTOT;
  float* decay = sm + L::DECAY;
  float* us = sm + L::U;
  float* bonus = sm + L::BONUS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t bh = blockIdx.x;
  const int64_t h = bh % H;
  const int j0 = blockIdx.y * JB;
  const int seg = tid / D, ch = tid % D;          // the cumsum
  const int ty = tid / 8, tx = tid % 8;           // out rows 4ty + q, columns
                                                  // 4tx..; S rows ty + 32a
  const int py = tid / 16, px = tid % 16;         // score rows 8py + a,
                                                  // columns px + 16b
  const int warp_row = 16 * warp;                 // both row maps: 16 a warp

  for (int i = tid; i < D * JB; i += THREADS) {
    const int a = i / JB, j = i % JB;
    Ss[a * LDV + j] = s0 == nullptr ? 0.0f : s0[(bh * D + a) * D + j0 + j];
  }
  if (tid < D) us[tid] = u[h * D + tid];

  const int64_t nchunks = (S + c - 1) / c;
  for (int64_t ci = 0; ci < nchunks; ++ci) {
    const int64_t t0 = ci * c;
    const int n = int(S - t0 < c ? S - t0 : c);
    const int64_t row0 = bh * S + t0;
    __syncthreads();   // the previous chunk is done with every buffer
    load_rows<T, LD, D>(Rs, r + row0 * D, D, n);
    load_rows<T, LD, D>(Ks, k + row0 * D, D, n);
    load_rows<float, LD, D>(Ws, logw + row0 * D, D, n);
    load_rows<T, LDV, JB>(Vs, v + row0 * D + j0, D, n);
    // v rows up to the next multiple of 4 are read (times a zero score)
    for (int i = tid; i < (((n + 3) & ~3) - n) * JB; i += THREADS)
      Vs[(n + i / JB) * LDV + i % JB] = 0.0f;
    __syncthreads();

    // the bonus sum_i r u k of each row; the segment sums of logw
    for (int t = warp; t < n; t += THREADS / 32) {
      float x = 0.0f;
      for (int i = lane; i < D; i += 32)
        x += Rs[t * LD + i] * (us[i] * Ks[t * LD + i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) bonus[t] = x;
    }
    const int lo = seg * SEG, hi = n < lo + SEG ? n : lo + SEG;
    {
      float p = 0.0f;
      for (int t = lo; t < hi; ++t) p += Ws[t * LD + ch];
      part[seg * D + ch] = p;
    }
    __syncthreads();

    // cum, r_in and k_out, each segment from the sum of the ones before it
    {
      float cum = 0.0f;
      for (int q = 0; q < seg; ++q) cum += part[q * D + ch];
      for (int t = lo; t < hi; ++t) {
        const float lw = Ws[t * LD + ch];
        cum += lw;
        Rs[t * LD + ch] *= clip_exp(cum - lw);
        KOs[t * LD + ch] = Ks[t * LD + ch] * clip_exp(-cum);
        Ws[t * LD + ch] = cum;
      }
      if (lo < n && hi == n) wtot[ch] = cum;
    }
    __syncthreads();

    // k_fwd over k; the chunk's decay of S
    for (int i = tid; i < n * D; i += THREADS) {
      const int t = i / D, a = i % D;
      Ks[t * LD + a] *= clip_exp(wtot[a] - Ws[t * LD + a]);
    }
    if (tid < D) decay[tid] = clip_exp(wtot[tid]);
    __syncthreads();

    const bool live = warp_row < n;     // the warp has a row of this chunk
    float acc[4][4];
    if (live) {
      // inter = r_in S
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = 0.0f;
#pragma unroll 2
      for (int i = 0; i < D; i += 4) {
        float4 ra[4], sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ra[q] = *reinterpret_cast<const float4*>(Rs + (4 * ty + q) * LD + i);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sv[e] = *reinterpret_cast<const float4*>(Ss + (i + e) * LDV + 4 * tx);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[q][j] = fmaf(at(ra[q], e), at(sv[e], j), acc[q][j]);
      }

      // the strict lower triangle of r_in k_out^T into the score tile
      const int tmax = (n < 8 * py + 8 ? n : 8 * py + 8) - 1;
      float sc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) sc[a][b] = 0.0f;
#pragma unroll 1
      for (int i = 0; i < D; i += 4) {
        float4 ra[8];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          ra[a] = *reinterpret_cast<const float4*>(Rs + (8 * py + a) * LD + i);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (px + 16 * b < tmax) {
            const float4 kb =
                *reinterpret_cast<const float4*>(KOs + (px + 16 * b) * LD + i);
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              float x = sc[a][b];
              x = fmaf(ra[a].x, kb.x, x);
              x = fmaf(ra[a].y, kb.y, x);
              x = fmaf(ra[a].z, kb.z, x);
              x = fmaf(ra[a].w, kb.w, x);
              sc[a][b] = x;
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int t = 8 * py + a;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int s = px + 16 * b;
          Ps[t * LDP + s] = (s < t && t < n) ? sc[a][b] : 0.0f;
        }
      }
    }
    __syncthreads();

    if (live) {
      // intra = scores v + bonus v; out = inter + intra
      float in[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) in[q][j] = 0.0f;
      const int s_end = n < warp_row + 16 ? n : warp_row + 16;
#pragma unroll 2
      for (int s = 0; s < s_end; s += 4) {
        float4 pa[4], vb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[q] = *reinterpret_cast<const float4*>(Ps + (4 * ty + q) * LDP + s);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vb[e] = *reinterpret_cast<const float4*>(Vs + (s + e) * LDV + 4 * tx);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              in[q][j] = fmaf(at(pa[q], e), at(vb[e], j), in[q][j]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * ty + q;
        if (t >= n) continue;
        const float4 vt = *reinterpret_cast<const float4*>(Vs + t * LDV + 4 * tx);
        const float bt = bonus[t];
        const float4 o = make_float4(acc[q][0] + (in[q][0] + bt * vt.x),
                                     acc[q][1] + (in[q][1] + bt * vt.y),
                                     acc[q][2] + (in[q][2] + bt * vt.z),
                                     acc[q][3] + (in[q][3] + bt * vt.w));
        *reinterpret_cast<float4*>(out + (row0 + t) * D + j0 + 4 * tx) = o;
      }
    }

    // S <- decay * S + k_fwd^T v (r_in S was read before the last barrier)
    {
      float st[D / 32][4];
#pragma unroll
      for (int a = 0; a < D / 32; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[a][j] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + t * LDV + 4 * tx);
#pragma unroll
        for (int a = 0; a < D / 32; ++a) {
          const float kf = Ks[t * LD + ty + 32 * a];
#pragma unroll
          for (int j = 0; j < 4; ++j) st[a][j] = fmaf(kf, at(vv, j), st[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < D / 32; ++a) {
        const int i = ty + 32 * a;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[i * LDV + 4 * tx + j] = decay[i] * Ss[i * LDV + 4 * tx + j] + st[a][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < D * JB; i += THREADS) {
    const int a = i / JB, j = i % JB;
    sfin[(bh * D + a) * D + j0 + j] = Ss[a * LDV + j];
  }
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* out,
                   void* sfin, int64_t B, int64_t H, int64_t S, int c,
                   cudaStream_t stream) {
  auto kernel = wkv6_kernel<T, D>;
  const size_t smem = sizeof(float) * Layout<D>::TOTAL;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(unsigned(B * H), unsigned(D / JB));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sfin), H, S, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0,
                     void* out, void* sfin, int64_t B, int64_t H, int64_t S,
                     int64_t D, int64_t c, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (S < 0 || c < 1 || c > C || B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<T, 32>(r, k, v, logw, u, s0, out, sfin, B, H, S, int(c), st);
    case 64: return launch<T, 64>(r, k, v, logw, u, s0, out, sfin, B, H, S, int(c), st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_wkv6_f32(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* s0,
                              void* out, void* sfin, int64_t B, int64_t H,
                              int64_t S, int64_t D, int64_t c, void* stream) {
  return dispatch<float>(r, k, v, logw, u, s0, out, sfin, B, H, S, D, c,
                         stream);
}

extern "C" int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                               const void* logw, const void* u, const void* s0,
                               void* out, void* sfin, int64_t B, int64_t H,
                               int64_t S, int64_t D, int64_t c, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, logw, u, s0, out, sfin, B, H, S, D,
                                 c, stream);
}
