// Flash attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention.py::flash_attention
// (_flash_kernel): out = softmax(q·kᵀ·scale + mask)·v per (batch, head),
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), query head h reading KV head
// h / (H / Hkv).  Scores, the running max and denominator and the output
// accumulator are float32 for float32 and bfloat16 inputs alike; masked
// scores are -1e30 (not -inf), as in the reference, so a row that is masked
// in every key it has seen so far carries the same values; out = acc / l
// with l == 0 -> 1; the output is written in the input dtype.  The mask is
// that of repro/models/layers.py::_attn_mask: key j is visible to query i
// when qpos[i] >= kpos[j] (causal), for int32 position vectors; with
// qpos = kpos = arange(S) this is the Pallas kernel's top-left iota mask.
//
// What bounds it on an H100: 4·Sq·Sk·D flops per (batch, head), halved by
// the causal mask, over (Sq + 2·Sk + Sq)·D elements.  At the serving shape
// (S = 1024, D = 128) that is about 400 flops per byte in bfloat16: far
// above the card's ridge, so it is bound by operations.  This first version
// computes in float32 on the CUDA cores (67 TFLOP/s), not on the tensor
// cores, so it runs well above the bfloat16 bound; mma/wgmma and TMA are
// later work.
//
// Design: the TPU kernel walks a (B·H, Sq/bq, Sk/bk) grid in order and
// carries m, l and acc in VMEM scratch across the innermost kv axis.  Here
// one block of 256 threads owns one 64-row query tile of one (batch, head)
// and walks the kv tiles in a loop inside the block, so the carried state
// never leaves the SM: m and l per row in registers, acc (64 x D) in
// registers, 4 rows x D/16 columns per thread.  Q stays in shared memory
// as float32; each 64-key tile of K, then of V, is streamed through one
// shared buffer (K is read for S = Q·Kᵀ, then V overwrites it for P·V), so
// a block takes 83 KiB at D = 128 and two blocks share an SM.  Row strides
// of D + 4 and 64 + 4 floats keep the vector reads free of bank conflicts.
// Per tile: S (a thread owns rows 4·ty..4·ty+3 and keys tx, tx+16, tx+32,
// tx+48), the scale, the mask, the row max and sum by shuffles across the
// 16 threads of a row, P to shared memory, then acc = acc·alpha + P·V.
// A tile that the mask hides from every row of the block, once every row
// has seen a visible key, changes nothing (p = exp(-1e30 - m) = 0,
// alpha = 1) and is skipped: with causal positions that is every tile above
// the diagonal, about half the work.  Blocks are ordered heaviest query
// tile first, so the causal imbalance does not leave a tail.  Sq and Sk
// need not be multiples of 64: rows past Sq are not written and keys past
// Sk take no part (score -inf, p = 0).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys
constexpr int LDP = BK + 4;     // row stride of P in shared memory
constexpr float NEG_INF = -1e30f;

template <int D>
__host__ __device__ constexpr int ldq() { return D + 4; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ + BK) * ldq<D>() + size_t(BQ) * LDP);
}

// Load VEC elements at src (16 bytes) as floats.
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

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// rows x D of a row-major (., D) array into a float tile of row stride
// D + 4; rows at or past `nvalid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int nvalid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < BQ * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float vals[VEC];
    if (r < nvalid) {
      load16(src + int64_t(r) * D + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dst + r * ldq<D>() + c + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// Reductions across the 16 threads (tx = 0..15) that share a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned row_or(unsigned x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int32_t* __restrict__ qpos,
                 const int32_t* __restrict__ kpos, int64_t H, int64_t Hkv,
                 int64_t Sq, int64_t Sk, float scale, int causal) {
  constexpr int LDQ = ldq<D>();
  constexpr int CPT = D / 16;               // output columns per thread
  constexpr int W = CPT < 4 ? CPT : 4;      // their vector width
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x LDQ
  float* KVs = Qs + BQ * LDQ;                    // BK x LDQ: K, then V
  float* Ps = KVs + BK * LDQ;                    // BQ x LDP

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;
  const int64_t kvh = b * Hkv + h / (H / Hkv);
  const int64_t q0 = int64_t(gridDim.y - 1 - blockIdx.y) * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qb = q + (bh * Sq + q0) * D;
  const T* kb = k + kvh * Sk * D;
  const T* vb = v + kvh * Sk * D;
  load_tile<T, D>(Qs, qb, int(Sq - q0 < BQ ? Sq - q0 : BQ));

  int qp[4];
  bool row_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty * 4 + r;
    row_ok[r] = row < Sq;
    qp[r] = row_ok[r] ? qpos[row] : 0;
  }
  // rows past Sq count as having seen a key: they never block a skip
  unsigned seen = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) seen |= row_ok[r] ? 0u : (1u << r);

  float m_run[4], l_run[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[r][i] = 0.0f;
  }

  const int64_t n_tiles = (Sk + BK - 1) / BK;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t k0 = t * BK;
    // the mask of this thread's 4 x 4 scores
    int kp[4];
    bool in_range[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = k0 + tx + 16 * j;
      in_range[j] = col < Sk;
      kp[j] = in_range[j] ? kpos[col] : 0;
    }
    bool hidden = true;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hidden &= !row_ok[r] || !in_range[j] || (causal && qp[r] < kp[j]);
    // also the barrier after the previous tile's reads of KVs and Ps
    if (__syncthreads_and(hidden && seen == 0xfu)) continue;

    load_tile<T, D>(KVs, kb + k0 * D, int(Sk - k0 < BK ? Sk - k0 : BK));
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + r) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[r][j];
          x = fmaf(qa[r].x, ka[j].x, x);
          x = fmaf(qa[r].y, ka[j].y, x);
          x = fmaf(qa[r].z, ka[j].z, x);
          x = fmaf(qa[r].w, ka[j].w, x);
          s[r][j] = x;
        }
    }

    // scale, mask, online softmax
    unsigned visible = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[r][j] * scale;
        if (!in_range[j]) {
          x = __int_as_float(0xff800000);   // -inf
        } else if (causal && qp[r] < kp[j]) {
          x = NEG_INF;
        } else {
          visible |= 1u << r;
        }
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[r], row_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = expf(s[r][j] - m_new);
        ls += s[r][j];
      }
      l_run[r] = l_run[r] * alpha + row_sum(ls);
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[r][i] *= alpha;
    }
    seen |= row_or(visible);

    __syncthreads();   // every read of K is done: V may overwrite it
    load_tile<T, D>(KVs, vb + k0 * D, int(Sk - k0 < BK ? Sk - k0 : BK));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + r) * LDP + tx + 16 * j] = s[r][j];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[r] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + r) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = KVs + (kk + u) * LDQ + tx * W;
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT / W; ++c) {
          if constexpr (W == 4) {
            float4 x = *reinterpret_cast<const float4*>(vrow + c * 16 * W);
            vv[c * 4] = x.x; vv[c * 4 + 1] = x.y;
            vv[c * 4 + 2] = x.z; vv[c * 4 + 3] = x.w;
          } else {
            float2 x = *reinterpret_cast<const float2*>(vrow + c * 16 * W);
            vv[c * 2] = x.x; vv[c * 2 + 1] = x.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = u == 0 ? pa[r].x : u == 1 ? pa[r].y
                        : u == 2 ? pa[r].z : pa[r].w;
#pragma unroll
          for (int i = 0; i < CPT; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
  }

  T* ob = o + (bh * Sq + q0) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (!row_ok[r]) continue;
    const float l = l_run[r] == 0.0f ? 1.0f : l_run[r];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = (i / W) * 16 * W + tx * W + i % W;
      store(ob + (ty * 4 + r) * D + col, acc[r][i] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* qpos, const void* kpos, int64_t B, int64_t H,
                   int64_t Hkv, int64_t Sq, int64_t Sk, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(unsigned(B * H), unsigned((Sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
      H, Hkv, Sq, Sk, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const void* qpos, const void* kpos, int64_t B, int64_t H,
                     int64_t Hkv, int64_t Sq, int64_t Sk, int64_t D,
                     double scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 || (Sq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, int64_t B, int64_t H, int64_t Hkv, int64_t Sq,
    int64_t Sk, int64_t D, double scale, int causal, void* stream) {
  return dispatch<float>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, D, scale,
                         causal, stream);
}

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, int64_t B, int64_t H, int64_t Hkv, int64_t Sq,
    int64_t Sk, int64_t D, double scale, int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, D,
                                 scale, causal, stream);
}
