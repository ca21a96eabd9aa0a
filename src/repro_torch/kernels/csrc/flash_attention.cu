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
// Keys past Sk score -inf (p = 0).  D is 32, 64 or 128.
//
// What bounds it on an H100: 4·Sq·Sk·D flops per (batch, head), halved by
// the causal mask, over (Sq + 2·Sk + Sq)·D elements.  At the serving shape
// (S = 1024, D = 128) that is about 400 flops per byte in bfloat16: far
// above the card's ridge, so it is bound by operations, and only the
// tensor cores reach that bound (989 TFLOP/s in bfloat16 against 67 on
// the CUDA cores).
//
// bfloat16: tensor cores, wgmma (the kernel flash_wgmma_kernel).  Route:
// wgmma.mma_async with TMA and mbarriers, PTX written inline (no CUTLASS).
//   Precision.  The TPU kernel casts q, k, v to float32 and forms P·V with
//   P in float32.  Q·Kᵀ on the tensor cores keeps that: bfloat16 products
//   are exact and the sums are float32.  P·V would round P to bfloat16,
//   which moves an output by up to 2^-9 of M = Σ p·|v| / Σ p, far above the
//   elementwise bound the card's checks hold the kernel to
//   (kernels/attention.py::attn_expect); so P is split, P_hi = bf16(p),
//   P_lo = bf16(p − P_hi) (p − P_hi is exact in float32), and P·V is two
//   products, P_hi·V + P_lo·V, off from the float32 P by at most
//   2^-18·p = 64u per term: well inside the bound's sum term,
//   2λ·√(Sk + Sk/64)·u·M ≥ 160u·M from Sk 64 on.  The split costs 1.5x
//   the tensor-core flops of a kernel that rounds P once.  Each key tile's
//   P·V goes to a fresh accumulator and is folded in with float32 FMA,
//   acc = acc·α + PVₜ, the TPU kernel's own step, so the tensor core sums
//   one tile's 64 keys (twice) at a time; BK = 64 keeps the bound's Sk/64
//   rescalings exact.
//   The exponent.  p = 2^(fma(s, c, −m)) with c = fl(scale·log2e) and m
//   the running max of fl(s·c), by ex2.approx.ftz.  Against the bound's
//   terms for expf (u = 2^-24, a ≥ |s·scale|): c's rounding scales every
//   exponent of a row by the same 1 + δ, |δ| ≤ u, which is what the
//   rounding of s·scale did (the "+1" in (λ·√D + 1)·u·a; the fma no longer
//   rounds s·c); the fma rounds once, by u·|s·scale − m| ≤ u·2a, the
//   "u·2a" term; ex2.approx is within 2 ulp (CUDA's exp2f, which compiles
//   to it), the "expf adds 2 ulp" term; m's own rounding shifts p, l and α of a row
//   alike and cancels in acc / l; flushing p < 2^-126 to 0 (expf's results
//   reach 2^-149) moves l ≥ 1 and acc by 2^-126 of a key's 1 and |v| at
//   most, below the bound unless |v| spans some 100 binades (the bound
//   models neither underflow).  Masked keys score −1e30 in these units
//   and keys past Sk −inf, so rows that have seen only masked keys keep
//   p = 1 as in the reference.
//   Layout.  One block of 384 threads owns one 128-row query tile of one
//   (batch, head): warpgroup 0 is the producer (one warp issues, the rest
//   exit), warpgroups 1 and 2 the consumers, 64 rows each (wgmma's M).
//   setmaxnreg gives the producer 40 registers and each consumer 232 (an
//   SM sub-partition holds one producer and two consumer warps; without it
//   a thread gets 168, where the consumers spilled).  Shared memory holds
//   Q (128 x D) and a ring of STAGES = 4 stages of one K and one V tile
//   (64 keys x D) each, bfloat16 in the 128-byte swizzle (64-byte at
//   D = 32) that both TMA and wgmma read, one box per 64 columns of D:
//   161 KiB at D = 128, one block an SM, both consumers reading each K/V
//   tile once it is in.  The producer brings Q, then each K/V tile, with
//   TMA (cp.async.bulk.tensor) onto an mbarrier ("full"), after both
//   consumers have released the stage ("empty").  Tensor maps are 3-D,
//   (D, Sq, B·H) for q and (D, Sk, B·Hkv) for k and v, encoded on the host
//   with cuTensorMapEncodeTiled (through cudaGetDriverEntryPoint, so the
//   library does not link libcuda): a ragged last tile reads zeros past
//   the head's last row, never the next head's rows (p = 0 times a
//   non-finite value there would be NaN).
//   A consumer, per tile: S = Q·Kᵀ as D/16 wgmma m64n64k16 (Q and K from
//   shared memory through descriptors, K-major); the mask and the online
//   softmax on the accumulator fragments in registers (a row's 64 scores
//   live in the 4 threads of a quad: max and sum by two shuffles); P split
//   in registers (the f32 accumulator layout of S is the bfloat16
//   A-fragment layout of wgmma); PVₜ as 2·64/16 wgmma m64nDk16, A from
//   registers, V from shared memory MN-major (so V needs no transpose).
//   It runs one tile deep in a software pipeline: QK of tile t and PV of
//   tile t−1 are issued together, the softmax of t runs on the CUDA cores
//   while the tensor cores run PV of t−1, then PV of t−1 is folded in and
//   its stage released.  Registers a consumer thread: S 32, P_hi and P_lo
//   32, PVₜ and acc D/2 each.  Branches around wgmma are on values that
//   ptxas sees as warp-uniform (shuffled from lane 0): on a branch it
//   cannot prove uniform it serialises every wgmma of the kernel.
//   The tile skip: the producer walks the key tiles and leaves out a tile
//   that the mask hides from every row of both consumers once every row
//   has seen a visible key (with causal positions, every tile above the
//   diagonal); both facts follow from the positions alone (a row has seen
//   a visible key before tile t iff its qpos >= min kpos of the keys before
//   t).  Beside each stage it leaves a word: the tile, and for each
//   consumer whether it needs the mask (diagonal or ragged tiles only) or
//   skips the tile (hidden from all its 64 rows, which have all seen a
//   visible key); a last word ends the walk.  It takes the key positions'
//   bounds 32 tiles at a time, one tile a lane, off the per-tile path.  A
//   row that has seen no visible key keeps uniform weight over its -1e30
//   keys, as the reference does.
//
// float32: CUDA cores (the kernel flash_fwd_kernel, unchanged since its
//   port).  One block of 256
//   threads owns one 64-row query tile and walks the 64-key tiles in a
//   loop, carrying m, l and acc in registers (4 rows x D/16 columns a
//   thread); Q stays in shared memory as float32, each K tile, then V
//   tile, streams through one shared buffer (83 KiB at D = 128, two blocks
//   an SM); per tile S (4 x 4 scores a thread), the scale, the mask, the
//   row max and sum by shuffles across the 16 threads of a row, P to
//   shared memory, then acc = acc·alpha + P·V, all in FFMA.  It skips the
//   same tiles, decided by the whole block with __syncthreads_and.
//
// Both order their blocks heaviest causal query tile first, so the causal
// imbalance leaves no tail, and neither needs Sq or Sk to be a multiple of
// a tile: rows past Sq are not written.  No atomics: a launch is
// deterministic.
#include <cuda.h>
#include <cuda_bf16.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;


// ===========================================================================
// float32 on the CUDA cores
// ===========================================================================
namespace simt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns 4 rows, tx 4 keys
constexpr int LDP = BK + 4;     // row stride of P in shared memory

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

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

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

template <int D, typename T = float>
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

}  // namespace simt

// ===========================================================================
// bfloat16 on the tensor cores: TMA, mbarriers, wgmma
// ===========================================================================
namespace tc {

constexpr int WG_ROWS = 64;      // query rows a consumer warpgroup owns (wgmma's M)
constexpr int CONSUMER_WGS = 2;
constexpr int BQ = WG_ROWS * CONSUMER_WGS;   // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int STAGES = 4;        // K/V ring
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = 128 + CONSUMERS;   // warpgroup 0: the producer
// Registers a thread after setmaxnreg: the producer's warpgroup gives its
// share to the consumers (an SM sub-partition holds one producer and two
// consumer warps: 40 + 2·232 <= 512 of its 16384 / 32)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared-memory layout of one block for head dim D.  A tile of R rows x D
// is stored as D / SW boxes of R rows x SW columns, each row SW·2 bytes
// (128, or 64 at D = 32) in TMA's swizzle of that width; Q as one such
// tile of 64 rows for each consumer warpgroup.
template <int D>
struct Cfg {
  static constexpr int SW = D < 64 ? D : 64;     // columns in one box
  static constexpr int ROW = SW * 2;             // bytes of a box row
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;  // wgmma: B128 / B64
  static constexpr int BOX = 64 * ROW;           // one box of 64 rows
  static constexpr int Q_WG = WG_ROWS * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = CONSUMER_WGS * Q_WG;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // full[STAGES], empty[STAGES], q: 8 bytes each; tile[STAGES]: 4 each;
  // + 1024 to align the base to the swizzle atom (8 rows x 128 bytes)
  static constexpr int SMEM = OFF_BAR + 8 * (2 * STAGES + 1) + 4 * STAGES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map, coordinates innermost first, onto `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (+)= Q·Kᵀ: m64n64k16, A and B K-major from shared memory.
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// O (+)= P·V: m64nNk16, A (P) from registers, B (V) MN-major from shared
// memory (imm-trans-b = 1).
template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc);

template <>
__device__ __forceinline__ void mma_pv<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void mma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

#undef F8

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) -> P_hi = bf16(a), bf16(b) and P_lo = bf16(a − P_hi), ..., each
// packed low element first (the A-fragment order).
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the online softmax on a row pair's accumulator fragment, in
// log2 units: the running max m is of y = s·c (c = scale·log2e), and
// p = 2^(fma(s, c, −m)); a masked key (bit clear in vis) scores NEG_INF,
// a key past Sk (bit set in past) −inf.  sc: S in, P out; alpha: the
// factor that rescales the row's earlier sums.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], float c,
                                             unsigned vis, unsigned past) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * i + e;
        if (!MASKED || (vis >> idx & 1)) mx[j % 4] = fmaxf(mx[j % 4], sc[idx] * c);
      }
    const float m_new =
        fmaxf(m_run[i], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
    alpha[i] = ex2(m_run[i] - m_new);
    const float masked_p = MASKED ? ex2(NEG_INF - m_new) : 0.0f;
    float ls[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * i + e;
        float p = ex2(fmaf(sc[idx], c, -m_new));
        if (MASKED && !(vis >> idx & 1)) p = past >> idx & 1 ? 0.0f : masked_p;
        sc[idx] = p;
        ls[j % 4] += p;
      }
    l_run[i] = l_run[i] * alpha[i] + quad_sum((ls[0] + ls[1]) + (ls[2] + ls[3]));
    m_run[i] = m_new;
  }
}

// The word the producer leaves beside a stage: tile index << 4, then for
// consumer warpgroup w the bits 2w (the tile needs the mask) and 2w + 1
// (the tile is hidden from all its rows, which have all seen a visible
// key: it only releases the stage); -1 ends the walk.
constexpr int MASK_BIT = 1, SKIP_BIT = 2;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   const int32_t* __restrict__ qpos, const int32_t* __restrict__ kpos,
                   int H, int Hkv, int Sq, int Sk, float scale_log2e, int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // align to the swizzle atom: TMA's swizzle and wgmma's descriptors with
  // base offset 0 both assume it
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + C::OFF_BAR;   // full[s], empty[s], q
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };
  const uint32_t qbar = bar + 8 * 2 * STAGES;
  volatile int* tile_of =
      reinterpret_cast<volatile int*>(smem + C::OFF_BAR + 8 * (2 * STAGES + 1));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = int(gridDim.y - 1 - blockIdx.y) * BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role and every tile word through a shuffle: values ptxas sees as
  // warp-uniform, so it does not serialize the wgmma behind branches on them
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  if (wg == 0) {
    // ---- producer: Q once, then the K/V tiles some consumer needs -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, CONSUMER_WGS * C::Q_WG);
      for (int w = 0; w < CONSUMER_WGS; ++w)
        for (int c = 0; c < D / C::SW; ++c)
          tma_load(base + w * C::Q_WG + c * C::BOX, &tq, qbar, c * C::SW, q0 + w * WG_ROWS, bh);
    }
    // each consumer's least and largest query position (rows past Sq
    // excluded: a warpgroup without rows skips every tile)
    int qmin[CONSUMER_WGS], qmax[CONSUMER_WGS];
    for (int w = 0; w < CONSUMER_WGS; ++w) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int r = q0 + w * WG_ROWS + lane; r < q0 + (w + 1) * WG_ROWS && r < Sq; r += 32) {
        const int p = qpos[r];
        lo = min(lo, p);
        hi = max(hi, p);
      }
      qmin[w] = warp_min(lo);
      qmax[w] = warp_max(hi);
    }
    const int n_tiles = (Sk + BK - 1) / BK;
    int kmin_before = INT_MAX;   // least kpos of the keys before tile t
    int stage = 0, phase = 0;
    // the least and largest key position of each tile, 32 tiles at a time:
    // lane l scans tile t0 + l, and tile t's come by shuffle from lane t % 32
    int lane_lo = INT_MAX, lane_hi = INT_MIN;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;
      int kmin = INT_MIN, kmax = INT_MIN;   // causal == 0: nothing hidden
      if (causal) {
        if (t % 32 == 0) {
          lane_lo = INT_MAX;
          lane_hi = INT_MIN;
          const int j0 = (t + lane) * BK, j1 = min(j0 + BK, Sk);
#pragma unroll 8
          for (int j = j0; j < j1; ++j) {
            const int p = kpos[j];
            lane_lo = min(lane_lo, p);
            lane_hi = max(lane_hi, p);
          }
        }
        kmin = __shfl_sync(0xffffffffu, lane_lo, t % 32);
        kmax = __shfl_sync(0xffffffffu, lane_hi, t % 32);
      }
      // a consumer masks a tile past Sk, or one some row of it does not
      // see whole; it skips one hidden from all its rows once they have
      // all seen a visible key
      int word = t << 4, skips = 0;
      for (int w = 0; w < CONSUMER_WGS; ++w) {
        const bool skip = q0 + w * WG_ROWS >= Sq || (qmax[w] < kmin && qmin[w] >= kmin_before);
        const bool mask = k0 + BK > Sk || (causal && qmin[w] < kmax);
        word |= (skip ? SKIP_BIT : mask ? MASK_BIT : 0) << (2 * w);
        skips += skip;
      }
      kmin_before = min(kmin_before, kmin);
      if (skips == CONSUMER_WGS) continue;
      mbar_wait(empty(stage), phase ^ 1);
      if (lane == 0) {
        tile_of[stage] = word;
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
        const uint32_t ks = base + C::OFF_K + stage * C::KV_BYTES;
        const uint32_t vs = base + C::OFF_V + stage * C::KV_BYTES;
        for (int c = 0; c < D / C::SW; ++c) {
          tma_load(ks + c * C::BOX, &tk, full(stage), c * C::SW, k0, kvh);
          tma_load(vs + c * C::BOX, &tv, full(stage), c * C::SW, k0, kvh);
        }
      }
      __syncwarp();
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    mbar_wait(empty(stage), phase ^ 1);
    if (lane == 0) {
      tile_of[stage] = -1;   // the end of the walk
      mbar_arrive(full(stage));
    }
  } else {
    // ---- consumers: warpgroup cw owns 64 query rows ----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    // accumulator fragment of m64nN: thread (warp w, lane l) holds rows
    // r0 = 16w + l/4 and r0 + 8 of its 64; element 4j + 2i + e is (row
    // r0 + 8i, column 8j + 2(l%4) + e)
    const int r0 = q0 + cw * WG_ROWS + 16 * warp + lane / 4, c0 = 2 * (lane % 4);
    int qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qp[i] = r0 + 8 * i < Sq ? qpos[r0 + 8 * i] : 0;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

    // descriptors: K-major Q and K (SBO = 8 rows), MN-major V (LBO = one
    // box of D columns to the next, SBO = 8 keys)
    const uint32_t sbo = 8 * C::ROW, qs = base + cw * C::Q_WG;
    auto issue_qk = [&](float (&sc)[32], uint32_t ks) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        // 16 columns of D: box kc / (SW/16), 32 bytes a step inside the row
        const uint32_t box = kc / (C::SW / 16) * C::BOX, off = (kc % (C::SW / 16)) * 32;
        mma_qk(sc, make_desc(qs + box + off, 16, sbo, C::LAYOUT),
               make_desc(ks + box + off, 16, sbo, C::LAYOUT), kc > 0);
      }
      wg_commit();
    };
    // PVₜ = P_hi·V + P_lo·V into a fresh accumulator
    auto issue_pv = [&](float (&pv)[D / 2], const uint32_t (&hi)[BK / 16][4],
                        const uint32_t (&lo)[BK / 16][4], uint32_t vs) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_pv<D>(pv, hi[kk], make_desc(vs + kk * 16 * C::ROW, C::BOX, sbo, C::LAYOUT), kk > 0);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_pv<D>(pv, lo[kk], make_desc(vs + kk * 16 * C::ROW, C::BOX, sbo, C::LAYOUT), 1);
      wg_commit();
    };

    // Software pipeline, one tile deep: the products QK of tile t and PV of
    // tile t-1 are issued together, and the softmax of t runs on the CUDA
    // cores while the tensor cores run PV of t-1; then PV of t-1 is folded
    // in, and P of t split into the registers PV of t will read.
    float sc[32], pv[D / 2];
    uint32_t ph[BK / 16][4], pl[BK / 16][4];   // P of the pending tile
    float pending_alpha[2];
    int pending = -1;   // the stage whose PV is pending
    mbar_wait(qbar, 0);
    int stage = 0, phase = 0;
    for (;;) {
      mbar_wait(full(stage), phase);
      const int word = __shfl_sync(0xffffffffu, tile_of[stage], 0);
      if (word < 0) break;
      const int flags = word >> (2 * cw) & 3;
      if (flags & SKIP_BIT) {
        mbar_arrive(empty(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
        continue;
      }
      const int k0 = (word >> 4) * BK;
      wg_fence();
      issue_qk(sc, base + C::OFF_K + stage * C::KV_BYTES);
      if (pending >= 0) {
        issue_pv(pv, ph, pl, base + C::OFF_V + pending * C::KV_BYTES);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      fence_regs(sc);

      // the mask: bit e of vis (past) is element e visible (past Sk)
      float alpha[2];
      if (flags & MASK_BIT) {
        unsigned vis = ~0u, past = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + c0 + e;
            const int kp = causal && col < Sk ? kpos[col] : 0;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const unsigned bit = 1u << (4 * j + 2 * i + e);
              if (col >= Sk) {
                past |= bit;
                vis &= ~bit;
              } else if (causal && qp[i] < kp) {
                vis &= ~bit;
              }
            }
          }
        softmax_tile<true>(sc, m_run, l_run, alpha, scale_log2e, vis, past);
      } else {
        softmax_tile<false>(sc, m_run, l_run, alpha, scale_log2e, ~0u, 0u);
      }

      if (pending >= 0) {
        wg_wait<0>();
        fence_regs(pv);
        mbar_arrive(empty(pending));   // K and V of that stage are read
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          acc[i] = fmaf(acc[i], pending_alpha[(i / 2) % 2], pv[i]);
      }
      // P split into bfloat16 A fragments: keys 16kk..16kk+15 are the
      // accumulator's elements 8kk..8kk+7
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
      pending = stage;
      pending_alpha[0] = alpha[0];
      pending_alpha[1] = alpha[1];
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    if (pending >= 0) {
      wg_fence();
      issue_pv(pv, ph, pl, base + C::OFF_V + pending * C::KV_BYTES);
      wg_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], pending_alpha[(i / 2) % 2], pv[i]);
    }

    __nv_bfloat16* ob = o + int64_t(bh) * Sq * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= Sq) continue;
      const float l = l_run[i] == 0.0f ? 1.0f : l_run[i];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + int64_t(row) * D + 8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / l, acc[4 * j + 2 * i + 1] / l);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 3-D map (D, rows, heads) of a contiguous (heads, rows, D) bfloat16
// array, in boxes of (SW, 64, 1): past `rows` a box reads zeros.
template <int D>
cudaError_t encode(CUtensorMap* map, const void* base, int64_t rows, int64_t heads) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(rows) * D * 2};
  const cuuint32_t box[3] = {cuuint32_t(Cfg<D>::SW), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        Cfg<D>::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const void* qpos,
                   const void* kpos, int64_t B, int64_t H, int64_t Hkv, int64_t Sq, int64_t Sk,
                   float scale, int causal, cudaStream_t stream) {
  static_assert(WG_ROWS == 64 && BK == 64, "one box height serves Q and K/V");
  if (B * H > INT32_MAX || Sq > INT32_MAX || Sk > INT32_MAX ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode<D>(&tq, q, Sq, B * H);
  if (err == cudaSuccess) err = encode<D>(&tk, k, Sk, B * Hkv);
  if (err == cudaSuccess) err = encode<D>(&tv, v, Sk, B * Hkv);
  if (err != cudaSuccess) return err;
  auto kernel = flash_wgmma_kernel<D>;
  err = allow_smem(kernel, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(unsigned(B * H), unsigned((Sq + BQ - 1) / BQ));
  kernel<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<const int32_t*>(qpos),
      static_cast<const int32_t*>(kpos), int(H), int(Hkv), int(Sq), int(Sk),
      float(double(scale) * 1.4426950408889634), causal);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const void* qpos, const void* kpos, int64_t B, int64_t H,
                     int64_t Hkv, int64_t Sq, int64_t Sk, int64_t D,
                     double scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 || (Sq + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (D) {
      case 32: return tc::launch<32>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      case 64: return tc::launch<64>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      case 128: return tc::launch<128>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 32: return simt::launch<32>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      case 64: return simt::launch<64>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      case 128: return simt::launch<128>(q, k, v, o, qpos, kpos, B, H, Hkv, Sq, Sk, sc, causal, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// The bfloat16 kernel's tiling for head dim D, for the records:
// out = {route (1 = wgmma), BQ, BK, STAGES, threads, dynamic smem bytes}.
extern "C" int repro_flash_attention_bf16_config(int64_t D, int64_t* out) {
  int smem;
  switch (D) {
    case 32: smem = tc::Cfg<32>::SMEM; break;
    case 64: smem = tc::Cfg<64>::SMEM; break;
    case 128: smem = tc::Cfg<128>::SMEM; break;
    default: return cudaErrorInvalidValue;
  }
  const int64_t cfg[6] = {1, tc::BQ, tc::BK, tc::STAGES, tc::THREADS, smem};
  for (int i = 0; i < 6; ++i) out[i] = cfg[i];
  return cudaSuccess;
}

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
