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
// by operations.  Every product is float32 FMA on the CUDA cores.
//
// Design.  Only two terms depend on the carried state: r_in S and the
// state update itself.  Everything else of a chunk (the cumsum, the
// factors, the bonus, the score tile, the scores times v, the chunk's own
// k_fwd^T v and decay) depends on the chunk's rows alone.  So the work is
// cut into (batch*head, chunk) tiles, B*H*ceil(S/c) of them (2048 at
// 4 x 64 heads x 1024 tokens, 16384 at 64 heads x 32768), taken by a
// persistent grid of one 512-thread block an SM (its shared memory, 226
// KiB at D 64, holds one tile) from an atomic ticket in chunk-major order,
// so a head's chunks start in order.  Per tile:
//   0. r, k, v (as float32) and logw into shared memory (cp.async where
//      no conversion is needed); the next ticket's rows are then
//      prefetched into L2, so the next tile's loads find them there;
//   1. a warp a 4-channel column group: the cumsum as a warp scan of each
//      32-row segment (lane = row) plus the running carry, then r_in,
//      k_out and k_fwd from registers, the decay, and each row's bonus
//      r.(u.k) over the group (the groups' partials added in order);
//   2. k_fwd^T v in parts of D^2/32 threads, a thread an 8 x 4 register
//      tile, each part over C / parts rows in order, each part's partial
//      into shared memory;
//   3. the state chain, in chunk order: thread 0 waits until the head's
//      count of published chunks reaches this chunk (an acquire load; the
//      tile it waits on holds an earlier ticket, so it already runs), then
//      every thread, 4 entries of S at a time, reads S_in (s0 or zero for
//      chunk 0, else the head's ring slot; all its loads before its first
//      store), adds the parts' partials in part order (k_fwd^T v), keeps
//      S_in in shared memory and writes S_out = fma(decay, S_in,
//      k_fwd^T v) to the other slot (the final state for the last chunk);
//      thread 0 publishes after a barrier (one release store, which the
//      barrier makes cover every thread's S_out; a ring of two slots a
//      head suffices: a slot is rewritten only after the chunk that reads
//      it has published);
//   4. a warp owns two 4-row groups, q and 31 - q, so every warp has the
//      same share of the triangle: in one pass over the channels, the
//      strict score rows (8 x 4 register tile, a lane a column of each
//      32-column block) and r_in x S_in (8 rows x D/32 columns a lane), so
//      each r_in row is read once for both, with the blocks each group
//      reads known at compile time (four cases at C 128); the score rows
//      into the warp's own rows of shared memory; then scores x v, the
//      warp's halves on alternate 4-row steps of s (8 rows x D/16 columns
//      a lane) and added, and the output rows; no block barrier.
// Five block barriers a tile.  The same chunk gives the same bits wherever
// it runs: every sum has a fixed order, and S_out is one fma of S_in, so a
// run split at a chunk boundary and continued from its final state equals
// the unsplit run bitwise.  The last ticket taken resets the ticket, and a
// head's last chunk resets its count, so the int32 flags stay 0 between
// launches; a chain wait longer than 2 s traps instead of hanging.
//
// Rounding (what wkv6_expect bounds): the cumsum runs a 5-step warp scan
// and one carry add a segment, within its (n + 8) u sum|logw|; each dot
// product sums in its index order in float32 FMA, scores x v as two such
// sums (alternate 4-row steps) added, k_fwd^T v as the parts' sums added;
// out = r_in S_in + fma(bonus, v, scores v).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int C = 128;          // the most rows of a chunk
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = C / 4;   // 4-row groups; warp w owns w and GROUPS-1-w
constexpr int LDP = C;          // row stride of a warp's score rows
constexpr float CLIP = 80.0f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long WAIT_NS = 2000000000ull;
static_assert(GROUPS == 2 * WARPS, "two 4-row groups a warp");

// Offsets into shared memory, in floats (each a multiple of 4).
template <int D>
struct Layout {
  static constexpr int LD = D + 4;                 // row stride (LD/4 odd: no bank conflicts)
  static constexpr int NT = D / 4;                 // 4-channel groups (the cumsum's warps)
  static constexpr int PART_THREADS = D * D / 32;  // 8 x 4 tiles of S: a part of k_fwd^T v
  static constexpr int PARTS = THREADS / PART_THREADS;  // 4 (D 64), 16 (D 32)
  static constexpr int PART_ROWS = C / PARTS;
  static constexpr int R = 0;                      // r, then r_in
  static constexpr int K = R + C * LD;             // k, then k_out
  static constexpr int V = K + C * LD;             // v
  static constexpr int S = V + C * LD;             // S_in (D x D)
  static constexpr int P = S + D * LD;             // the warps' score rows (8 x LDP each)
  static constexpr int W = P;                      // before them: logw, then k_fwd,
  static constexpr int X = P + C * LD;             // and the parts' partials
  static constexpr int P_END = X + PARTS * D * D;
  static constexpr int BONUS = P + (WARPS * 8 * LDP > P_END - P ? WARPS * 8 * LDP : P_END - P);
  static constexpr int BPART = BONUS + C;          // the bonus's partials, NT x C
  static constexpr int DECAY = BPART + NT * C;
  static constexpr int TICKET = DECAY + D;         // two int slots
  static constexpr int TOTAL = TICKET + 4;
  static_assert(PART_THREADS % 32 == 0, "a warp takes 4 x 8 tiles of 8 x 4");
};

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -CLIP), CLIP));
}

__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ float4 f4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}

// J consecutive floats of shared memory (4 J-byte aligned), J = 1, 2, 4.
template <int J>
__device__ __forceinline__ void load_cols(const float* p, float* o) {
  if constexpr (J == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  } else if constexpr (J == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
    o[0] = p[0];
  }
}

// 8 bfloat16 values (16 bytes) as floats.
__device__ __forceinline__ void unpack_bf16x8(const uint4& x, float* f) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ int ld_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(f) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* f, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(f), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Thread 0 waits until the head's published count reaches v.
__device__ __forceinline__ void wait_published(const int* f, int v) {
  const unsigned long long t0 = global_ns();
  while (ld_acquire(f) < v) {
    __nanosleep(64);
    if (global_ns() - t0 > WAIT_NS) __trap();   // the chain broke: fail, do not hang
  }
}

// The next tile of the launch.  Every block's last take is the one that
// finds none left, so the take that returns total + gridDim.x - 1 is the
// last of the launch and sets the ticket back to 0 for the next one.
__device__ __forceinline__ int take_ticket(int* ticket, int total) {
  const int t = atomicAdd(ticket, 1);
  if (t == total + static_cast<int>(gridDim.x) - 1) atomicExch(ticket, 0);
  return t;
}

// Phase 4's first pass over the channels for a warp whose groups read NB1
// and NB2 32-column blocks of scores (NB2 = 0: the second group has no
// rows): the strict score rows sc (row x, column 32 i + lane) and r_in x
// S_in, ie (row x, columns JL lane ..); each r_in row loaded once serves
// both.  Sums run over a in order.
template <int NB1, int NB2, int D>
__device__ __forceinline__ void scores_and_inter(const float* Rs, const float* Ks,
                                                 const float* Ss, int q1, int q2, int lane,
                                                 float (&sc)[8][4], float (&ie)[8][D / 32]) {
  constexpr int LD = D + 4, JL = D / 32, NB = NB2 > NB1 ? NB2 : NB1;
  constexpr int ROWS = NB2 > 0 ? 8 : 4;
#pragma unroll 1
  for (int a = 0; a < D; a += 4) {
    float4 kb[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      kb[i] = *reinterpret_cast<const float4*>(Ks + (32 * i + lane) * LD + a);
    float sb[4][JL];
#pragma unroll
    for (int e = 0; e < 4; ++e) load_cols<JL>(Ss + (a + e) * LD + JL * lane, sb[e]);
#pragma unroll
    for (int x = 0; x < ROWS; ++x) {
      const int t = x < 4 ? 4 * q1 + x : 4 * q2 + x - 4;
      const float4 ra = *reinterpret_cast<const float4*>(Rs + t * LD + a);
#pragma unroll
      for (int i = 0; i < (x < 4 ? NB1 : NB2); ++i) {
        float y = sc[x][i];
        y = fmaf(ra.x, kb[i].x, y);
        y = fmaf(ra.y, kb[i].y, y);
        y = fmaf(ra.z, kb[i].z, y);
        y = fmaf(ra.w, kb[i].w, y);
        sc[x][i] = y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < JL; ++j) ie[x][j] = fmaf(at(ra, e), sb[e][j], ie[x][j]);
    }
  }
}

// Scores x v over the s-quads from s in steps of 8 while s < end, for score
// rows X0 .. X0 + ROWS - 1 of the warp's rows Pw; lane c of the half the
// columns JC c .. .  Returns the next s.
template <int X0, int ROWS, int D>
__device__ __forceinline__ int scores_v(const float* Pw, const float* Vs, int s, int end,
                                        int cq, float (&pv)[8][D / 16]) {
  constexpr int LD = D + 4, JC = D / 16;
#pragma unroll 1
  for (; s < end; s += 8) {
    float vb[4][JC];
#pragma unroll
    for (int e = 0; e < 4; ++e) load_cols<JC>(Vs + (s + e) * LD + JC * cq, vb[e]);
#pragma unroll
    for (int x = X0; x < X0 + ROWS; ++x) {
      const float4 pa = *reinterpret_cast<const float4*>(Pw + x * LDP + s);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < JC; ++j) pv[x][j] = fmaf(at(pa, e), vb[e][j], pv[x][j]);
    }
  }
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_tile_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ logw, const float* __restrict__ u,
                 const float* __restrict__ s0, float* __restrict__ out,
                 float* __restrict__ sfin, float* __restrict__ slots, int* __restrict__ flags,
                 int BH, int H, int64_t S, int c) {
  using L = Layout<D>;
  constexpr int LD = L::LD, NT = L::NT, JL = D / 32;
  constexpr int WPR = D / 4;   // 16-byte vectors of a float32 row
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Rs = sm + L::R;
  float* Ks = sm + L::K;
  float* Vs = sm + L::V;
  float* Ss = sm + L::S;
  float* Ws = sm + L::W;
  float* Xs = sm + L::X;
  float* bonus = sm + L::BONUS;
  float* bpart = sm + L::BPART;
  float* decay = sm + L::DECAY;
  int* s_tk = reinterpret_cast<int*>(sm + L::TICKET);
  int* done = flags;          // [BH]: chunks of the head whose state is published
  int* ticket = flags + BH;   // the next tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nchunks = static_cast<int>((S + c - 1) / c);
  const int total = BH * nchunks;

  if (nchunks == 0)   // S = 0: the final state is the start state
    for (int64_t i = blockIdx.x * int64_t(THREADS) + tid; i < int64_t(BH) * D * D;
         i += int64_t(gridDim.x) * THREADS)
      sfin[i] = s0 == nullptr ? 0.0f : s0[i];

  // the state update's thread map: part of the rows, rows 8 ta.. and
  // columns 4 tj.. of S (a warp 4 x 8 such tiles)
  const int part = tid / L::PART_THREADS, wp = (tid % L::PART_THREADS) / 32;
  const int ta = (wp % (D / 32)) * 4 + lane / 8, tj = (wp / (D / 32)) * 8 + lane % 8;

  if (tid == 0) s_tk[0] = take_ticket(ticket, total);
  int buf = 0;
  for (;; buf ^= 1) {
    __syncthreads();   // the last tile is done with shared memory; its ticket is seen
    const int tk = s_tk[buf];
    if (tk >= total) break;
    if (tid == 0) s_tk[buf ^ 1] = take_ticket(ticket, total);
    const int ci = tk / BH, bh = tk % BH;
    const int64_t t0 = int64_t(ci) * c;
    const int n = static_cast<int>(S - t0 < c ? S - t0 : c);
    const int nz = (n + 31) & ~31;   // rows n.. nz are zero
    const int64_t row0 = int64_t(bh) * S + t0;

    // 0. the rows: logw (and float32 r, k, v) copied with cp.async, rows
    // n .. nz zero-filled; bfloat16 r, k, v through registers
    {
      auto copy_rows = [&](float* dst, const float* src) {
        for (int i = tid; i < nz * WPR; i += THREADS) {
          const int t = i / WPR, a = (i % WPR) * 4;
          cp_async16(dst + t * LD + a, t < n ? src + (row0 + t) * D + a : src, t < n ? 16 : 0);
        }
      };
      copy_rows(Ws, logw);
      if constexpr (std::is_same_v<T, float>) {
        copy_rows(Rs, r);
        copy_rows(Ks, k);
        copy_rows(Vs, v);
      } else {
        constexpr int VPR = D / 8, RK_IT = C * VPR / THREADS;   // 16-byte vectors
        static_assert(RK_IT * THREADS == C * VPR, "");
        uint4 rr[RK_IT], kk[RK_IT], vv[RK_IT];
#pragma unroll
        for (int m = 0; m < RK_IT; ++m) {
          const int i = tid + m * THREADS, t = i / VPR, a = (i % VPR) * 8;
          const int64_t off = (row0 + t) * D + a;
          const bool in = t < n;
          rr[m] = in ? *reinterpret_cast<const uint4*>(r + off) : make_uint4(0, 0, 0, 0);
          kk[m] = in ? *reinterpret_cast<const uint4*>(k + off) : make_uint4(0, 0, 0, 0);
          vv[m] = in ? *reinterpret_cast<const uint4*>(v + off) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int m = 0; m < RK_IT; ++m) {
          const int i = tid + m * THREADS, t = i / VPR, a = (i % VPR) * 8;
          if (t >= nz) continue;
          float fr[8], fk[8], fv[8];
          unpack_bf16x8(rr[m], fr);
          unpack_bf16x8(kk[m], fk);
          unpack_bf16x8(vv[m], fv);
#pragma unroll
          for (int e = 0; e < 8; e += 4) {
            *reinterpret_cast<float4*>(Rs + t * LD + a + e) = f4(fr[e], fr[e + 1], fr[e + 2], fr[e + 3]);
            *reinterpret_cast<float4*>(Ks + t * LD + a + e) = f4(fk[e], fk[e + 1], fk[e + 2], fk[e + 3]);
            *reinterpret_cast<float4*>(Vs + t * LD + a + e) = f4(fv[e], fv[e + 1], fv[e + 2], fv[e + 3]);
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    // the next tile's rows into L2, a 128-byte line a thread
    {
      const int nt = s_tk[buf ^ 1];
      if (nt < total) {
        const int64_t nt0 = int64_t(nt / BH) * c;
        const int64_t nrow0 = int64_t(nt % BH) * S + nt0;
        const int64_t nn = S - nt0 < c ? S - nt0 : c;
        const char* base[4] = {reinterpret_cast<const char*>(r + nrow0 * D),
                               reinterpret_cast<const char*>(k + nrow0 * D),
                               reinterpret_cast<const char*>(v + nrow0 * D),
                               reinterpret_cast<const char*>(logw + nrow0 * D)};
        const int64_t bytes[4] = {nn * D * int64_t(sizeof(T)), nn * D * int64_t(sizeof(T)),
                                  nn * D * int64_t(sizeof(T)), nn * D * 4};
        int64_t first[4], lines[4], all = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uintptr_t p = reinterpret_cast<uintptr_t>(base[q]);
          first[q] = int64_t(p / 128);
          lines[q] = int64_t((p + bytes[q] - 1) / 128) - first[q] + 1;
          all += lines[q];
        }
        for (int64_t i = tid; i < all; i += THREADS) {
          const int64_t line = i < lines[0] ? first[0] + i
                               : i < lines[0] + lines[1] ? first[1] + i - lines[0]
                               : i < lines[0] + lines[1] + lines[2]
                                   ? first[2] + i - lines[0] - lines[1]
                                   : first[3] + i - lines[0] - lines[1] - lines[2];
          prefetch_l2(reinterpret_cast<const void*>(static_cast<uintptr_t>(line) * 128));
        }
      }
    }

    // 1. cumsum, factors, decay, and the bonus over the warp's channels:
    // warp w the channels 4w..4w+3
    if (warp < NT) {
      const int a0 = 4 * warp;
      const float4 uu = *reinterpret_cast<const float4*>(u + int64_t(bh % H) * D + a0);
      float4 lw[C / 32], cm[C / 32];
      float4 carry = f4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < C / 32; ++g) {
        if (32 * g < nz) {
          const int t = 32 * g + lane;
          const float4 x = *reinterpret_cast<const float4*>(Ws + t * LD + a0);
          float4 y = x;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float4 z = f4(__shfl_up_sync(FULL, y.x, o), __shfl_up_sync(FULL, y.y, o),
                                __shfl_up_sync(FULL, y.z, o), __shfl_up_sync(FULL, y.w, o));
            if (lane >= o) y = f4(y.x + z.x, y.y + z.y, y.z + z.z, y.w + z.w);
          }
          y = f4(y.x + carry.x, y.y + carry.y, y.z + carry.z, y.w + carry.w);
          carry = f4(__shfl_sync(FULL, y.x, 31), __shfl_sync(FULL, y.y, 31),
                     __shfl_sync(FULL, y.z, 31), __shfl_sync(FULL, y.w, 31));
          lw[g] = x;
          cm[g] = y;
        }
      }
      const float4 wt = carry;   // rows past n add zeros: the chunk's total
      if (lane == 0)
        *reinterpret_cast<float4*>(decay + a0) =
            f4(clip_exp(wt.x), clip_exp(wt.y), clip_exp(wt.z), clip_exp(wt.w));
#pragma unroll
      for (int g = 0; g < C / 32; ++g) {
        if (32 * g < nz) {
          const int t = 32 * g + lane;
          const float4 x = lw[g], y = cm[g];
          const float4 ri = *reinterpret_cast<const float4*>(Rs + t * LD + a0);
          const float4 ki = *reinterpret_cast<const float4*>(Ks + t * LD + a0);
          float b = ri.x * (uu.x * ki.x);
          b = fmaf(ri.y, uu.y * ki.y, b);
          b = fmaf(ri.z, uu.z * ki.z, b);
          bpart[warp * C + t] = fmaf(ri.w, uu.w * ki.w, b);
          *reinterpret_cast<float4*>(Rs + t * LD + a0) =
              f4(ri.x * clip_exp(y.x - x.x), ri.y * clip_exp(y.y - x.y),
                 ri.z * clip_exp(y.z - x.z), ri.w * clip_exp(y.w - x.w));
          *reinterpret_cast<float4*>(Ks + t * LD + a0) =
              f4(ki.x * clip_exp(-y.x), ki.y * clip_exp(-y.y), ki.z * clip_exp(-y.z),
                 ki.w * clip_exp(-y.w));
          *reinterpret_cast<float4*>(Ws + t * LD + a0) =
              f4(ki.x * clip_exp(wt.x - y.x), ki.y * clip_exp(wt.y - y.y),
                 ki.z * clip_exp(wt.z - y.z), ki.w * clip_exp(wt.w - y.w));
        }
      }
    }
    __syncthreads();

    // the bonus of row tid: the warps' partials in warp order
    if (tid < nz) {
      float b = bpart[tid];
      for (int w = 1; w < NT; ++w) b += bpart[w * C + tid];
      bonus[tid] = b;
    }

    // 2. k_fwd^T v: this part's rows, in order
    float kv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[i][j] = 0.0f;
    {
      const int lo = part * L::PART_ROWS;
      const int hi = n < lo + L::PART_ROWS ? n : lo + L::PART_ROWS;
#pragma unroll 2
      for (int t = lo; t < hi; ++t) {
        const float4 k0 = *reinterpret_cast<const float4*>(Ws + t * LD + 8 * ta);
        const float4 k1 = *reinterpret_cast<const float4*>(Ws + t * LD + 8 * ta + 4);
        const float4 vt = *reinterpret_cast<const float4*>(Vs + t * LD + 4 * tj);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[i][j] = fmaf(i < 4 ? at(k0, i) : at(k1, i - 4), at(vt, j), kv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(Xs + part * D * D + (8 * ta + i) * D + 4 * tj) =
            f4(kv[i][0], kv[i][1], kv[i][2], kv[i][3]);
    }

    // 3. the state chain: wait for S_in, publish S_out
    const bool last = ci == nchunks - 1;
    if (ci > 0 && tid == 0) wait_published(done + bh, ci);
    __syncthreads();
    {
      // every thread 4 consecutive entries of S at a time: k_fwd^T v as
      // the parts' partials added in part order, S_in, S_out
      const int64_t hs = int64_t(bh) * D * D;
      const float* sin = ci == 0 ? (s0 == nullptr ? nullptr : s0 + hs)
                                 : slots + (2 * int64_t(bh) + ci % 2) * D * D;
      float* sout = last ? sfin + hs : slots + (2 * int64_t(bh) + (ci + 1) % 2) * D * D;
      // S_in read in full before the first store: sin and sout may share
      // the slots, so the compiler would keep each load behind the store
      // before it, an L2 round trip apiece
      constexpr int NF = (D * D / 4 + THREADS - 1) / THREADS;
      float4 xin[NF];
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int f = 4 * (tid + q * THREADS);
        xin[q] = f >= D * D || sin == nullptr ? f4(0.f, 0.f, 0.f, 0.f)
                 : ci == 0 ? *reinterpret_cast<const float4*>(sin + f)
                           : __ldcg(reinterpret_cast<const float4*>(sin + f));
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int f = 4 * (tid + q * THREADS);
        if (f >= D * D) continue;
        const int a = f / D, j = f % D;
        float4 kvf = *reinterpret_cast<const float4*>(Xs + f);
        for (int p = 1; p < L::PARTS; ++p) {
          const float4 x = *reinterpret_cast<const float4*>(Xs + p * D * D + f);
          kvf = f4(kvf.x + x.x, kvf.y + x.y, kvf.z + x.z, kvf.w + x.w);
        }
        const float4 x = xin[q];
        *reinterpret_cast<float4*>(Ss + a * LD + j) = x;
        const float d = decay[a];
        __stcg(reinterpret_cast<float4*>(sout + f),
               f4(fmaf(d, x.x, kvf.x), fmaf(d, x.y, kvf.y), fmaf(d, x.z, kvf.z),
                  fmaf(d, x.w, kvf.w)));
      }
    }
    // the barrier orders every thread's S_out before thread 0's release
    __syncthreads();
    if (tid == 0) {
      if (!last)
        st_release(done + bh, ci + 1);
      else
        done[bh] = 0;   // no chunk of this head waits any more
    }

    // 4. a warp's rows: groups q1 = warp and q2 = GROUPS-1-warp
    const int q1 = warp, q2 = GROUPS - 1 - warp;
    if (4 * q1 < n) {
      const bool live2 = 4 * q2 < n;
      const int nb1 = (4 * q1 + 2) / 32 + 1;          // 32-column blocks a group reads
      const int nb2 = live2 ? (4 * q2 + 2) / 32 + 1 : 0;
      float* Pw = sm + L::P + warp * 8 * LDP;
      // the strict score rows and r_in x S_in, one pass over a
      float in[8][JL], ie[8][JL];
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int j = 0; j < JL; ++j) in[x][j] = ie[x][j] = 0.0f;
      {
        float sc[8][4];
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[x][i] = 0.0f;
        // at C 128 a first group reads 1 block (q1 < 8) or 2, its partner
        // 4 or 3, or none where the partner's rows are past the chunk
        switch (nb1 * 8 + nb2) {
          case 1 * 8 + 4: scores_and_inter<1, 4, D>(Rs, Ks, Ss, q1, q2, lane, sc, ie); break;
          case 2 * 8 + 3: scores_and_inter<2, 3, D>(Rs, Ks, Ss, q1, q2, lane, sc, ie); break;
          case 1 * 8 + 0: scores_and_inter<1, 0, D>(Rs, Ks, Ss, q1, q2, lane, sc, ie); break;
          default: scores_and_inter<2, 0, D>(Rs, Ks, Ss, q1, q2, lane, sc, ie); break;
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int nbx = x < 4 ? nb1 : nb2;
          const int t = x < 4 ? 4 * q1 + x : 4 * q2 + x - 4;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < nbx) {
              const int s = 32 * i + lane;
              Pw[x * LDP + s] = s < t ? sc[x][i] : 0.0f;
            }
        }
      }
      __syncwarp();

      // scores x v: half h of the warp takes the s-quads 8m + 4h, lane c of
      // the half the columns 4c.. (D/16 of them); the halves' sums added
      {
        constexpr int JC = D / 16;
        const int h = lane / 16, cq = lane % 16;
        float pv[8][JC];
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int j = 0; j < JC; ++j) pv[x][j] = 0.0f;
        // s-quads where both groups have rows, then those of the second
        const int e1 = 4 * q1 + 4, e2 = live2 ? 4 * q2 + 4 : 0;
        if (live2) {
          const int s = scores_v<0, 8, D>(Pw, Vs, 4 * h, e1, cq, pv);
          scores_v<4, 4, D>(Pw, Vs, s, e2, cq, pv);
        } else {
          scores_v<0, 4, D>(Pw, Vs, 4 * h, e1, cq, pv);
        }
        // the two halves' sums, then lane l takes columns JL l.. of them
        // from lane JL l / JC of the first half
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int j = 0; j < JC; ++j) pv[x][j] += __shfl_xor_sync(FULL, pv[x][j], 16);
        const int src = JL * lane / JC, off = JL * lane % JC;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          float got[JC];
#pragma unroll
          for (int j = 0; j < JC; ++j) got[j] = __shfl_sync(FULL, pv[x][j], src);
#pragma unroll
          for (int j = 0; j < JL; ++j) {
            float y = got[0];
#pragma unroll
            for (int q = 1; q < JC; ++q)
              if (off + j == q) y = got[q];
            in[x][j] = y;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int t = x < 4 ? 4 * q1 + x : 4 * q2 + x - 4;
        if (t >= n || (x >= 4 && !live2)) continue;
        const float bt = bonus[t];
        float vt[JL], o[JL];
        load_cols<JL>(Vs + t * LD + JL * lane, vt);
#pragma unroll
        for (int j = 0; j < JL; ++j) o[j] = ie[x][j] + fmaf(bt, vt[j], in[x][j]);
        float* dst = out + (row0 + t) * D + JL * lane;
        if (JL == 2)
          *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[JL - 1]);
        else
          dst[0] = o[0];
      }
    }
  }
}

template <typename T, int D>
size_t smem_bytes() {
  return sizeof(float) * Layout<D>::TOTAL;
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw,
                   const void* u, const void* s0, void* out, void* sfin, void* slots,
                   void* flags, int64_t BH, int64_t H, int64_t S, int c, int grid,
                   cudaStream_t stream) {
  auto kernel = wkv6_tile_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out), static_cast<float*>(sfin),
      static_cast<float*>(slots), static_cast<int*>(flags), static_cast<int>(BH),
      static_cast<int>(H), S, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* logw,
                     const void* u, const void* s0, void* out, void* sfin, void* slots,
                     void* flags, int64_t B, int64_t H, int64_t S, int64_t D, int64_t c,
                     int64_t grid, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  const int64_t chunks = S > 0 ? (S + c - 1) / c : 0;
  if (S < 0 || c < 1 || c > C || grid < 1 || B * H * chunks + grid > 0x7fffffff ||
      B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = static_cast<int>(B * H);
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, out, sfin, slots, flags, BH, H, S, int(c),
                           int(grid), st);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, out, sfin, slots, flags, BH, H, S, int(c),
                           int(grid), st);
    default:
      return cudaErrorInvalidValue;
  }
}

// What one SM takes of the kernel: out = {blocks an SM, dynamic shared
// bytes, registers a thread, local (spill) bytes a thread, threads}.
template <typename T, int D>
cudaError_t plan_of(int64_t* o) {
  auto kernel = wkv6_tile_kernel<T, D>;
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  o[0] = blocks;
  o[1] = static_cast<int64_t>(smem);
  o[2] = attr.numRegs;
  o[3] = static_cast<int64_t>(attr.localSizeBytes);
  o[4] = THREADS;
  return blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename T>
cudaError_t plan_dispatch(int64_t D, int64_t* o) {
  switch (D) {
    case 32: return plan_of<T, 32>(o);
    case 64: return plan_of<T, 64>(o);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_wkv6_f32(const void* r, const void* k, const void* v, const void* logw,
                              const void* u, const void* s0, void* out, void* sfin,
                              void* slots, void* flags, int64_t B, int64_t H, int64_t S,
                              int64_t D, int64_t c, int64_t grid, void* stream) {
  return dispatch<float>(r, k, v, logw, u, s0, out, sfin, slots, flags, B, H, S, D, c, grid,
                         stream);
}

extern "C" int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                               const void* logw, const void* u, const void* s0, void* out,
                               void* sfin, void* slots, void* flags, int64_t B, int64_t H,
                               int64_t S, int64_t D, int64_t c, int64_t grid, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, logw, u, s0, out, sfin, slots, flags, B, H, S, D,
                                 c, grid, stream);
}

extern "C" int repro_wkv6_plan_f32(int64_t D, int64_t* out) {
  return plan_dispatch<float>(D, out);
}

extern "C" int repro_wkv6_plan_bf16(int64_t D, int64_t* out) {
  return plan_dispatch<__nv_bfloat16>(D, out);
}
