// GEMM / GEMM-accumulate for Hopper (sm_90a): O = beta*C + alpha*A*B.
//
// Replaces the TPU kernels repro/kernels/blis_gemm.py::blis_gemm (C = A*B)
// and ::blis_gemm_accum (O = C + alpha*A*B, the DMF trailing update).
//
// What bounds it on an H100: the trailing update of LU at b = 128 has
// K = 128, so per output element it does 2*128 flops against the read and
// write of C -- 16 flop/byte in f64, 32 in f32, around the card's ridge of
// 67 TFLOP/s over 3.35 TB/s = 20 flop/byte.  The large f64 updates are
// bound by bytes, the f32 ones by operations.  The QR paths' V^T C and
// V^T B are skinny (M = 128, N = 16 .. 3968) and deep (K up to 16384): few
// output tiles, so one block per tile leaves most SMs idle and the time
// follows the K chain, not the work.
//
// Design.
//   Split-K, fixed by K alone.  K is cut into chunks of KC terms.  Chunk 0
//   starts from beta*C, every later chunk from 0; each adds its products in
//   ascending k with one accumulator; the chunks' sums are then added onto
//   chunk 0's in ascending chunk order (no atomics).  Which block computes a
//   chunk follows the shape (the plan below): a product whose tiles fill
//   the card loops over the chunks inside one block with a second register
//   accumulator (in_block); a skinny deep one gives each chunk its own
//   blocks, writes chunks 1.. to a workspace the wrapper allocates, and a
//   second kernel adds them in chunk order (across).  Both round alike.
//   The tile, too, follows the shape: small tiles where few would fill the
//   card, larger ones elsewhere.
//   Tile core: each block computes a BM x BN tile of one chunk from BK-deep
//   slices of A and B in a ring of shared-memory stages, filled by cp.async
//   (16-byte copies where the base pointer and leading dimension allow,
//   one element a copy where they do not) while the previous stage is
//   multiplied; one barrier a stage.  float: FFMA on the CUDA cores, an
//   8 x 4 or 8 x 8 register block a thread, B read and C and O moved four
//   columns at a time (TF32 stays off).  double: the f64 tensor
//   cores, mma.sync m16n8k4 (DMMA), a 32 x 32 tile a warp; DMMA's result is
//   bitwise the ascending DFMA chain of its four terms (checked on the card
//   against gemm_chain_kernel, the contract written one thread an element).
//
// Determinism: an element's result depends only on its row of A, its column
// of B, its element of C and on K -- never on M, N, the tile, the mapping or
// the other columns of the call.  So a column (or row) of O does not depend
// on which other columns share the call, which is what keeps the look-ahead
// schedules bitwise equal to the blocked one; for K <= KC the sum is the one
// ascending chain of gemm_step (dense.cuh), which the fused panel updates
// (fused_pu.cu) share.  O may alias C (in-place trailing update): each
// element is read and written by the same thread, or, across blocks, read by
// chunk 0's thread and then by the reduction kernel.
#include "dense.cuh"

// Terms of K summed in one chain before the chunks are added: the split's
// only constant (kernels/blis_gemm.py::KC repeats it for the plain version;
// the tests hold the two equal).
constexpr int64_t KC = 1024;

enum Mapping { SINGLE = 0, IN_BLOCK = 1, ACROSS = 2 };

template <typename T>
struct GemmArgs {
  int64_t M, N, K;
  const T* A;
  int64_t lda;
  const T* B;
  int64_t ldb;
  T beta;
  const T* C;
  int64_t ldc;
  T* O;
  int64_t ldo;
  T* W;          // chunks 1.. of the across mapping, M x N each
  int tiles_n;
};

// Rows [r0, r0 + R) and columns [c0, c0 + CC) of the row-major g (leading
// dimension ld) into s[R][SS]; rows from rmax and columns from cmax on are
// zero.  With VEC, g and ld are 16-byte aligned and c0 is a multiple of
// 16 bytes' worth of elements: 16-byte copies, else one element a copy.
// (A template parameter: a kernel that held the addresses of both kinds of
// copy would spill.)
template <typename T, int R, int CC, int SS, int NT, bool VEC>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g, int64_t ld, int64_t r0,
                                          int64_t rmax, int64_t c0, int64_t cmax) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    constexpr int PER_ROW = CC / V, TOTAL = R * PER_ROW;
#pragma unroll
    for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
      const int e = tid + i * NT;
      if (TOTAL % NT == 0 || e < TOTAL) {
        const int rr = e / PER_ROW, cc = (e % PER_ROW) * V;
        const int64_t r = r0 + rr, c = c0 + cc;
        int64_t valid = r < rmax ? cmax - c : 0;
        valid = valid < 0 ? 0 : (valid > V ? V : valid);
        cp_async16(s + rr * SS + cc, valid > 0 ? g + r * ld + c : g,
                   static_cast<int>(valid * sizeof(T)));
      }
    }
  } else {
    constexpr int TOTAL = R * CC;
#pragma unroll
    for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
      const int e = tid + i * NT;
      if (TOTAL % NT == 0 || e < TOTAL) {
        const int rr = e / CC, cc = e % CC;
        const int64_t r = r0 + rr, c = c0 + cc;
        const bool ok = r < rmax && c < cmax;
        cp_async_elem<sizeof(T)>(s + rr * SS + cc, ok ? g + r * ld + c : g,
                                 ok ? static_cast<int>(sizeof(T)) : 0);
      }
    }
  }
}

// The k range of this block: its chunk blockIdx.z, or all of K (in_block).
template <bool MULTI>
__device__ __forceinline__ void chunk_range(int64_t K, int64_t* kb, int64_t* ke) {
  if (MULTI) {
    *kb = 0;
    *ke = K;
  } else {
    *kb = static_cast<int64_t>(blockIdx.z) * KC;
    *ke = min(K, *kb + KC);
  }
}

// In the in_block loop over all of K: the chunk that k tile kt ended, or
// -1.  (32-bit and by constants: a 64-bit division is a subroutine call,
// around which the accumulators would spill.)
template <int BK>
__device__ __forceinline__ int chunk_ended(int kt, int nkt) {
  constexpr int TILES = static_cast<int>(KC / BK);
  return ((kt + 1) % TILES == 0 || kt == nkt - 1) ? kt / TILES : -1;
}

// ---------------------------------------------------------------------------
// float: FFMA core, a TM x TN register block a thread
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK>
struct FmaSmem {
  static constexpr int SA = BK + 4;  // A stage [BM][SA]: rows of A, k contiguous
  static constexpr int SB = BN;      // B stage [BK][SB]
  static constexpr int STAGE = BM * SA + BK * SB;
};

// A row-major view whose rows start 16-byte aligned.
__device__ __forceinline__ bool rows_aligned16(const void* p, int64_t ld, int size) {
  return ((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(ld * size)) & 15) == 0;
}

// Thread (tx, ty) owns rows ty + i*TY and, in groups of four, columns
// 4*tx + 4*TX*g + e: B is read four columns at a time, and C and O move in
// 16-byte accesses where their rows are aligned.
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int MINB, bool NEG, bool MULTI,
          bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
gemm_fma_kernel(GemmArgs<float> p) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY, G4 = TN / 4;
  using S = FmaSmem<BM, BN, BK>;
  static_assert(BK % 4 == 0 && KC % BK == 0, "k slices of 4 that tile a chunk");
  static_assert(TN % 4 == 0, "columns in groups of four");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / p.tiles_n) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % p.tiles_n) * BN;
  int64_t kb, ke;
  chunk_range<MULTI>(p.K, &kb, &ke);
  const int nkt = static_cast<int>((ke - kb + BK - 1) / BK);
  auto row = [&](int i) { return m0 + ty + i * TY; };
  auto col = [&](int g) { return n0 + 4 * tx + 4 * TX * g; };

  auto load = [&](int stage, int kt) {
    float* as = smem + stage * S::STAGE;
    const int64_t k0 = kb + static_cast<int64_t>(kt) * BK;
    load_tile<float, BM, BK, S::SA, NT, VEC>(as, p.A, p.lda, m0, p.M, k0, ke);
    load_tile<float, BK, BN, S::SB, NT, VEC>(as + BM * S::SA, p.B, p.ldb, k0, ke, n0, p.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }

  float part[TM][TN], acc[MULTI ? TM : 1][MULTI ? TN : 1];
  const bool from_c = (MULTI || blockIdx.z == 0) && p.beta != 0.0f;
  const bool c16 = rows_aligned16(p.C, p.ldc, 4);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int64_t r = row(i), c = col(g);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (from_c && r < p.M) {
        const float* src = p.C + r * p.ldc + c;
        if (c16 && c + 3 < p.N) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          v.x = c < p.N ? src[0] : 0.0f;
          v.y = c + 1 < p.N ? src[1] : 0.0f;
          v.z = c + 2 < p.N ? src[2] : 0.0f;
          v.w = c + 3 < p.N ? src[3] : 0.0f;
        }
      }
      part[i][4 * g] = from_c ? p.beta * v.x : 0.0f;
      part[i][4 * g + 1] = from_c ? p.beta * v.y : 0.0f;
      part[i][4 * g + 2] = from_c ? p.beta * v.z : 0.0f;
      part[i][4 * g + 3] = from_c ? p.beta * v.w : 0.0f;
    }
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nkt) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * S::STAGE;
    const float* bs = as + BM * S::SA;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(as + (ty + i * TY) * S::SA + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(bs + (kq + kk) * S::SB + 4 * tx + 4 * TX * g);
          b[4 * g] = b4.x;
          b[4 * g + 1] = b4.y;
          b[4 * g + 2] = b4.z;
          b[4 * g + 3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = gemm_step(part[i][j], NEG ? -a : a, b[j]);
        }
      }
    }
    if (MULTI) {
      const int done = chunk_ended<BK>(kt, nkt);
      if (done >= 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[MULTI ? i : 0][MULTI ? j : 0] =
                done == 0 ? part[i][j] : acc[MULTI ? i : 0][MULTI ? j : 0] + part[i][j];
            part[i][j] = 0.0f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = p.O;
  int64_t ldd = p.ldo;
  if (!MULTI && blockIdx.z > 0) {
    dst = p.W + static_cast<int64_t>(blockIdx.z - 1) * p.M * p.N;
    ldd = p.N;
  }
  const bool d16 = rows_aligned16(dst, ldd, 4);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row(i);
    if (r >= p.M) continue;
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int64_t c = col(g);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = MULTI && nkt > 0 ? acc[MULTI ? i : 0][MULTI ? 4 * g + e : 0] : part[i][4 * g + e];
      float* out = dst + r * ldd + c;
      if (d16 && c + 3 < p.N) {
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < p.N) out[e] = v[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// double: DMMA core, mma.sync m16n8k4, a (MT*16) x (NT8*8) tile a warp
// ---------------------------------------------------------------------------
// d += a * b over one 16 x 8 x 4 step (g = lane/4, q = lane%4): a = A[g][q],
// A[g+8][q]; b = B[q][g]; d = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
// On an H100 this shape runs at the f64 tensor-core rate (67 TFLOP/s), the
// older m8n8k4 at half of it; both give bitwise the ascending DFMA chain.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int BM, int BN, int BK>
struct DmmaSmem {
  // Pads of 4 doubles put the 16 lanes of each half-warp's fragment loads
  // on 16 distinct 8-byte banks.
  static constexpr int SA = BK + 4;  // A stage [BM][SA]
  static constexpr int SB = BN + 4;  // B stage [BK][SB]
  static constexpr int STAGE = BM * SA + BK * SB;
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, int MINB, bool NEG, bool MULTI,
          bool VEC>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
gemm_dmma_kernel(GemmArgs<double> p) {
  constexpr int NT = WM * WN * 32;
  constexpr int MT = BM / WM / 16, NT8 = BN / WN / 8;  // 16 x 8 tiles a warp
  using S = DmmaSmem<BM, BN, BK>;
  static_assert(BK % 4 == 0 && KC % BK == 0, "k steps of 4 that tile a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wr = (warp / WN) * (BM / WM), wc = (warp % WN) * (BN / WN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / p.tiles_n) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % p.tiles_n) * BN;
  int64_t kb, ke;
  chunk_range<MULTI>(p.K, &kb, &ke);
  const int nkt = static_cast<int>((ke - kb + BK - 1) / BK);
  // tile row and column of accumulator e of 16 x 8 tile (i, j)
  auto row = [&](int i, int e) { return wr + i * 16 + g + 8 * (e >> 1); };
  auto col = [&](int j, int e) { return wc + j * 8 + 2 * q + (e & 1); };

  auto load = [&](int stage, int kt) {
    double* as = smem + stage * S::STAGE;
    const int64_t k0 = kb + static_cast<int64_t>(kt) * BK;
    load_tile<double, BM, BK, S::SA, NT, VEC>(as, p.A, p.lda, m0, p.M, k0, ke);
    load_tile<double, BK, BN, S::SB, NT, VEC>(as + BM * S::SA, p.B, p.ldb, k0, ke, n0, p.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }

  double part[MT][NT8][4], acc[MULTI ? MT : 1][MULTI ? NT8 : 1][4];
  const bool from_c = (MULTI || blockIdx.z == 0) && p.beta != 0.0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = m0 + row(i, e), c = n0 + col(j, e);
        part[i][j][e] = (from_c && r < p.M && c < p.N) ? p.beta * p.C[r * p.ldc + c] : 0.0;
      }
    }
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nkt) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const double* as = smem + (kt % STAGES) * S::STAGE;
    const double* bs = as + BM * S::SA;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      double a[MT][2], b[NT8];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double x = as[(wr + i * 16 + g + 8 * h) * S::SA + kq + q];
          a[i][h] = NEG ? -x : x;
        }
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j) b[j] = bs[(kq + q) * S::SB + wc + j * 8 + g];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT8; ++j) dmma(part[i][j], a[i], b[j]);
      }
    }
    if (MULTI) {
      const int done = chunk_ended<BK>(kt, nkt);
      if (done >= 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NT8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              double& x = acc[MULTI ? i : 0][MULTI ? j : 0][e];
              x = done == 0 ? part[i][j][e] : x + part[i][j][e];
              part[i][j][e] = 0.0;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  double* dst = p.O;
  int64_t ldd = p.ldo;
  if (!MULTI && blockIdx.z > 0) {
    dst = p.W + static_cast<int64_t>(blockIdx.z - 1) * p.M * p.N;
    ldd = p.N;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = m0 + row(i, e), c = n0 + col(j, e);
        if (r < p.M && c < p.N)
          dst[r * ldd + c] =
              MULTI && nkt > 0 ? acc[MULTI ? i : 0][MULTI ? j : 0][e] : part[i][j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The across mapping's second pass: O += chunk 1, then chunk 2, ...
// ---------------------------------------------------------------------------
template <typename T>
__global__ void gemm_reduce_kernel(int64_t M, int64_t N, int64_t parts, const T* __restrict__ W,
                                   T* O, int64_t ldo) {
  const int64_t total = M * N;
  for (int64_t r = blockIdx.y; r < M; r += gridDim.y) {
    for (int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; c < N;
         c += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      T acc = O[r * ldo + c];
      for (int64_t z = 0; z < parts; ++z) acc = acc + W[z * total + r * N + c];
      O[r * ldo + c] = acc;
    }
  }
}

// The contract written out, one thread an element: chunk 0 from beta*C,
// later chunks from 0, each an ascending gemm_step chain, then added in
// order.  Not on any path: the card tests hold the tile kernels to it
// bitwise (for double, that is the check that DMMA keeps the DFMA chain).
template <typename T>
__global__ void gemm_chain_kernel(GemmArgs<T> p, T alpha) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= p.M * p.N) return;
  const int64_t r = e / p.N, c = e % p.N;
  T acc = p.beta != T(0) ? p.beta * p.C[r * p.ldc + c] : T(0);
  for (int64_t k0 = 0; k0 < p.K; k0 += KC) {
    T part = k0 == 0 ? acc : T(0);
    for (int64_t k = k0; k < min(p.K, k0 + KC); ++k)
      part = gemm_step(part, alpha * p.A[r * p.lda + k], p.B[k * p.ldb + c]);
    acc = k0 == 0 ? part : acc + part;
  }
  p.O[r * p.ldo + c] = acc;
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------
struct Tile {
  int bm, bn;
};

// A dtype's three tiles: small; wide, for one chunk (or all chunks in one
// block) of a product whose tiles fill the card; deep, for one chunk of a
// product that fills it only chunk by chunk.
struct Tiles {
  Tile small, wide, deep;
};
enum TileKind { SMALL_TILE = 0, WIDE_TILE = 1, DEEP_TILE = 2 };

// The tile, the number of chunks and the mapping: a product whose wide
// tiles fill the card keeps them and, when split, loops over the chunks in
// one block; one whose deep tiles fill it only chunk by chunk spreads the
// chunks over blocks; anything smaller takes small tiles.
struct Plan {
  int kind;
  Tile tile;
  int64_t chunks;
  int mapping;
  int64_t workspace;  // elements of the across mapping's partials
};

static int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

static cudaError_t make_plan(int64_t M, int64_t N, int64_t K, const Tiles& t, Plan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t chunks = K > KC ? cdiv(K, KC) : 1;
  plan->chunks = chunks;
  if (cdiv(M, t.wide.bm) * cdiv(N, t.wide.bn) >= sms) {
    plan->kind = WIDE_TILE;
    plan->mapping = chunks == 1 ? SINGLE : IN_BLOCK;
  } else if (chunks > 1 && cdiv(M, t.deep.bm) * cdiv(N, t.deep.bn) * chunks >= sms) {
    plan->kind = DEEP_TILE;
    plan->mapping = ACROSS;
  } else {
    plan->kind = SMALL_TILE;
    plan->mapping = chunks == 1 ? SINGLE : ACROSS;
  }
  plan->tile = plan->kind == WIDE_TILE ? t.wide : plan->kind == DEEP_TILE ? t.deep : t.small;
  plan->workspace = plan->mapping == ACROSS ? (chunks - 1) * M * N : 0;
  return cudaSuccess;
}

// One tile configuration: the kernel for (NEG, MULTI) and its shared memory.
// The shared-memory limit is raised once a kernel (a host call per launch
// would cost as much as a small trailing update).
template <typename T, typename Kernel>
static cudaError_t launch_tile(Kernel kernel, size_t smem, int threads, const Plan& plan,
                               GemmArgs<T> args, cudaStream_t stream) {
  static const void* raised[32];
  static int n_raised = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  bool known = false;
  for (int i = 0; i < n_raised; ++i) known = known || raised[i] == key;
  if (!known) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    if (n_raised < 32) raised[n_raised++] = key;
  }
  const int64_t tiles_n = cdiv(args.N, plan.tile.bn);
  const int64_t tiles = cdiv(args.M, plan.tile.bm) * tiles_n;
  if (tiles > 0x7fffffff || plan.chunks > 65535) return cudaErrorInvalidValue;
  args.tiles_n = static_cast<int>(tiles_n);
  const unsigned z = plan.mapping == ACROSS ? static_cast<unsigned>(plan.chunks) : 1u;
  kernel<<<dim3(static_cast<unsigned>(tiles), 1, z), threads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_reduce(const Plan& plan, const GemmArgs<T>& a, cudaStream_t stream) {
  const int64_t gx = cdiv(a.N, 256) < 64 ? cdiv(a.N, 256) : 64;
  const int64_t gy = a.M < 65535 ? a.M : 65535;
  gemm_reduce_kernel<T><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), 256, 0,
                          stream>>>(
      a.M, a.N, plan.chunks - 1, a.W, a.O, a.ldo);
  return cudaGetLastError();
}

// float: small 32 x 32 (2 x 4 a thread, 128 threads, 4 stages); wide
// 64 x 64 (8 x 4 a thread, 128 threads, four blocks an SM: their C loads and
// stores hide behind each other's products); deep 128 x 128 (8 x 8 a thread,
// 256 threads, BK 32).  double: small 32 x 32 (4 warps of 16 x 16, 4
// stages); wide and deep 128 x 64 (8 warps of 32 x 32, two blocks an SM).
// BK 16 where not said.
constexpr Tiles F32_TILES{{32, 32}, {64, 64}, {128, 128}};
constexpr Tiles F64_TILES{{32, 32}, {128, 64}, {128, 64}};
constexpr int BK = 16;

template <bool NEG, bool VEC>
static cudaError_t run_f32(const Plan& plan, const GemmArgs<float>& a, cudaStream_t s) {
  if (plan.kind == WIDE_TILE) {
    constexpr size_t smem = 3 * FmaSmem<64, 64, BK>::STAGE * sizeof(float);
    if (plan.mapping == IN_BLOCK)
      return launch_tile(gemm_fma_kernel<64, 64, BK, 8, 4, 3, 2, NEG, true, VEC>, smem, 128,
                         plan, a, s);
    return launch_tile(gemm_fma_kernel<64, 64, BK, 8, 4, 3, 4, NEG, false, VEC>, smem, 128, plan,
                       a, s);
  }
  if (plan.kind == DEEP_TILE) {
    constexpr size_t smem = 3 * FmaSmem<128, 128, 2 * BK>::STAGE * sizeof(float);
    return launch_tile(gemm_fma_kernel<128, 128, 2 * BK, 8, 8, 3, 1, NEG, false, VEC>, smem,
                       256, plan, a, s);
  }
  constexpr size_t smem = 4 * FmaSmem<32, 32, BK>::STAGE * sizeof(float);
  return launch_tile(gemm_fma_kernel<32, 32, BK, 2, 4, 4, 1, NEG, false, VEC>, smem, 128, plan,
                     a, s);
}

template <bool NEG, bool VEC>
static cudaError_t run_f64(const Plan& plan, const GemmArgs<double>& a, cudaStream_t s) {
  if (plan.kind != SMALL_TILE) {
    constexpr size_t smem = 3 * DmmaSmem<128, 64, BK>::STAGE * sizeof(double);
    if (plan.mapping == IN_BLOCK)
      return launch_tile(gemm_dmma_kernel<128, 64, BK, 4, 2, 3, 1, NEG, true, VEC>, smem, 256,
                         plan, a, s);
    return launch_tile(gemm_dmma_kernel<128, 64, BK, 4, 2, 3, 2, NEG, false, VEC>, smem, 256,
                       plan, a, s);
  }
  constexpr size_t smem = 4 * DmmaSmem<32, 32, BK>::STAGE * sizeof(double);
  return launch_tile(gemm_dmma_kernel<32, 32, BK, 2, 2, 4, 1, NEG, false, VEC>, smem, 128, plan,
                     a, s);
}

template <typename T, bool NEG, bool VEC>
static cudaError_t run(const Plan& plan, const GemmArgs<T>& a, cudaStream_t s) {
  if constexpr (sizeof(T) == 8)
    return run_f64<NEG, VEC>(plan, a, s);
  else
    return run_f32<NEG, VEC>(plan, a, s);
}

template <typename T>
static GemmArgs<T> args_of(int64_t M, int64_t N, int64_t K, const void* A, int64_t lda,
                           const void* B, int64_t ldb, double beta, const void* C, int64_t ldc,
                           void* O, int64_t ldo, void* W) {
  GemmArgs<T> a;
  a.M = M;
  a.N = N;
  a.K = K;
  a.A = static_cast<const T*>(A);
  a.lda = lda;
  a.B = static_cast<const T*>(B);
  a.ldb = ldb;
  a.beta = static_cast<T>(beta);
  a.C = static_cast<const T*>(C);
  a.ldc = ldc;
  a.O = static_cast<T*>(O);
  a.ldo = ldo;
  a.W = static_cast<T*>(W);
  a.tiles_n = 1;
  return a;
}

// alpha must be +1 or -1 (the wrapper folds any other alpha into A); W
// holds w_elems elements, at least the plan's workspace.
template <typename T>
static cudaError_t launch_gemm(int64_t M, int64_t N, int64_t K, double alpha, const void* A,
                               int64_t lda, const void* B, int64_t ldb, double beta,
                               const void* C, int64_t ldc, void* O, int64_t ldo, void* W,
                               int64_t w_elems, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (alpha != 1.0 && alpha != -1.0) return cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan(M, N, K, sizeof(T) == 8 ? F64_TILES : F32_TILES, &plan);
  if (err != cudaSuccess) return err;
  if (plan.workspace > 0 && (W == nullptr || w_elems < plan.workspace))
    return cudaErrorInvalidValue;
  const GemmArgs<T> a = args_of<T>(M, N, K, A, lda, B, ldb, beta, C, ldc, O, ldo, W);
  const bool vec = aligned16(A, lda, sizeof(T)) && aligned16(B, ldb, sizeof(T));
  if (alpha < 0)
    err = vec ? run<T, true, true>(plan, a, stream) : run<T, true, false>(plan, a, stream);
  else
    err = vec ? run<T, false, true>(plan, a, stream) : run<T, false, false>(plan, a, stream);
  if (err == cudaSuccess && plan.mapping == ACROSS) err = launch_reduce<T>(plan, a, stream);
  return err;
}

template <typename T>
static int query_plan(int64_t M, int64_t N, int64_t K, int64_t* out) {
  Plan plan;
  const cudaError_t err = make_plan(M, N, K, sizeof(T) == 8 ? F64_TILES : F32_TILES, &plan);
  if (err != cudaSuccess) return err;
  out[0] = plan.tile.bm;
  out[1] = plan.tile.bn;
  out[2] = plan.chunks;
  out[3] = plan.mapping;
  out[4] = plan.workspace;
  out[5] = KC;
  return cudaSuccess;
}

template <typename T>
static int launch_chain(int64_t M, int64_t N, int64_t K, double alpha, const void* A, int64_t lda,
                        const void* B, int64_t ldb, double beta, const void* C, int64_t ldc,
                        void* O, int64_t ldo, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const GemmArgs<T> a = args_of<T>(M, N, K, A, lda, B, ldb, beta, C, ldc, O, ldo, nullptr);
  gemm_chain_kernel<T><<<static_cast<unsigned>(cdiv(M * N, 128)), 128, 0, stream>>>(
      a, static_cast<T>(alpha));
  return cudaGetLastError();
}

#define REPRO_GEMM_ENTRIES(T, SFX)                                                             \
  extern "C" int repro_gemm_##SFX(int64_t M, int64_t N, int64_t K, double alpha, const void* A, \
                                  int64_t lda, const void* B, int64_t ldb, double beta,         \
                                  const void* C, int64_t ldc, void* O, int64_t ldo, void* W,    \
                                  int64_t w_elems, void* stream) {                              \
    return launch_gemm<T>(M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, O, ldo, W, w_elems,     \
                          static_cast<cudaStream_t>(stream));                                   \
  }                                                                                             \
  extern "C" int repro_gemm_plan_##SFX(int64_t M, int64_t N, int64_t K, int64_t* out) {        \
    return query_plan<T>(M, N, K, out);                                                         \
  }                                                                                             \
  extern "C" int repro_gemm_chain_##SFX(int64_t M, int64_t N, int64_t K, double alpha,         \
                                        const void* A, int64_t lda, const void* B, int64_t ldb, \
                                        double beta, const void* C, int64_t ldc, void* O,       \
                                        int64_t ldo, void* stream) {                            \
    return launch_chain<T>(M, N, K, alpha, A, lda, B, ldb, beta, C, ldc, O, ldo,                \
                           static_cast<cudaStream_t>(stream));                                  \
  }

REPRO_GEMM_ENTRIES(float, f32)
REPRO_GEMM_ENTRIES(double, f64)
