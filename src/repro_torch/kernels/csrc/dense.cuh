// Element routines shared by the kernels that must round alike.
//
// The look-ahead schedules are bitwise equal to the blocked one only if
// every kernel that computes part of a step rounds exactly as the kernel it
// stands in for.  The fused panel updates (fused_pu.cu) replace a TRSM, a
// GEMM-accumulate and a panel factorization, so they share these routines
// with gemm.cu and panel_lu.cu instead of retyping them.  trsm.cu runs
// solve_vector only in its chain kernel (the contract, on no path); its
// strip routines (strip.cuh), which also run the small LU solve as two walks
// and the fused LU update's U12, keep solve_vector's order term for term
// and are held to the chain kernel bitwise:
//
//   gemm_step     one term of the GEMM accumulator: acc + a*b in one FMA,
//                 with alpha already folded into a, k ascending;
//   solve_vector  one right-hand side of a triangular solve: the row sums of
//                 x[i] = (b[i] - sum_j T[i, j] * x[j]) / T[i, i], one FMA a
//                 term, ascending j for a lower and descending j for an upper
//                 triangle;
//   getf2_rows    the GETF2 column loop of a cooperative grid, each block on
//                 its own rows, in shared memory or in device memory (the
//                 note in panel_lu.cu says how it works); products and
//                 differences rounded once each, no FMA.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ T gemm_step(T acc, T a, T b) { return fma(a, b, acc); }

// Terms of K summed in one chain before the chunks are added (gemm.cu's
// split, whose note says how; kernels/blis_gemm.py::KC repeats it for the
// plain version and the tests hold the two equal).
constexpr int64_t KC = 1024;

// The f64 tensor-core step of gemm.cu and of the fused LU panel update:
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

// x[i * xs], i < b, is one right-hand side, solved in place.  The triangle
// may live in device or shared memory.
template <typename T, bool LOWER, bool UNIT>
__device__ void solve_vector(int64_t b, const T* t, int64_t ldt, T* x, int64_t xs) {
  if (LOWER) {
    for (int64_t i = 0; i < b; ++i) {
      T acc = x[i * xs];
      for (int64_t j = 0; j < i; ++j) acc = fma(-t[i * ldt + j], x[j * xs], acc);
      if (!UNIT) acc = div_rn(acc, t[i * ldt + i]);
      x[i * xs] = acc;
    }
  } else {
    for (int64_t i = b - 1; i >= 0; --i) {
      T acc = x[i * xs];
      for (int64_t j = b - 1; j > i; --j) acc = fma(-t[i * ldt + j], x[j * xs], acc);
      if (!UNIT) acc = div_rn(acc, t[i * ldt + i]);
      x[i * xs] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// Cooperative grids over the rows of a panel.
// ---------------------------------------------------------------------------
// The rows [r0, r1) that block `blk` of `G` owns in an m-row panel: chunks
// of ceil(m / G) rows (the GETF2 and Hessenberg panels).
__device__ __forceinline__ void owned_rows(int64_t m, int G, int blk, int64_t* chunk,
                                           int64_t* r0, int64_t* r1) {
  *chunk = (m + G - 1) / G;
  *r0 = min(m, blk * *chunk);
  *r1 = min(m, *r0 + *chunk);
}

// The QR-family panels' rows (GEQR2/LARFT, xLAQPS): chunks of DEAL_ROWS
// rows dealt round-robin over the grid, block `blk` of G owning chunks blk,
// blk + G, blk + 2G, ..., in that order, with G = min(ceil(m / DEAL_ROWS),
// the card's cap).  Which block owns a row, and its place in that block's
// rows, depend on the row alone at every height once G is the cap; a panel
// padded with zero rows below (a bucketed system) so gives each block its
// raw rows followed by zeros, and each block-ordered cross-block sum its
// raw partials followed by zero ones: its real part keeps the raw bits.
// Local row rr of a block is its (rr / 32)-th chunk's row rr % 32; the
// local order is the global order.
constexpr int64_t DEAL_ROWS = 32;

__host__ __device__ constexpr int64_t dealt_grid(int64_t m, int64_t cap) {
  return (m + DEAL_ROWS - 1) / DEAL_ROWS < cap ? (m + DEAL_ROWS - 1) / DEAL_ROWS : cap;
}

// Rows a block owns at most: its ceil(chunks / G) whole chunks.
__host__ __device__ constexpr int64_t dealt_max_rows(int64_t m, int64_t G) {
  return ((m + DEAL_ROWS - 1) / DEAL_ROWS + G - 1) / G * DEAL_ROWS;
}

struct Dealt {
  int64_t m;
  int G, blk, n;  // n: the rows this block owns
  __device__ __forceinline__ Dealt(int64_t m_, int G_, int blk_) : m(m_), G(G_), blk(blk_) {
    n = lower(m_);
  }
  // the global row of local row rr
  __device__ __forceinline__ int64_t row(int rr) const {
    return static_cast<int64_t>((rr >> 5) * G + blk) * DEAL_ROWS + (rr & 31);
  }
  // the block's chunks below chunk ch, and whether ch is the block's; the
  // rows a column pass asks about lie in the first round of chunks (ch <
  // blk + G), where no division is needed
  __device__ __forceinline__ void chunks_below(int ch, int* full, bool* mine) const {
    const int d = ch - blk;
    if (d <= 0) {
      *full = 0;
      *mine = d == 0;
    } else if (d < G) {
      *full = 1;
      *mine = false;
    } else {
      *full = (d + G - 1) / G;
      *mine = d % G == 0;
    }
  }
  __device__ __forceinline__ bool owns(int64_t g) const {
    if (g < 0 || g >= m) return false;
    int full;
    bool mine;
    chunks_below(static_cast<int>(g >> 5), &full, &mine);
    return mine;
  }
  // how many of the block's rows lie above global row g: the local index of
  // the block's first row >= g
  __device__ __forceinline__ int lower(int64_t g) const {
    if (g <= 0) return 0;
    const int64_t gg = g < m ? g : m;
    int full;
    bool mine;
    chunks_below(static_cast<int>(gg >> 5), &full, &mine);
    return full * static_cast<int>(DEAL_ROWS) + (mine ? static_cast<int>(gg & 31) : 0);
  }
  // the local index of global row g, -1 where another block owns it
  __device__ __forceinline__ int local(int64_t g) const { return owns(g) ? lower(g) : -1; }
};

// A block's dealt rows (D.n of them): row rr at p + off(rr), rr * ld where
// the block holds them itself (LOCAL: shared memory), else D.row(rr) * ld
// (the panel in device memory).  A loop that reads and writes a row finds
// its offset once, and one that moves by whole chunks adds advance(rows).
template <typename T, typename I, bool LOCAL>
struct DealtRows {
  T* p;
  I ld;
  Dealt D;
  __device__ __forceinline__ I off(int rr) const {
    return LOCAL ? static_cast<I>(rr) * ld : static_cast<I>(D.row(rr)) * ld;
  }
  // off(rr + rows) - off(rr) where rows is a multiple of DEAL_ROWS
  __device__ __forceinline__ I advance(int rows) const {
    return LOCAL ? static_cast<I>(rows) * ld : static_cast<I>(rows) * D.G * ld;
  }
  __device__ __forceinline__ T& at(int rr, int c) const { return p[off(rr) + c]; }
};

template <typename Kernel>
static cudaError_t launch_cooperative(Kernel kernel, int grid, size_t smem, void** args,
                                      cudaStream_t stream, int threads) {
  if (grid < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The SMs of the current card and the most shared memory a block may opt in
// to; an error where the card runs no cooperative launch.
static cudaError_t panel_card(int* sms, int* optin) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Whether `kernel` runs at least one block of `threads` an SM with `smem`
// bytes of dynamic shared memory, so that a grid of one block an SM is
// co-resident.
template <typename Kernel>
static cudaError_t fits_one_block(Kernel kernel, int threads, size_t smem, bool* ok) {
  int per_sm = 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *ok = err == cudaSuccess && per_sm >= 1;
  return err;
}

// ---------------------------------------------------------------------------
// Fixed-order sums for the panels' grids (no atomics: the same bits on every
// run and in every block that takes the same sum).
// ---------------------------------------------------------------------------
constexpr int PANEL_MAX_BLOCKS = 256;  // blocks a grid at most: a lane sums 8 partials
constexpr int LANE_PARTIALS = PANEL_MAX_BLOCKS / 32;

// Sum of x over the warp, the same bits in every lane.
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane `lane`'s share of the G block partials at src[g * stride], g =
// lane, lane+32, ..., in turn (all loaded before the first is added).
template <typename T>
__device__ __forceinline__ T lane_partials(const T* src, int64_t stride, int G, int lane) {
  T x[LANE_PARTIALS];
#pragma unroll
  for (int k = 0; k < LANE_PARTIALS; ++k) {
    const int g = lane + 32 * k;
    x[k] = g < G ? __ldcg(src + g * stride) : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < LANE_PARTIALS; ++k) acc += x[k];
  return acc;
}

// The cross-block sums of the entries e < ne, entry e's G block partials at
// src[e * G + g]: the block's warps take the entries in turn (warp w:
// entries w, w + warps, ..., CROSS_BATCH of them with all their partials
// loaded before any is added), lane l adds blocks l, l + 32, ... and a
// butterfly gives every lane the sum; done(e, sum) runs in every lane.
// Each sum takes ceil(G/32) terms in turn, then five shuffle steps.
constexpr int CROSS_BATCH = 4;
template <typename T, typename Done>
__device__ __forceinline__ void cross_sums(const T* src, int ne, int G, Done done) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int e0 = warp; e0 < ne; e0 += warps * CROSS_BATCH) {
    T s[CROSS_BATCH];
#pragma unroll
    for (int b = 0; b < CROSS_BATCH; ++b) {
      const int e = e0 + b * warps;
      s[b] = e < ne ? lane_partials(src + static_cast<int64_t>(e) * G, 1, G, lane) : T(0);
    }
#pragma unroll
    for (int b = 0; b < CROSS_BATCH; ++b) s[b] = warp_sum(s[b]);
#pragma unroll
    for (int b = 0; b < CROSS_BATCH; ++b)
      if (e0 + b * warps < ne) done(e0 + b * warps, s[b]);
  }
}

// Group sums: for the items e < ne, 2^lg lanes an item take the terms i in
// [lo(e), hi(e)) -- lane s of the group i = lo + s, lo + s + 2^lg, ... in
// one chain, acc = step(e, i, acc) -- then lg shuffle steps; done(e, sum)
// runs in the group's first lane.  The loop over the items is warp-uniform,
// so every lane reaches every shuffle.  Each sum takes ceil(len / 2^lg)
// terms in turn, then lg.
template <typename T, typename Lo, typename Hi, typename Step, typename Done>
__device__ __forceinline__ void group_sums(int ne, int lg, Lo lo, Hi hi, Step step, Done done) {
  const int lane = threadIdx.x & 31, tpr = 1 << lg;
  const int per_warp = 32 >> lg, stride = (blockDim.x >> 5) * per_warp;
  const int sub = lane & (tpr - 1);
  for (int base = (threadIdx.x >> 5) * per_warp; base < ne; base += stride) {
    const int e = base + (lane >> lg);
    T acc = T(0);
    if (e < ne) {
      const int h = hi(e);
#pragma unroll 4
      for (int i = lo(e) + sub; i < h; i += tpr) acc = step(e, i, acc);
    }
    for (int off = tpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (e < ne && sub == 0) done(e, acc);
  }
}

// lg of the lanes an item for `items` items over `threads` threads: as many
// as leave every item a group at once, from 1 to 32.
__host__ __device__ constexpr int group_lg(int64_t items, int threads) {
  int lg = 0;
  while (lg < 5 && items * (int64_t{2} << lg) <= threads) ++lg;
  return lg;
}

// Row groups of block_col_sums over nc columns: threads / min(nc, threads),
// at most COLSUM_GROUPS.
constexpr int COLSUM_GROUPS = 16;
__host__ __device__ constexpr int colsum_groups(int64_t nc, int threads) {
  const int64_t cw = nc < threads ? (nc > 0 ? nc : 1) : threads;
  const int64_t rg = threads / cw;
  return static_cast<int>(rg < COLSUM_GROUPS ? rg : COLSUM_GROUPS);
}

template <typename T, int U, bool SQ, bool CG, typename Row, typename X>
__device__ __forceinline__ void col_sums_impl(Row row_at, X x_at, int lo, int n, int nc, T* red,
                                              T* out, bool flat) {
  const int tid = threadIdx.x, threads = blockDim.x;
  const int cw = nc < threads ? nc : threads, rg = flat ? 1 : colsum_groups(nc, threads);
  const int grp = tid / cw, ci = tid - grp * cw;
  if (grp < rg) {
    for (int i0 = ci; i0 < nc; i0 += cw * U) {
      T acc[U];
      int cs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[u] = T(0);
        cs[u] = min(i0 + cw * u, nc - 1);  // past nc: column nc - 1, never stored
      }
#pragma unroll(sizeof(T) == 4 ? 4 : 2)
      for (int rr = lo + grp; rr < n; rr += rg) {
        const T* row = row_at(rr);
        const T xr = SQ ? T(0) : x_at(rr);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T y = CG ? __ldcg(row + cs[u]) : row[cs[u]];
          acc[u] = fma(SQ ? y : xr, y, acc[u]);
        }
      }
      if (rg == 1) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + cw * u < nc)
            out[static_cast<int64_t>(i0 + cw * u) * gridDim.x + blockIdx.x] = acc[u];
      } else {
        red[grp * cw + ci] = acc[0];
      }
    }
  }
  if (rg > 1) {  // nc <= threads / 2: one column a thread, the groups added in order
    __syncthreads();
    for (int i = tid; i < nc; i += threads) {
      T s = red[i];
      for (int g = 1; g < rg; ++g) s += red[g * cw + i];
      out[static_cast<int64_t>(i) * gridDim.x + blockIdx.x] = s;
    }
  }
}

// The block's partial sums over its rows rr in [lo, n) of x_rr * M[rr, i]
// for the columns i < nc (row rr of M at m + rr * ld; x_rr = x[rr * xs], or
// with SQ M[rr, i] itself, the column's squares), into out[i * G + block].
// Threads take columns (consecutive threads consecutive columns, up to
// COLSUM_COLS at once where the columns outnumber the threads) and row
// groups rr = g (mod rg), rg = colsum_groups(nc); the groups' sums are
// added in group order through red[] (blockDim.x entries).  Each sum takes
// ceil((n - lo) / rg) terms in turn, then rg - 1.  CG: M is in device
// memory and streamed past L1.
constexpr int COLSUM_COLS = 8;
template <typename T, bool SQ, bool CG = false, typename I>
__device__ __forceinline__ void block_col_sums(const T* m, I ld, const T* x, I xs, int lo, int n,
                                               int nc, T* red, T* out) {
  if (nc <= 0) return;
  auto row_at = [=](int rr) { return m + rr * ld; };
  auto x_at = [=](int rr) { return x[rr * xs]; };
  if (nc <= static_cast<int>(blockDim.x))
    col_sums_impl<T, 1, SQ, CG>(row_at, x_at, lo, n, nc, red, out, false);
  else
    col_sums_impl<T, COLSUM_COLS, SQ, CG>(row_at, x_at, lo, n, nc, red, out, false);
}

// The same sums with rg = 1 whatever nc ("flat"): each sum one chain over
// the rows in order, the same for a block of any width or height (a padded
// system's extra columns and rows).  Row rr starts at row_at(rr) (rows
// anywhere, e.g. dealt chunks), x_rr = x_at(rr); red is not used.
template <typename T, bool SQ, bool CG, typename Row, typename X>
__device__ __forceinline__ void flat_col_sums(Row row_at, X x_at, int lo, int n, int nc,
                                              T* out) {
  if (nc <= 0) return;
  if (nc <= static_cast<int>(blockDim.x))
    col_sums_impl<T, 1, SQ, CG>(row_at, x_at, lo, n, nc, static_cast<T*>(nullptr), out, true);
  else
    col_sums_impl<T, COLSUM_COLS, SQ, CG>(row_at, x_at, lo, n, nc, static_cast<T*>(nullptr), out,
                                          true);
}

// ---------------------------------------------------------------------------
// GETF2 with partial pivoting over the rows of a cooperative grid.
// ---------------------------------------------------------------------------
// (v, i) ranks above (bv, bi): larger value, or the same value at a smaller
// row.  NaN never ranks above anything.
template <typename T>
__device__ __forceinline__ bool better(T v, int64_t i, T bv, int64_t bi) {
  return v > bv || (v == bv && i < bi);
}

constexpr int GETF2_THREADS = 256, GETF2_WARPS = GETF2_THREADS / 32;
constexpr int64_t GETF2_MIN_ROWS = 32;  // rows a block at least
constexpr int GETF2_MAX_BLOCKS = 256;   // blocks a grid at most (8 a lane to reduce)
constexpr int GETF2_COLS = 4;           // columns a lane updates at once
// Shared bytes a block's GETF2 needs before its rows: the warps' maxima,
// the pivot row and the pivot's index.
template <typename T>
__host__ __device__ constexpr size_t getf2_scratch(int64_t nb) {
  return (256 + static_cast<size_t>(nb) * sizeof(T) + 15) / 16 * 16;
}

// The rows [r0, r0 + n) of a panel: row rr of them at p + rr * ld, in
// shared memory (I = int) or in device memory (I = int64_t).
template <typename T, typename I>
struct RowSpan {
  T* p;
  I ld;
  int64_t r0;
  int n;
  __device__ __forceinline__ T& at(int rr, int c) const { return p[rr * ld + c]; }
};

// What the blocks of a GETF2 grid of G blocks over nb columns publish, in
// device memory, double-buffered by the parity of the column c whose pivot
// search it carries: each block's first largest |a[i, c]| over its rows
// i >= c (pval, pidx; pidx m where it has none) and a copy of that row
// (cand), and row c as it stands before the interchange (rowj, by its
// owner).
template <typename T>
struct Pub {
  int64_t* pidx;  // [2][G]
  T* pval;        // [2][G]
  T* rowj;        // [2][nb]
  T* cand;        // [2][G][nb]
  __host__ __device__ static size_t bytes(int64_t G, int64_t nb) {
    return 16 * G + (2 * G + 2 * nb + 2 * G * nb) * sizeof(T);
  }
  __device__ Pub(unsigned char* ws, int G, int nb)
      : pidx(reinterpret_cast<int64_t*>(ws)),
        pval(reinterpret_cast<T*>(ws + 16 * static_cast<size_t>(G))),
        rowj(pval + 2 * G),
        cand(rowj + 2 * nb) {}
};

// The best (v, i) of the warp in every lane.  `better` is a total order on
// the pairs the kernels rank (no NaN, distinct rows), so the butterfly gives
// what a scan in any order gives.
template <typename T>
__device__ __forceinline__ void warp_best(T& v, int64_t& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int64_t oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The block publishes column c's search: lane 0 of each warp holds its
// warp's best (bv, bi); the block's best row is copied out and the owner
// of row c copies it.  The grid barrier that follows makes it visible.
// (Warp 0 alone reducing and copying, the other warps idle, measured
// slower.)
template <typename T, typename I>
__device__ __forceinline__ void getf2_publish(const RowSpan<T, I>& A, int64_t m, int nb, int c,
                                              const Pub<T>& pub, T* wv, int64_t* wi, T bv,
                                              int64_t bi) {
  const int G = gridDim.x, tid = threadIdx.x;
  if ((tid & 31) == 0) {
    wv[tid >> 5] = bv;
    wi[tid >> 5] = bi;
  }
  __syncthreads();
  T v = T(-1);
  int64_t i = m;
  for (int w = 0; w < GETF2_WARPS; ++w)
    if (better(wv[w], wi[w], v, i)) {
      v = wv[w];
      i = wi[w];
    }
  const int slot = c & 1;
  if (i < m) {
    T* dst = pub.cand + (static_cast<size_t>(slot) * G + blockIdx.x) * nb;
    const int rr = static_cast<int>(i - A.r0);
    for (int cc = tid; cc < nb; cc += GETF2_THREADS) dst[cc] = A.at(rr, cc);
  }
  if (c >= A.r0 && c < A.r0 + A.n) {
    const int rr = static_cast<int>(c - A.r0);
    for (int cc = tid; cc < nb; cc += GETF2_THREADS) pub.rowj[slot * nb + cc] = A.at(rr, cc);
  }
  if (tid == 0) {
    pub.pval[slot * G + blockIdx.x] = v;
    pub.pidx[slot * G + blockIdx.x] = i;
  }
}

// Column j's pivot, the same in every block: after a grid barrier (every
// block has published column j; the slot of j's parity holds it, and no
// block publishes column j + 2 into it before the next barrier), warp 0
// reduces the G maxima (lane l takes blocks l, l+32, ... in turn, then a
// butterfly), leaves the row in *sp (j where the column has no candidate,
// all NaN) and copies the pivot row as it stands before the interchange
// into urow: one read of it from L2 a block.
template <typename T>
__device__ __forceinline__ int64_t getf2_pivot(const Pub<T>& pub, int j, int64_t m, int nb,
                                               int64_t* sp, T* urow) {
  cg::this_grid().sync();
  if (threadIdx.x < 32) {
    const int G = gridDim.x, lane = threadIdx.x, slot = j & 1;
    T gv[GETF2_MAX_BLOCKS / 32];
    int64_t gi[GETF2_MAX_BLOCKS / 32];
#pragma unroll
    for (int k = 0; k < GETF2_MAX_BLOCKS / 32; ++k) {
      const int g = lane + 32 * k;
      gv[k] = g < G ? __ldcg(pub.pval + slot * G + g) : T(-1);
      gi[k] = g < G ? __ldcg(pub.pidx + slot * G + g) : m;
    }
    T v = T(-1);
    int64_t i = m;
#pragma unroll
    for (int k = 0; k < GETF2_MAX_BLOCKS / 32; ++k)
      if (gi[k] < m && better(gv[k], gi[k], v, i)) {
        v = gv[k];
        i = gi[k];
      }
    warp_best(v, i);
    const int64_t p = i < m ? i : j;
    const int64_t chunk = (m + G - 1) / G;  // as owned_rows
    const T* prow = p == j ? pub.rowj + slot * nb
                           : pub.cand + (slot * static_cast<size_t>(G) + p / chunk) * nb;
    for (int c = lane; c < nb; c += 32) urow[c] = __ldcg(prow + c);
    if (lane == 0) *sp = p;
  }
  __syncthreads();
  return *sp;
}

// Factor the m x nb panel whose rows the blocks of the grid own (owned_rows)
// in place; piv[j] gets the panel-relative pivot of column j.  Every block
// calls it with its rows A; `scratch` holds getf2_scratch<T>(nb) bytes of
// shared memory.  Each column j is one grid barrier:
//   * the pivot p and its row (getf2_pivot), read once a block from the
//     winner's published copy (row j's own copy where p = j) in L2;
//   * rows j and p interchanged where the block owns them, row p by the
//     warp that updates it;
//   * a warp a row at a time (rows rr = warp mod GETF2_WARPS), lanes over
//     columns: the multiplier div_rn(a[i, j], pivot), then
//     a[i, c] = sub_rn(a[i, c], mul_rn(l, u[c])) for c > j, each product
//     and difference rounded once (no FMA), as lu_unblocked does; the lane
//     of column j + 1 keeps its warp's first largest |a[i, j + 1]|;
//   * the block publishes column j + 1 (getf2_publish).
// No atomics take part in any reduction, and the order of every sum and
// comparison is fixed, so the result is the same on every run and bitwise
// lu_unblocked's, pivots included.
template <typename T, typename I>
__device__ void getf2_rows(const RowSpan<T, I>& A, int64_t m, int nb, int32_t* piv,
                           const Pub<T>& pub, unsigned char* scratch) {
  T* wv = reinterpret_cast<T*>(scratch);
  int64_t* wi = reinterpret_cast<int64_t*>(scratch + 8 * GETF2_WARPS);
  int64_t* sp = wi + GETF2_WARPS;
  T* urow = reinterpret_cast<T*>(scratch + 256);  // the pivot row
  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  const int steps = static_cast<int>(m < nb ? m : nb);

  // column 0's search
  T bv = T(-1);
  int64_t bi = m;
  for (int rr = tid; rr < A.n; rr += GETF2_THREADS) {
    const T v = fabs(A.at(rr, 0));
    if (better(v, A.r0 + rr, bv, bi)) {
      bv = v;
      bi = A.r0 + rr;
    }
  }
  warp_best(bv, bi);
  getf2_publish(A, m, nb, 0, pub, wv, wi, bv, bi);

  for (int j = 0; j < steps; ++j) {
    const int64_t p = getf2_pivot(pub, j, m, nb, sp, urow);
    const T* jrow = pub.rowj + (j & 1) * nb;  // row j before the interchange
    if (blockIdx.x == 0 && tid == 0) piv[j] = static_cast<int32_t>(p);
    const T pivot = urow[j];
    const int64_t jl = j - A.r0, pl = p - A.r0;
    if (p != j) {
      if (jl >= 0 && jl < A.n && static_cast<int>(jl) % GETF2_WARPS == q)
        for (int c = lane; c < nb; c += 32) A.at(static_cast<int>(jl), c) = urow[c];
      if (pl >= 0 && pl < A.n && static_cast<int>(pl) % GETF2_WARPS == q) {
        for (int c = lane; c < nb; c += 32) A.at(static_cast<int>(pl), c) = __ldcg(jrow + c);
        __syncwarp();
      }
    }
    // the warp's rows below j: rr = q (mod GETF2_WARPS), rr >= lo
    const int64_t lo64 = j + 1 - A.r0;
    const int lo = static_cast<int>(lo64 < 0 ? 0 : (lo64 > A.n ? A.n : lo64));
    const int first = q + (lo > q ? (lo - q + GETF2_WARPS - 1) / GETF2_WARPS : 0) * GETF2_WARPS;
    for (int rr = first + lane * GETF2_WARPS; rr < A.n; rr += 32 * GETF2_WARPS)
      A.at(rr, j) = div_rn(A.at(rr, j), pivot);
    __syncwarp();
    bv = T(-1);
    bi = m;
    for (int c0 = j + 1; c0 < nb; c0 += 32 * GETF2_COLS) {
      T u[GETF2_COLS];
      int cs[GETF2_COLS];
#pragma unroll
      for (int uu = 0; uu < GETF2_COLS; ++uu) {
        const int c = c0 + lane + 32 * uu;
        cs[uu] = c < nb ? c : nb - 1;  // columns past nb read column nb - 1, never stored
        u[uu] = urow[cs[uu]];
      }
      const bool search = c0 == j + 1 && lane == 0;  // this lane holds column j + 1
      int rr = first;
      for (; rr + GETF2_WARPS < A.n; rr += 2 * GETF2_WARPS) {  // two rows at once
        const int r2 = rr + GETF2_WARPS;
        const T l1 = A.at(rr, j), l2 = A.at(r2, j);
        T x1[GETF2_COLS], x2[GETF2_COLS];
#pragma unroll
        for (int uu = 0; uu < GETF2_COLS; ++uu) {
          x1[uu] = A.at(rr, cs[uu]);
          x2[uu] = A.at(r2, cs[uu]);
        }
#pragma unroll
        for (int uu = 0; uu < GETF2_COLS; ++uu) {
          x1[uu] = sub_rn(x1[uu], mul_rn(l1, u[uu]));
          x2[uu] = sub_rn(x2[uu], mul_rn(l2, u[uu]));
          if (c0 + lane + 32 * uu < nb) {
            A.at(rr, cs[uu]) = x1[uu];
            A.at(r2, cs[uu]) = x2[uu];
          }
        }
        if (search) {
          const T v1 = fabs(x1[0]), v2 = fabs(x2[0]);
          if (better(v1, A.r0 + rr, bv, bi)) {
            bv = v1;
            bi = A.r0 + rr;
          }
          if (better(v2, A.r0 + r2, bv, bi)) {
            bv = v2;
            bi = A.r0 + r2;
          }
        }
      }
      if (rr < A.n) {
        const T l1 = A.at(rr, j);
        T x1[GETF2_COLS];
#pragma unroll
        for (int uu = 0; uu < GETF2_COLS; ++uu) x1[uu] = A.at(rr, cs[uu]);
#pragma unroll
        for (int uu = 0; uu < GETF2_COLS; ++uu) {
          x1[uu] = sub_rn(x1[uu], mul_rn(l1, u[uu]));
          if (c0 + lane + 32 * uu < nb) A.at(rr, cs[uu]) = x1[uu];
        }
        if (search && better(fabs(x1[0]), A.r0 + rr, bv, bi)) {
          bv = fabs(x1[0]);
          bi = A.r0 + rr;
        }
      }
    }
    if (j + 1 < steps) getf2_publish(A, m, nb, j + 1, pub, wv, wi, bv, bi);
  }
  __syncthreads();
}

// The block's rows between device memory (a + r0 * lda) and the residency
// (ld nb), a warp a row, lanes over columns.
template <typename T, bool IN>
__device__ __forceinline__ void move_rows(T* res, T* a, int64_t lda, int n, int nb) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  for (int rr = q; rr < n; rr += GETF2_WARPS)
    for (int c = lane; c < nb; c += 32) {
      if (IN) res[rr * nb + c] = a[rr * lda + c];
      else a[rr * lda + c] = res[rr * nb + c];
    }
}
