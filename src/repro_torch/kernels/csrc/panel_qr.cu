// Householder QR panel (GEQR2 + LARFT) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_qr.py::qr_panel, whose body is
// repro/core/qr.py::qr_unblocked + build_t_matrix: factor an m x nb panel in
// place into R and the Householder vectors below the diagonal, and return
// tau and the compact-WY T with H_1...H_nb = I - V*T*V^T.  A second entry,
// larft, runs only the LARFT part on an explicit (unpacked) V, for the
// solve's Q^T apply, form_q and the qrcp_local panels.
//
// What bounds it on an H100: the panel is a chain of nb dependent columns.
// Each needs a reduction over all m rows (the column norm and
// v^T A[:, j+1:]) before its rank-1 update can start: about 2*m*nb^2 flops
// over 2*m*nb elements, a few flops per byte, and every column waits for
// the one before.  So it is bound by latency (a grid-wide barrier a column
// and the cross-block sums after it), not by bytes or flops.
//
// Design: a cooperative grid of G blocks of QR_THREADS threads, at most one
// block an SM (G = min(ceil(m / 32), SMs)).  The rows come in chunks of 32,
// dealt round-robin: block b owns chunks b, b + G, b + 2G, ... (Dealt in
// dense.cuh), so a row's block and its place among that block's rows
// depend on the row alone at every height, and a panel padded with zero
// rows (a bucketed system, serve/bucketing.py) sums the same partials in
// the same blocks and adds only zero terms and zero partials after them;
// every other sum below is fixed by the index of its terms, not by nb, so
// padded columns change nothing either, and the padded panel's real part
// is bitwise the raw panel's.
//   * Rows resident: where a block's rows fit shared memory (about 208 rows
//     of nb = 128 in f64, so m up to about 27000 on 132 SMs) the block loads
//     them once, factors all nb columns there and writes them back once.
//     Otherwise the same code runs on the rows in device memory (the
//     streamed route); the plan picks the route by shape.
//   * Column j is two short grid barriers.  Before the first, each block
//     has published, for c = j, its partial s_i = sum_{r > c} A[r, c] *
//     A[r, i] for i >= c (s_c is its part of |x|^2 below the diagonal), and
//     the owner of row c that row.  Then every block sums column c's
//     partials itself (one warp: the same bits everywhere), forms alpha =
//     A[c, c], |x|^2 = alpha^2 + s_c, beta, tau and denom = alpha - beta,
//     sums the partials of its share of the columns i > c (one column a
//     block when G >= nb) and publishes w_i = tau * (A[c, i] + s_i /
//     denom): the identity v^T A = A[c, :] + x^T A / denom over the rows
//     below c, so v need not be scaled before the sums.  After the second
//     barrier every block reads w and runs the column pass.  A first
//     design with one barrier, every block summing every column's G
//     partials, was slower on an H100: 132 blocks each reading the 132
//     partials of up to 127 columns from L2 cost more than a second
//     barrier (PERF.md, section 6).
//   * A column pass: each warp owns the rows rr = warp (mod QR_WARPS) of
//     the chunk.  First its lanes take one row each: v = x / denom (row j
//     keeps its implicit 1 and takes beta) and the update of column c =
//     j + 1.  Then its lanes take PASS_COLS columns each (consecutive
//     lanes on consecutive columns, so shared memory is read without bank
//     conflicts) and walk the warp's rows: the update of columns > c and
//     the partial s_i of the next column in one FMA chain a column; the
//     warps' partials are added in warp order.  Indices inside the block
//     are 32-bit where its rows are resident.
//   * Cross-block sums by a warp: lane l takes blocks l, l+32, ... in turn,
//     then a butterfly of shuffles.
//   * LARFT in the same launch and residency: each block forms its partial
//     Gram V^T V from the rows it holds (a warp a tile of 8 x 128 entries,
//     rows in turn), a warp a pair sums the G partials, and the rows of T
//     are spread over the blocks, a warp a row: T[i, l] for ascending l
//     from the running sums in the lanes (the note at larft_finish), with
//     the Gram in shared memory.  The larft entry runs the same routines on
//     an explicit V over the same grid and rows, so its T is bitwise the
//     panel's for the same V.  (Block 0 alone running the column recurrence,
//     a column at a time, was most of LARFT's time.)
//
// Rounding: the longest chain of terms one element sums in turn is the Gram
// entry's rows of a block, then ceil(G/32) block partials and five shuffle steps,
// then up to nb - 1 terms of the recurrence; GEQR2's sums are shorter
// (ceil(chunk/QR_WARPS) + QR_WARPS, then the same cross-block sum).
// kernels/panel_qr.py's plan() returns that count.
//
// Determinism: every cross-block reduction goes through per-block partials
// in device memory, summed in a fixed order; no floating-point atomics.  The
// same input gives the same bits on every run, which keeps la, la2 and rtm
// bitwise equal to mtb.  The kernel is not bitwise equal to its plain
// version (the reductions group differently); it is held to it within a
// relative bound.
#include <type_traits>

#include "dense.cuh"

constexpr int QR_THREADS = 512, QR_WARPS = QR_THREADS / 32;
constexpr int QR_MAX_BLOCKS = PANEL_MAX_BLOCKS;  // so a lane sums at most 8 block partials
constexpr int T_GROUP = 256;         // columns of a row of T a warp holds at once
constexpr int ROW_SLOTS = T_GROUP / 32;
constexpr int GRAM_ROWS = 8;         // a warp's Gram tile: 8 rows by 128 columns
constexpr int PASS_COLS = 4;         // columns a lane updates at once
constexpr int PASS_ROWS = 4;         // rows a warp loads at once

// The workspace of a launch of G blocks (elements of T): the partials s of
// column c ([nb][G]), row c ([nb]), w ([nb]), the Gram partials ([G][P],
// P = nb*(nb-1)/2 pairs) and the Gram (row-major nb x nb, the strict upper
// part written).
template <typename T>
struct Workspace {
  T *ps, *prow, *pw, *pgram, *gram;
  __host__ __device__ static int64_t elems(int64_t nb, int64_t G) {
    return nb * G + 2 * nb + G * (nb * (nb - 1) / 2) + nb * nb;
  }
  __device__ Workspace(T* ws, int64_t nb, int64_t G)
      : ps(ws), prow(ws + nb * G), pw(prow + nb), pgram(pw + nb),
        gram(pgram + nb * (nb - 1) / 2 * G) {}
};

// Shared memory a block needs besides its rows: s, row c and w ([nb] each)
// and the warps' partials ([QR_WARPS][nb]).
template <typename T>
__host__ __device__ constexpr size_t qr_extras(int64_t nb) {
  return static_cast<size_t>(3 + QR_WARPS) * nb * sizeof(T);
}

// ... and the Gram in shared memory for the LARFT recurrence.
template <typename T>
__host__ __device__ constexpr size_t qr_recurrence_smem(int64_t nb) {
  return qr_extras<T>(nb) + static_cast<size_t>(nb * nb) * sizeof(T);
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// A block's rows (dense.cuh): shared memory (L) or the panel itself.
template <typename T, typename I, bool L>
using Rows = DealtRows<T, I, L>;

// The reflector of column j, the same in every block.
template <typename T>
struct Reflector {
  T tau, denom, diag;  // diag: the new A[j, j]
};

// Every block, column c: warp 0 sums column c's partials (|x|^2 below the
// diagonal) and reads row c, which give the reflector; the other warps sum
// the block's share of the columns i > c (i - c - 1 = block, modulo G), and
// the block publishes their w_i = tau * (A[c, i] + s_i / denom) into pw.
template <typename T>
__device__ __forceinline__ Reflector<T> reflector(int nb, int G, int c, const T* ps,
                                                  const T* prow, T* pw, T* sv, T* rv) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int first = c + 1 + blockIdx.x;
  for (int i = q == 0 ? c : first + (q - 1) * G; i < nb;
       i += q == 0 ? nb : (QR_WARPS - 1) * G) {
    const T s = warp_sum(lane_partials(ps + static_cast<int64_t>(i) * G, 1, G, lane));
    if (lane == 0) {
      sv[i] = s;
      rv[i] = __ldcg(prow + i);
    }
  }
  __syncthreads();
  // beta = -sign(alpha)*|x|, sign(0) = +1; a zero column gives tau = 0, H = I
  const T alpha = rv[c];
  const T xnorm = sqrt_rn(fma(alpha, alpha, sv[c]));
  const bool safe = xnorm > T(0);
  const T beta = alpha >= T(0) ? -xnorm : xnorm;
  Reflector<T> rf;
  rf.tau = safe ? div_rn(beta - alpha, beta) : T(0);
  rf.denom = safe ? alpha - beta : T(1);
  rf.diag = safe ? beta : alpha;
  for (int i = first + static_cast<int>(threadIdx.x) * G; i < nb; i += QR_THREADS * G)
    pw[i] = rf.tau * (rv[i] + div_rn(sv[i], rf.denom));
  return rf;
}

// One pass over the block's rows: reflector j applied to them (j >= 0;
// rows >= j, columns > j), then, while c = j + 1 < steps, the partials of
// column c (s_i into ps[i][blk], i >= c) and row c into prow by its owner.
template <typename T, typename I, bool L>
__device__ __forceinline__ void column_pass(const Rows<T, I, L>& A, int nb, int steps, int j, int G,
                                            const Reflector<T>& rf, const T* wv, T* red, T* ps,
                                            T* prow) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int c = j + 1;
  const bool apply = j >= 0, part = c < steps;
  // rows j and c as local rows (-1 where another block owns them); the
  // warp's rows are rr = q (mod QR_WARPS), from its first row >= lo, the
  // block's first row at or below row j
  const int n = A.D.n;
  const int jl = A.D.local(j), cl = A.D.local(c);
  const int lo = A.D.lower(j), after = A.D.lower(c + 1);
  const int first = q + (lo > q ? (lo - q + QR_WARPS - 1) / QR_WARPS : 0) * QR_WARPS;
  if (apply) {  // column j becomes v (row j: beta), then column c takes its update
    for (int rr = first + lane * QR_WARPS; rr < n; rr += 32 * QR_WARPS) {
      T v;
      if (rr == jl) {
        v = T(1);
        A.at(rr, j) = rf.diag;
      } else {
        v = div_rn(A.at(rr, j), rf.denom);
        A.at(rr, j) = v;
      }
      if (c < nb) A.at(rr, c) = fma(-v, wv[c], A.at(rr, c));
    }
    __syncwarp();
  }
  // the warp's first row below c: rows j and c (at most two) come before it
  const int below = q + (after > q ? (after - q + QR_WARPS - 1) / QR_WARPS : 0) * QR_WARPS;
  for (int i0 = (part ? c : c + 1) + lane; i0 < nb; i0 += 32 * PASS_COLS) {
    T s[PASS_COLS], wi[PASS_COLS];
    bool upd[PASS_COLS];
#pragma unroll
    for (int u = 0; u < PASS_COLS; ++u) {
      const int i = i0 + 32 * u;
      s[u] = T(0);
      upd[u] = apply && i > c && i < nb;
      wi[u] = upd[u] ? wv[i] : T(0);
    }
    for (int rr = first; rr < min(below, n); rr += QR_WARPS) {  // rows j, c
      const T v = !apply ? T(0) : (rr == jl ? T(1) : A.at(rr, j));
#pragma unroll
      for (int u = 0; u < PASS_COLS; ++u) {
        const int i = i0 + 32 * u;
        if (i >= nb) continue;
        T x = A.at(rr, i);
        if (upd[u]) {
          x = fma(-v, wi[u], x);
          A.at(rr, i) = x;
        }
        if (part && rr == cl) prow[i] = x;
      }
    }
    // the rows below c, PASS_ROWS at a time, all loaded before any store
    // (whole chunks an iteration: row g's offset moves on by a fixed
    // stride, and rows past the block's last read the last one)
    static_assert(QR_WARPS * PASS_ROWS % DEAL_ROWS == 0, "whole chunks an iteration");
    const I last = A.off(n - 1), stride = A.advance(QR_WARPS * PASS_ROWS);
    I ro[PASS_ROWS];
#pragma unroll
    for (int g = 0; g < PASS_ROWS; ++g) ro[g] = A.off(below + g * QR_WARPS);
    for (int rr0 = below; rr0 < n; rr0 += QR_WARPS * PASS_ROWS) {
      T v[PASS_ROWS], ac[PASS_ROWS], x[PASS_ROWS][PASS_COLS];
#pragma unroll
      for (int g = 0; g < PASS_ROWS; ++g) {
        const T* row = A.p + (ro[g] < last ? ro[g] : last);
        v[g] = apply ? row[j] : T(0);
        ac[g] = part ? row[c] : T(0);
#pragma unroll
        for (int u = 0; u < PASS_COLS; ++u) x[g][u] = row[min(i0 + 32 * u, nb - 1)];
      }
#pragma unroll
      for (int g = 0; g < PASS_ROWS; ++g) {
        const int rr = rr0 + g * QR_WARPS;
        if (rr >= n) break;
#pragma unroll
        for (int u = 0; u < PASS_COLS; ++u) {
          if (upd[u]) {
            x[g][u] = fma(-v[g], wi[u], x[g][u]);
            A.p[ro[g] + i0 + 32 * u] = x[g][u];
          }
          if (part) s[u] = fma(ac[g], x[g][u], s[u]);
        }
      }
#pragma unroll
      for (int g = 0; g < PASS_ROWS; ++g) ro[g] += stride;
    }
    if (part)
#pragma unroll
      for (int u = 0; u < PASS_COLS; ++u)
        if (i0 + 32 * u < nb) red[q * nb + i0 + 32 * u] = s[u];
  }
  if (!part) return;
  __syncthreads();
  for (int i = c + threadIdx.x; i < nb; i += QR_THREADS) {
    T s = red[i];
    for (int w = 1; w < QR_WARPS; ++w) s += red[w * nb + i];
    ps[static_cast<int64_t>(i) * G + blockIdx.x] = s;
  }
}

// V[r, col] from the rows: as stored (an unpacked V), or from a packed
// panel (unit diagonal, zero above it); zero past nb.
template <typename T, bool PACKED, typename I, bool L>
__device__ __forceinline__ T v_at(const Rows<T, I, L>& A, int rr, int col, int nb) {
  if (col >= nb) return T(0);
  if (!PACKED) return A.at(rr, col);
  const int64_t r = A.D.row(rr);
  return r > col ? A.at(rr, col) : (r == col ? T(1) : T(0));
}

// The block's partial Gram over its rows, in turn: pgram[blk][p] for the
// pairs i < j, p = j*(j-1)/2 + i.  A warp a tile of GRAM_ROWS rows i by 128
// columns j (j = lane + 32*x): the tile's rows of V are read by every lane
// alike and its columns by consecutive lanes, so shared memory serves both
// without bank conflicts.
template <typename T, bool PACKED, typename I, bool L>
__device__ __forceinline__ void gram_partial(const Rows<T, I, L>& A, int nb, T* pgram) {
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int64_t P = static_cast<int64_t>(nb) * (nb - 1) / 2;
  T* out = pgram + blockIdx.x * P;
  const int tj = (nb + 127) / 128, tiles = (nb + GRAM_ROWS - 1) / GRAM_ROWS * tj;
  for (int tile = q; tile < tiles; tile += QR_WARPS) {
    const int i0 = tile / tj * GRAM_ROWS, jt = tile % tj * 128;
    if (i0 >= jt + 127) continue;  // no pair i < j in the tile
    const int j0 = jt + lane;
    T acc[GRAM_ROWS][4];
#pragma unroll
    for (int u = 0; u < GRAM_ROWS; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[u][x] = T(0);
    // a packed panel's rows r < nb hold R above the diagonal: V by v_at
    const int head = PACKED ? A.D.lower(nb) : 0;
    for (int rr = 0; rr < head; ++rr) {
      T va[GRAM_ROWS], vb[4];
#pragma unroll
      for (int u = 0; u < GRAM_ROWS; ++u) va[u] = v_at<T, PACKED>(A, rr, i0 + u, nb);
#pragma unroll
      for (int x = 0; x < 4; ++x) vb[x] = v_at<T, PACKED>(A, rr, j0 + 32 * x, nb);
#pragma unroll
      for (int u = 0; u < GRAM_ROWS; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[u][x] = fma(va[u], vb[x], acc[u][x]);
    }
    // the other rows as stored; columns past nb read column nb - 1, and
    // their products are never written
    int ci[GRAM_ROWS], cj[4];
#pragma unroll
    for (int u = 0; u < GRAM_ROWS; ++u) ci[u] = min(i0 + u, nb - 1);
#pragma unroll
    for (int x = 0; x < 4; ++x) cj[x] = min(j0 + 32 * x, nb - 1);
    for (int rr = head; rr < A.D.n; ++rr) {
      T va[GRAM_ROWS], vb[4];
#pragma unroll
      for (int u = 0; u < GRAM_ROWS; ++u) va[u] = A.at(rr, ci[u]);
#pragma unroll
      for (int x = 0; x < 4; ++x) vb[x] = A.at(rr, cj[x]);
#pragma unroll
      for (int u = 0; u < GRAM_ROWS; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[u][x] = fma(va[u], vb[x], acc[u][x]);
    }
#pragma unroll
    for (int u = 0; u < GRAM_ROWS; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + u, j = j0 + 32 * x;
        if (i < j && j < nb) out[static_cast<int64_t>(j) * (j - 1) / 2 + i] = acc[u][x];
      }
  }
}

// After every block's gram_partial: the Gram summed over the blocks (a warp
// a pair), then T (row-major, nb x nb, written whole), a warp a row, the
// rows spread over the blocks.  The rows of T are independent: lane
// holds the running sums of T[i, j] for its columns j = lane + 32*k, and
// as T[i, l] becomes final (l ascending: tau_i at l = i, else -tau_l times
// its sum) it is broadcast and every column j > l takes the term
// T[i, l] * Gram[l, j].  Each sum so takes its terms in ascending l, one
// chain, as the column recurrence T[:j, j] = -tau_j * T[:j, :j] * Gram[:j, j]
// would.  A warp holds T_GROUP columns of the row at once; a wider panel's
// later groups first take the terms of the row's final T[i, l] of the
// earlier groups (read back from t), so the order is the same.  The Gram is
// read from the shared memory at `tail` where the launch gave
// qr_recurrence_smem(nb) bytes, else from the workspace.
template <typename T>
__device__ __forceinline__ void larft_finish(int nb, const T* tau, T* t, const Workspace<T>& ws, T* tail) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int64_t P = static_cast<int64_t>(nb) * (nb - 1) / 2;
  grid.sync();
  for (int e = blockIdx.x * QR_WARPS + q; e < nb * nb; e += G * QR_WARPS) {
    const int l = e / nb, j = e % nb;
    if (l >= j) continue;
    const T s = warp_sum(
        lane_partials(ws.pgram + static_cast<int64_t>(j) * (j - 1) / 2 + l, P, G, lane));
    if (lane == 0) ws.gram[e] = s;
  }
  grid.sync();
  if (static_cast<int>(blockIdx.x) >= nb) return;  // no row of T here
  const T* gram = ws.gram;
  if (dynamic_smem_bytes() >= qr_recurrence_smem<T>(nb)) {
    // rows l >= blockIdx.x, the ones this block's rows of T read
    for (int e = blockIdx.x * nb + threadIdx.x; e < nb * nb; e += QR_THREADS)
      tail[e] = __ldcg(ws.gram + e);
    gram = tail;
    __syncthreads();
  }
  for (int i = blockIdx.x + G * q; i < nb; i += G * QR_WARPS) {
    T* ti = t + static_cast<int64_t>(i) * nb;
    for (int j0 = 0; j0 < nb; j0 += T_GROUP) {  // T[i, j0 + 32*k + lane]
      T acc[ROW_SLOTS], tv[ROW_SLOTS], tl[ROW_SLOTS];
#pragma unroll
      for (int k = 0; k < ROW_SLOTS; ++k) {
        const int j = j0 + 32 * k + lane;
        acc[k] = T(0);
        tv[k] = T(0);
        tl[k] = j < nb ? __ldcg(tau + j) : T(0);
      }
      for (int l = i; l < j0; ++l) {  // the earlier groups' final T[i, l]
        const T til = ti[l];
        const T* gl = gram + static_cast<int64_t>(l) * nb;
#pragma unroll
        for (int kk = 0; kk < ROW_SLOTS; ++kk) {
          const int j = j0 + 32 * kk + lane;
          if (j < nb) acc[kk] = fma(til, gl[j], acc[kk]);
        }
      }
#pragma unroll
      for (int k = 0; k < ROW_SLOTS; ++k) {
        for (int l32 = 0; l32 < 32; ++l32) {
          const int l = j0 + 32 * k + l32;
          if (l >= nb) break;
          if (l < i) continue;
          const T mine = l == i ? tl[k] : -tl[k] * acc[k];  // lane l32's is T[i, l]
          const T til = __shfl_sync(0xffffffffu, mine, l32);
          if (lane == l32) tv[k] = til;
          const T* gl = gram + static_cast<int64_t>(l) * nb;
#pragma unroll
          for (int kk = k; kk < ROW_SLOTS; ++kk) {
            const int j = j0 + 32 * kk + lane;
            if (j > l && j < nb) acc[kk] = fma(til, gl[j], acc[kk]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < ROW_SLOTS; ++k) {
        const int j = j0 + 32 * k + lane;
        if (j < nb) ti[j] = j >= i ? tv[k] : T(0);
      }
      __syncwarp();  // the next group reads this one's T[i, l] back
    }
  }
}

// GEQR2 + LARFT (the note at the top says how).  RESIDENT: the block's rows
// live in shared memory after qr_extras(nb) bytes.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(QR_THREADS, 1)
qr_panel_kernel(int64_t m, int64_t nb64, T* a, int64_t lda, T* tau, T* t, T* wsp) {
  using I = std::conditional_t<RESIDENT, int, int64_t>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, nb = static_cast<int>(nb64);
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const Dealt D(m, G, blockIdx.x);
  T* sv = reinterpret_cast<T*>(smem_raw);
  T* rv = sv + nb;
  T* wv = rv + nb;
  T* red = wv + nb;
  const Rows<T, I, RESIDENT> A{RESIDENT ? red + QR_WARPS * nb : a,
                               RESIDENT ? static_cast<I>(nb) : static_cast<I>(lda), D};
  const Workspace<T> ws(wsp, nb, G);
  if (RESIDENT) {
    for (int rr = q; rr < D.n; rr += QR_WARPS)
      for (int c = lane; c < nb; c += 32) A.at(rr, c) = a[D.row(rr) * lda + c];
    __syncthreads();
  }
  const int steps = static_cast<int>(min(m, nb64));
  column_pass(A, nb, steps, -1, G, Reflector<T>{}, wv, red, ws.ps, ws.prow);
  grid.sync();
  for (int j = 0; j < steps; ++j) {
    const Reflector<T> rf = reflector(nb, G, j, ws.ps, ws.prow, ws.pw, sv, rv);
    if (blockIdx.x == 0 && threadIdx.x == 0) tau[j] = rf.tau;
    grid.sync();
    for (int i = j + 1 + threadIdx.x; i < nb; i += QR_THREADS) wv[i] = __ldcg(ws.pw + i);
    __syncthreads();
    column_pass(A, nb, steps, j, G, rf, wv, red, ws.ps, ws.prow);
    if (j + 1 < steps) grid.sync();
  }
  if (blockIdx.x == 0)
    for (int i = steps + threadIdx.x; i < nb; i += QR_THREADS) tau[i] = T(0);
  __syncthreads();
  gram_partial<T, true>(A, nb, ws.pgram);
  if (RESIDENT)
    for (int rr = q; rr < D.n; rr += QR_WARPS)
      for (int c = lane; c < nb; c += 32) a[D.row(rr) * lda + c] = A.at(rr, c);
  __syncthreads();
  larft_finish(nb, tau, t, ws, red + QR_WARPS * nb);
}

// LARFT alone.  The block's rows of V are loaded into shared memory first
// where the launch gave room for them (the Gram reuses that room later);
// either way the partial Gram takes the same terms in the same order.
template <typename T>
__global__ void __launch_bounds__(QR_THREADS, 1)
larft_kernel(int64_t m, int64_t nb64, const T* v, int64_t ldv, const T* tau, T* t, T* wsp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = gridDim.x, nb = static_cast<int>(nb64);
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const Dealt D(m, G, blockIdx.x);
  const int n = D.n;
  const Workspace<T> ws(wsp, nb, G);
  T* tail = reinterpret_cast<T*>(smem_raw) + (3 + QR_WARPS) * nb;  // after qr_extras(nb)
  if (dynamic_smem_bytes() >= qr_extras<T>(nb) + static_cast<size_t>(n) * nb * sizeof(T)) {
    for (int rr = q; rr < n; rr += QR_WARPS)
      for (int c = lane; c < nb; c += 32) tail[rr * nb + c] = v[D.row(rr) * ldv + c];
    __syncthreads();
    gram_partial<T, false>(Rows<T, int, true>{tail, nb, D}, nb, ws.pgram);
    __syncthreads();
  } else {
    gram_partial<T, false>(Rows<T, int64_t, false>{const_cast<T*>(v), ldv, D}, nb, ws.pgram);
  }
  larft_finish(nb, tau, t, ws, tail);
}

// How an m x nb panel runs: out = {blocks, resident (1) or streamed (0),
// rows a dealt chunk (32), dynamic shared memory bytes of the panel kernel
// and of the larft kernel, workspace elements, threads a block, the widest
// nb whose shared memory fits, rows a block at most}.  The larft entry
// takes the same blocks and rows.
template <typename T>
static cudaError_t qr_plan(int64_t m, int64_t nb, int64_t* out) {
  if (m <= 0 || nb <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(optin), extras = qr_extras<T>(nb);
  out[7] = static_cast<int64_t>(limit / qr_extras<T>(1));  // widest panel
  if (extras > limit) return cudaErrorInvalidValue;
  const int64_t cap = sms < QR_MAX_BLOCKS ? sms : QR_MAX_BLOCKS;
  const int64_t g = dealt_grid(m, cap), rows = dealt_max_rows(m, g);
  // the Gram in shared memory for the recurrence where it fits, and the
  // larft kernel's rows of V where they fit too
  const size_t recur = qr_recurrence_smem<T>(nb) <= limit ? qr_recurrence_smem<T>(nb) : extras;
  const size_t whole = extras + static_cast<size_t>(rows * nb) * sizeof(T);
  const size_t larft = whole > recur && whole <= limit ? whole : recur;
  int per_sm = 0;
  size_t smem = whole > recur ? whole : recur;
  bool resident = whole <= limit;
  if (resident) {
    err = allow_smem(qr_panel_kernel<T, true>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_panel_kernel<T, true>,
                                                          QR_THREADS, smem);
    if (err != cudaSuccess) return err;
    resident = per_sm >= 1;
  }
  if (!resident) {
    smem = recur;
    err = allow_smem(qr_panel_kernel<T, false>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qr_panel_kernel<T, false>,
                                                          QR_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  out[0] = g;
  out[1] = resident ? 1 : 0;
  out[2] = DEAL_ROWS;
  out[3] = static_cast<int64_t>(smem);
  out[4] = static_cast<int64_t>(larft);
  out[5] = Workspace<T>::elems(nb, g);
  out[6] = QR_THREADS;
  out[8] = rows;
  return cudaSuccess;
}

template <typename Kernel>
static cudaError_t launch_qr_grid(Kernel kernel, int grid, size_t smem, void** args,
                                  cudaStream_t stream) {
  if (grid < 1 || grid > QR_MAX_BLOCKS) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(QR_THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_qr(int64_t m, int64_t nb, void* a, int64_t lda, void* tau, void* t,
                             int grid, int resident, int64_t smem, void* ws,
                             cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  T* ap = static_cast<T*>(a);
  T* tp = static_cast<T*>(tau);
  T* tt = static_cast<T*>(t);
  T* wp = static_cast<T*>(ws);
  void* args[] = {&m, &nb, &ap, &lda, &tp, &tt, &wp};
  return resident ? launch_qr_grid(qr_panel_kernel<T, true>, grid, smem, args, stream)
                  : launch_qr_grid(qr_panel_kernel<T, false>, grid, smem, args, stream);
}

template <typename T>
static cudaError_t launch_larft(int64_t m, int64_t nb, const void* v, int64_t ldv,
                                const void* tau, void* t, int grid, int64_t smem, void* ws,
                                cudaStream_t stream) {
  if (m <= 0 || nb <= 0) return cudaSuccess;
  const T* vp = static_cast<const T*>(v);
  const T* tp = static_cast<const T*>(tau);
  T* tt = static_cast<T*>(t);
  T* wp = static_cast<T*>(ws);
  void* args[] = {&m, &nb, &vp, &ldv, &tp, &tt, &wp};
  return launch_qr_grid(larft_kernel<T>, grid, smem, args, stream);
}

extern "C" int repro_qr_panel_plan_f32(int64_t m, int64_t nb, int64_t* out) {
  return qr_plan<float>(m, nb, out);
}

extern "C" int repro_qr_panel_plan_f64(int64_t m, int64_t nb, int64_t* out) {
  return qr_plan<double>(m, nb, out);
}

extern "C" int repro_qr_panel_f32(int64_t m, int64_t nb, void* a, int64_t lda, void* tau,
                                  void* t, int grid, int resident, int64_t smem, void* ws,
                                  void* stream) {
  return launch_qr<float>(m, nb, a, lda, tau, t, grid, resident, smem, ws,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int repro_qr_panel_f64(int64_t m, int64_t nb, void* a, int64_t lda, void* tau,
                                  void* t, int grid, int resident, int64_t smem, void* ws,
                                  void* stream) {
  return launch_qr<double>(m, nb, a, lda, tau, t, grid, resident, smem, ws,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int repro_larft_f32(int64_t m, int64_t nb, const void* v, int64_t ldv,
                               const void* tau, void* t, int grid, int64_t smem, void* ws,
                               void* stream) {
  return launch_larft<float>(m, nb, v, ldv, tau, t, grid, smem, ws,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_larft_f64(int64_t m, int64_t nb, const void* v, int64_t ldv,
                               const void* tau, void* t, int grid, int64_t smem, void* ws,
                               void* stream) {
  return launch_larft<double>(m, nb, v, ldv, tau, t, grid, smem, ws,
                              static_cast<cudaStream_t>(stream));
}
