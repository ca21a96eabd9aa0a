// Hessenberg panel (xLAHR2) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_hessenberg.py::hessenberg_panel,
// whose body is repro/kernels/panels.py::_hessenberg_sweep: reduce columns
// k .. k+bk-1 of an n x n matrix A.  For panel column j (kj = k + j):
//
//   col  = A[:, kj] - W * (T * V[kj, :]^T)     right update, W = A0 * V
//   col -= V * (T^T * (V^T * col))             left compact-WY apply
//   v_j, tau_j, beta: the reflector zeroing col[kj+2:], v_j[kj+1] = 1
//   A[:, kj] = col with beta at kj+1 and v_j below it
//   T[:j, j] = -tau_j * T[:j, :j] * (V^T v_j),  T[j, j] = tau_j
//   W[:, j]  = A * v_j    (columns kj+1 .. n-1 only: v_j is zero at <= kj)
//
// The last two columns of the matrix (kj >= n-2) have no rows to reduce:
// tau_j = 0, v_j = 0, and the updated column is written back.  A is updated
// in place (only its columns k .. k+bk-1 change); V, W (n x bk), T (bk x bk)
// and tau are outputs.  k is a runtime argument, so one build serves every
// panel of a factorization.
//
// What bounds it on an H100: W[:, j] = A * v_j is a GEMV over the columns
// right of kj of every row, and column j + 1 needs it, so each column streams
// the trailing part of the matrix once.  At n = 8192 f64 the first panel
// streams about 68 GB, 20.4 ms at 3.35 TB/s, and a whole reduction about
// 2.2 TB.  The TPU kernel held the whole matrix in VMEM; 512 MiB stays in no
// on-chip memory of this card (50 MB of L2), so the per-column pass stays
// and bounds the kernel by bytes where the matrix exceeds L2.  At n = 2048
// (32 MiB, in L2) the fixed cost of a column is what remains.
//
// Design: a cooperative grid of G blocks of HP_THREADS threads, one block an
// SM (at least HP_MIN_ROWS rows a block, so n = 2048 busies all 132 SMs; the
// plan in kernels/panel_hessenberg.py sizes it).  Each block owns a
// contiguous chunk of rows.  Each block keeps, in its shared memory where
// the plan finds room (in this order), else in device memory: T (its upper
// triangle, packed; every block forms the same T), its rows of V, the
// column x below kj+1 and its rows of W.  Per column, two grid barriers:
//   1. every block forms s = T * V[kj, :]^T itself (V's row kj kept from
//      step 3 of the column before), brings its rows of the column through
//      the right update (a few lanes a row, then a butterfly) and publishes
//      its column sums of V^T col;
//   -- barrier --
//   2. every block sums u = V^T col (a warp an entry), forms z = T^T u,
//      applies the left update to its rows, writes them to a column buffer
//      and publishes its partial |x|^2 below kj and its column sums of V^T x
//      below kj+1 (the identity V^T v_j = V[kj+1, :] + V^T x / denom over
//      the rows below kj+1 folds V^T v_j into this pass);
//   -- barrier --
//   3. warp 0 of each block sums the norm and reads alpha (the reflector,
//      shared through shared memory); meanwhile the block sums V^T x and
//      reads V's row kj+1.  It copies x below kj+1 from the column buffer
//      into shared memory with cp.async while it forms V^T v_j and T's
//      column j (the same bits in every block), writes its rows of A[:, kj]
//      and V[:, j] and runs the GEMV for its rows as
//      W[r, j] = A[r, kj+1] + A[r, kj+2:] . x / denom (v_j is x / denom below
//      kj+1, so the scaling waits for the row sum): a warp HP_ROWS rows of
//      a column segment, lanes over columns, several loads in flight, then
//      a butterfly.
// Row r of W is read only by the block that owns row r, and every block has
// its own T and x, so no barrier follows the GEMV: column j + 1's step 1
// starts at once.  Every cross-block sum is a warp's: lane l takes blocks l,
// l+32, ... (all loaded before the first is added), then a fixed butterfly.
// Rounding: the longest chain one element of W runs through in a column
// (the two updates, the sums of u and of the norm, T^T u, the GEMV) is what
// kernels/panel_hessenberg.py's plan() counts ("chain").
//
// Determinism: no atomics; every sum runs in a fixed order, so the same
// input gives the same bits on every run and the rtm schedule stays bitwise
// equal to mtb.  The kernel is held to its plain PyTorch version within
// 4 * chain * eps (the sums group differently).
#include "dense.cuh"

constexpr int HP_THREADS = 512, HP_WARPS = HP_THREADS / 32;
constexpr int64_t HP_MIN_ROWS = 8;  // rows a block at least
constexpr int HP_ROWS = 4;          // rows a warp streams at once in the GEMV
constexpr int HP_PAD = 4;           // extra columns of V's and W's rows in shared memory
constexpr int HP_HEAD = 256;        // shared bytes before the vectors

// Where a launch keeps T (upper triangle packed by columns: T[i, l] at
// l(l+1)/2 + i), the block's rows of V and of W (ld bk + HP_PAD) and the
// column x below kj+1 (entry c at c - k - 1): byte offsets into shared
// memory, or -1 for device memory (T and x in the block's slice of the
// workspace, V and W in their outputs).
struct HessLayout {
  int64_t t, v, w, x;
};

// Shared memory a block needs besides what the layout places: three vectors
// of bk, its rows' column values and the column sums' group partials.
template <typename T>
__host__ __device__ constexpr size_t hess_extras(int64_t bk, int64_t chunk) {
  return (HP_HEAD + (3 * bk + chunk + HP_THREADS) * sizeof(T) + 15) / 16 * 16;
}

// Column segments a warp's rows split into for the GEMV of a chunk.
__host__ __device__ constexpr int hess_segments(int64_t chunk) {
  const int64_t groups = (chunk + HP_ROWS - 1) / HP_ROWS;
  return groups >= HP_WARPS ? 1 : static_cast<int>(HP_WARPS / (groups > 0 ? groups : 1));
}

template <typename T>
__global__ void __launch_bounds__(HP_THREADS, 1)
hessenberg_panel_kernel(int64_t n, int64_t k, int64_t bk64, T* a, int64_t lda, T* v, T* t,
                        T* w, T* tau, T* ws, HessLayout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, bk = static_cast<int>(bk64);
  int64_t chunk, r0, r1;
  owned_rows(n, G, blk, &chunk, &r0, &r1);
  const int nr = static_cast<int>(r1 - r0);
  T* sc = reinterpret_cast<T*>(smem_raw);            // alpha, |x|^2 below kj
  T* q0 = reinterpret_cast<T*>(smem_raw + HP_HEAD);  // V[kj, :j], then u, then V^T v_j
  T* q1 = q0 + bk;                                    // s, then z, then T[:j, j]
  T* qv = q1 + bk;                                    // V[kj+1, :j], read in step 3
  T* xc = qv + bk;                                    // [chunk] the block's rows of the column
  T* red = xc + chunk;                                // [HP_THREADS]
  T* cw = ws;                                         // [n] the column after the left update
  T* pu = cw + n;                                     // [bk][G] sums of V^T col
  T* px = pu + static_cast<int64_t>(bk) * G;          // [bk][G] sums of V^T x below kj+1
  T* pn = px + static_cast<int64_t>(bk) * G;          // [G] |x|^2 below kj
  const int64_t tsz = static_cast<int64_t>(bk) * (bk + 1) / 2, xlen = n - k - 1;
  T* tail = pn + G;
  T* ts = lay.t >= 0 ? reinterpret_cast<T*>(smem_raw + lay.t) : tail + blk * tsz;
  T* xv = lay.x >= 0 ? reinterpret_cast<T*>(smem_raw + lay.x)
                     : tail + (lay.t >= 0 ? 0 : G * tsz) + blk * xlen;
  const int ldv = lay.v >= 0 ? bk + HP_PAD : bk, ldw = lay.w >= 0 ? bk + HP_PAD : bk;
  T* vs = lay.v >= 0 ? reinterpret_cast<T*>(smem_raw + lay.v) : v + r0 * bk;
  T* wr = lay.w >= 0 ? reinterpret_cast<T*>(smem_raw + lay.w) : w + r0 * bk;
  for (int e = tid; e < nr * (bk + HP_PAD); e += HP_THREADS) {  // V and W start zero
    if (lay.v >= 0) vs[e] = T(0);
    if (lay.w >= 0) wr[e] = T(0);
  }
  __syncthreads();
  auto tat = [&](int i, int l) { return ts[l * (l + 1) / 2 + i]; };  // T[i, l], i <= l
  const int lgr = group_lg(chunk, HP_THREADS);  // lanes a row of the updates
  const int lgt = group_lg(bk, HP_THREADS);     // lanes an entry of T's products
  const int segs = hess_segments(chunk);
  const int groups = (nr + HP_ROWS - 1) / HP_ROWS;

  for (int j = 0; j < bk; ++j) {
    const int64_t kj = k + j;
    const bool valid = kj < n - 2;  // rows kj+2.. exist: reduce them

    // 1. s = T[:j, :j] V[kj, :j]^T (V[kj, :j-1] as step 3 of column j-1 read
    // it; V[kj, j-1] is 1 where column j-1 had a reflector); the right update
    for (int i = tid; i < j; i += HP_THREADS)
      q0[i] = i == j - 1 ? (kj - 1 < n - 2 ? T(1) : T(0)) : qv[i];
    __syncthreads();
    group_sums<T>(
        j, lgt, [](int l) { return l; }, [&](int) { return j; },
        [&](int l, int i, T acc) { return fma(tat(l, i), q0[i], acc); },
        [&](int l, T s) { q1[l] = s; });
    __syncthreads();
    group_sums<T>(
        nr, lgr, [](int) { return 0; }, [&](int) { return j; },
        [&](int rr, int l, T acc) { return fma(wr[rr * ldw + l], q1[l], acc); },
        [&](int rr, T d) { xc[rr] = a[(r0 + rr) * lda + kj] - d; });
    __syncthreads();
    if (lay.v >= 0)
      block_col_sums<T, false>(vs, ldv, xc, 1, 0, nr, j, red, pu);
    else
      block_col_sums<T, false, true>(vs, ldv, xc, 1, 0, nr, j, red, pu);
    grid.sync();

    // 2. u = V^T col, z = T^T u; the left update of the rows > k (V is zero
    // on the others); the partial norm and the sums of V^T x
    cross_sums(pu, j, G, [&](int i, T s) {
      if (lane == 0) q0[i] = s;
    });
    __syncthreads();
    group_sums<T>(
        j, lgt, [](int) { return 0; }, [](int l) { return l + 1; },
        [&](int l, int i, T acc) { return fma(tat(i, l), q0[i], acc); },
        [&](int l, T s) { q1[l] = s; });
    __syncthreads();
    const int lk = static_cast<int>(k + 1 - r0 < 0 ? 0 : (k + 1 - r0 > nr ? nr : k + 1 - r0));
    group_sums<T>(
        nr - lk, lgr, [](int) { return 0; }, [&](int) { return j; },
        [&](int e, int l, T acc) { return fma(vs[(lk + e) * ldv + l], q1[l], acc); },
        [&](int e, T d) { xc[lk + e] -= d; });
    __syncthreads();
    for (int rr = tid; rr < nr; rr += HP_THREADS) {
      cw[r0 + rr] = xc[rr];
      if (r0 + rr <= kj) a[(r0 + rr) * lda + kj] = xc[rr];
    }
    const int lo1 = static_cast<int>(kj + 1 - r0 < 0 ? 0 : (kj + 1 - r0 > nr ? nr : kj + 1 - r0));
    const int lo2 = static_cast<int>(kj + 2 - r0 < 0 ? 0 : (kj + 2 - r0 > nr ? nr : kj + 2 - r0));
    if (warp == 0) {
      T s = T(0);
      for (int rr = lo1 + lane; rr < nr; rr += 32) s = fma(xc[rr], xc[rr], s);
      s = warp_sum(s);
      if (lane == 0) pn[blk] = s;
    }
    if (lay.v >= 0)
      block_col_sums<T, false>(vs, ldv, xc, 1, lo2, nr, j, red, px);
    else
      block_col_sums<T, false, true>(vs, ldv, xc, 1, lo2, nr, j, red, px);
    grid.sync();

    // 3. warp 0 sums the norm and reads alpha; meanwhile the block sums
    // V^T x and reads V's row kj+1
    if (warp == 0) {
      const T s = warp_sum(lane_partials(pn, 1, G, lane));
      if (lane == 0) {
        sc[0] = kj + 1 < n ? __ldcg(cw + kj + 1) : T(0);
        sc[1] = s;
      }
    }
    if (kj + 1 < n)
      for (int i = tid; i < j; i += HP_THREADS) qv[i] = __ldcg(v + (kj + 1) * bk + i);
    if (valid) cross_sums(px, j, G, [&](int i, T s) {
      if (lane == 0) q0[i] = s;
    });
    __syncthreads();
    const T alpha = sc[0];
    const T xnorm = sqrt_rn(sc[1]);
    const bool safe = xnorm > T(0);
    const T beta = alpha >= T(0) ? -xnorm : xnorm;
    const T tj = valid && safe ? div_rn(beta - alpha, beta) : T(0);
    const T denom = safe ? alpha - beta : T(1);
    const T diag = safe ? beta : alpha;
    T* tcol = ts + static_cast<int64_t>(j) * (j + 1) / 2;  // T[:, j]
    if (valid) {
      // the column below kj+1 (x, unscaled: the GEMV scales its sums) from
      // the column buffer, asynchronously into shared memory
      for (int64_t cc = kj + 2 + tid; cc < n; cc += HP_THREADS) {
        if (lay.x >= 0)
          cp_async_elem<sizeof(T)>(xv + (cc - k - 1), cw + cc, sizeof(T));
        else
          xv[cc - k - 1] = __ldcg(cw + cc);
      }
      cp_async_commit();
      // V^T v_j = V[kj+1, :j] + V^T x / denom, then T[:j, j]
      for (int i = tid; i < j; i += HP_THREADS) q0[i] = qv[i] + div_rn(q0[i], denom);
      __syncthreads();
      group_sums<T>(
          j, lgt, [](int l) { return l; }, [&](int) { return j; },
          [&](int l, int i, T acc) { return fma(tat(l, i), q0[i], acc); },
          [&](int l, T s) { q1[l] = -tj * s; });
      cp_async_wait<0>();
      __syncthreads();
      for (int l = tid; l <= j; l += HP_THREADS) {
        const T x = l < j ? q1[l] : tj;
        tcol[l] = x;
        if (blk == 0) t[static_cast<int64_t>(l) * bk + j] = x;
      }
    } else {
      for (int l = tid; l <= j; l += HP_THREADS) tcol[l] = T(0);
    }
    // the block's rows of A[:, kj] below kj and of V[:, j]
    for (int rr = lo1 + tid; rr < nr; rr += HP_THREADS) {
      const int64_t r = r0 + rr;
      T vr = T(0), an = xc[rr];
      if (valid && r > kj + 1) {
        vr = div_rn(xc[rr], denom);
        an = vr;
      } else if (valid) {
        vr = T(1);
        an = diag;
      }
      a[r * lda + kj] = an;
      v[r * bk + j] = vr;
      if (lay.v >= 0) vs[rr * ldv + j] = vr;
    }
    if (blk == 0 && tid == 0) tau[j] = tj;
    __syncthreads();
    if (!valid) continue;  // W[:, j] stays zero

    // W[r, j] = A[r, kj+1:] . v_j[kj+1:] = A[r, kj+1] + A[r, kj+2:] . x / denom
    // for the block's rows: warp tasks of HP_ROWS rows and one of `segs`
    // interleaved column segments; the segments' sums are added in order
    for (int task = warp; task < groups * segs; task += HP_WARPS) {
      const int gr = task / segs, seg = task - gr * segs;
      const int rr0 = gr * HP_ROWS, nq = nr - rr0 < HP_ROWS ? nr - rr0 : HP_ROWS;
      const T* row = a + (r0 + rr0) * lda;
      T acc[HP_ROWS];
#pragma unroll
      for (int q = 0; q < HP_ROWS; ++q) acc[q] = T(0);
#pragma unroll 4
      for (int64_t cc = kj + 2 + 32 * seg + lane; cc < n; cc += 32 * segs) {
        const T y = xv[cc - k - 1];
#pragma unroll
        for (int q = 0; q < HP_ROWS; ++q)
          if (q < nq) acc[q] = fma(row[q * lda + cc], y, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < HP_ROWS; ++q) acc[q] = warp_sum(acc[q]);
      if (lane == 0)
        for (int q = 0; q < nq; ++q) {
          if (segs == 1) {
            const T x = row[q * lda + kj + 1] + div_rn(acc[q], denom);
            w[(r0 + rr0 + q) * bk + j] = x;
            if (lay.w >= 0) wr[(rr0 + q) * ldw + j] = x;
          } else {
            red[seg * HP_ROWS * groups + rr0 + q] = acc[q];
          }
        }
    }
    if (segs > 1) {
      __syncthreads();
      for (int rr = tid; rr < nr; rr += HP_THREADS) {
        T s = red[rr];
        for (int sg = 1; sg < segs; ++sg) s += red[sg * HP_ROWS * groups + rr];
        const T x = a[(r0 + rr) * lda + kj + 1] + div_rn(s, denom);
        w[(r0 + rr) * bk + j] = x;
        if (lay.w >= 0) wr[rr * ldw + j] = x;
      }
    }
  }
}

// How an n x n matrix's panel (k, bk) runs: out = {blocks, rows a block
// (chunk), dynamic shared memory bytes, workspace elements, the layout's t,
// v, w, x offsets (-1: device memory), threads a block, lanes a row of the
// updates (log2), lanes an entry of T's products (log2), GEMV column
// segments, the widest bk whose shared memory fits}.
template <typename T>
static cudaError_t hess_plan(int64_t n, int64_t k, int64_t bk, int64_t* out) {
  if (n <= 0 || bk <= 0 || k < 0 || k + bk > n) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = panel_card(&sms, &optin);
  if (err != cudaSuccess) return err;
  int64_t g = (n + HP_MIN_ROWS - 1) / HP_MIN_ROWS;
  g = g < sms ? g : sms;
  g = g < PANEL_MAX_BLOCKS ? g : PANEL_MAX_BLOCKS;
  const int64_t chunk = (n + g - 1) / g;
  const size_t limit = static_cast<size_t>(optin);
  size_t used = hess_extras<T>(bk, chunk);
  out[12] = static_cast<int64_t>((limit - hess_extras<T>(0, chunk)) / (3 * sizeof(T)));
  if (used > limit) return cudaErrorInvalidValue;
  const int64_t tsz = bk * (bk + 1) / 2, xlen = n - k - 1;
  auto take = [&](int64_t elems, int64_t* off) {
    const size_t bytes = (static_cast<size_t>(elems) * sizeof(T) + 15) / 16 * 16;
    *off = -1;
    if (used + bytes <= limit) {
      *off = static_cast<int64_t>(used);
      used += bytes;
    }
  };
  HessLayout lay;
  take(tsz, &lay.t);
  take(chunk * (bk + HP_PAD), &lay.v);
  take(xlen, &lay.x);
  take(chunk * (bk + HP_PAD), &lay.w);
  bool ok = false;
  err = fits_one_block(hessenberg_panel_kernel<T>, HP_THREADS, used, &ok);
  if (err != cudaSuccess) return err;
  if (!ok) return cudaErrorInvalidConfiguration;
  out[0] = g;
  out[1] = chunk;
  out[2] = static_cast<int64_t>(used);
  out[3] = n + 2 * bk * g + g + (lay.t < 0 ? g * tsz : 0) + (lay.x < 0 ? g * xlen : 0);
  out[4] = lay.t;
  out[5] = lay.v;
  out[6] = lay.w;
  out[7] = lay.x;
  out[8] = HP_THREADS;
  out[9] = group_lg(chunk, HP_THREADS);
  out[10] = group_lg(bk, HP_THREADS);
  out[11] = hess_segments(chunk);
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_hessenberg(int64_t n, int64_t k, int64_t bk, void* a, int64_t lda,
                                     void* v, void* t, void* w, void* tau, int grid,
                                     int64_t smem, const int64_t* layout, void* ws,
                                     cudaStream_t stream) {
  if (n <= 0 || bk <= 0) return cudaSuccess;
  if (grid < 1 || grid > PANEL_MAX_BLOCKS) return cudaErrorInvalidValue;
  T* ap = static_cast<T*>(a);
  T* vp = static_cast<T*>(v);
  T* tp = static_cast<T*>(t);
  T* wp = static_cast<T*>(w);
  T* taup = static_cast<T*>(tau);
  T* wsp = static_cast<T*>(ws);
  HessLayout lay{layout[0], layout[1], layout[2], layout[3]};
  void* args[] = {&n, &k, &bk, &ap, &lda, &vp, &tp, &wp, &taup, &wsp, &lay};
  return launch_cooperative(hessenberg_panel_kernel<T>, grid, static_cast<size_t>(smem), args,
                            stream, HP_THREADS);
}

extern "C" int repro_hessenberg_panel_plan_f32(int64_t n, int64_t k, int64_t bk, int64_t* out) {
  return hess_plan<float>(n, k, bk, out);
}

extern "C" int repro_hessenberg_panel_plan_f64(int64_t n, int64_t k, int64_t bk, int64_t* out) {
  return hess_plan<double>(n, k, bk, out);
}

extern "C" int repro_hessenberg_panel_f32(int64_t n, int64_t k, int64_t bk, void* a,
                                          int64_t lda, void* v, void* t, void* w, void* tau,
                                          int grid, int64_t smem, const int64_t* layout,
                                          void* ws, void* stream) {
  return launch_hessenberg<float>(n, k, bk, a, lda, v, t, w, tau, grid, smem, layout, ws,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int repro_hessenberg_panel_f64(int64_t n, int64_t k, int64_t bk, void* a,
                                          int64_t lda, void* v, void* t, void* w, void* tau,
                                          int grid, int64_t smem, const int64_t* layout,
                                          void* ws, void* stream) {
  return launch_hessenberg<double>(n, k, bk, a, lda, v, t, w, tau, grid, smem, layout, ws,
                                   static_cast<cudaStream_t>(stream));
}
