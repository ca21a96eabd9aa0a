// Triangular solves for Hopper (sm_90a): left TRSM, right transposed TRSM
// and the fused small LU solve.
//
// Replaces the TPU kernels repro/kernels/trsm.py::trsm_left_lower (L*X = B,
// unit or not) -- here with an upper mode too, for the back sweep that the
// reference sends to its library solve -- ::trsm_right_lower_t (X*L^T = B,
// the Cholesky L21 solve, which the reference computes by transposing around
// trsm_left_lower) and ::lu_solve_small (forward unit-lower then backward
// upper substitution on a packed LU in one residency).
//
// The rounding contract is solve_vector of dense.cuh, which the fused panel
// updates (fused_pu.cu) also run: for every right-hand side, element i
// starts from B[i], takes the terms fma(-T[i, j], x[j], acc) in ascending j
// for a lower and descending j for an upper triangle, then div_rn by T[i, i]
// unless the diagonal is unit.  trsm_chain_kernel runs it as written, one
// thread a right-hand side.  It is on no path: the tests and chip_smoke.py
// hold trsm_strip_kernel bitwise to it.  lu_solve_kernel runs it too.
//
// What bounds the solve on an H100: at b = 128 it does b*b flops per
// right-hand side against 2*b*8 bytes of it in f64 -- 8 flop/byte, bytes
// in principle (0.005 ms at 128 x 8064), but every element is a chain of up
// to b dependent FMAs, so latency bounds it.  The chain kernel gave each
// right-hand side one thread and a block one warp: 252 one-warp blocks at
// 8064 columns, one block at the solves' 16, and each thread walked all
// b(b-1)/2 terms alone, so its time (about 0.4 ms f64) hardly depended on
// the width.  Its right mode read B by rows, uncoalesced.
//
// Design: strips of the triangle over a tile of right-hand sides.
//   * A block of THREADS threads owns NC right-hand sides and all b rows of
//     them: NC columns of B (left), or NC rows of B staged transposed (right),
//     so both modes run one algorithm on an x tile xs[b][NCP] in shared
//     memory.  B is loaded by cp.async: 16-byte copies where the base and
//     leading dimension are 16-byte aligned (left), one element a copy
//     otherwise and in the right mode, whose transposed writes are spread
//     over the banks by NCP = NC + 1.  X may alias B: a block reads its
//     whole tile before it writes, and writes only its tile.  NC follows
//     the width (plan below): NC_NARROW while its tiles run in one wave
//     (BLOCKS_PER_SM a SM), so narrow solves spread over more SMs, else
//     NC_WIDE, whose block does four narrow tiles' work in about 1.3
//     times one's time.  tools/trsm_tile_width.py times both widths.
//   * The triangle is walked in strips of R rows, top-down for a lower and
//     bottom-up for an upper one.  The strip's columns of T (the rows not yet
//     solved) are staged in shared memory, the next strip's loaded by
//     cp.async while this one is used (two buffers).  A strip is
//       1. the diagonal solve: NC threads, one a right-hand side, finish the
//          strip's R accumulators in registers column by column (x[p] final,
//          then its term to every later row), the next column of T loading
//          meanwhile;
//       2. the rank-R update: every thread applies the strip to rows not
//          yet solved, ROWS_AT_ONCE independent accumulators at a time, the
//          strip's terms in the solve's order, 16 bytes of T a load.
//     Two blocks share an SM, so one block's diagonal solve overlaps the
//     other's update.  A look-ahead inside the block (warp 0 solving strip
//     k+1's diagonal while the other warps finish strip k's update, after
//     strip k+1's rows took their terms) was measured and did not pay: an
//     update's time is each thread's chain of loads and R dependent FMAs,
//     which strip k+1's rows alone take as long as all rows.
//   * f64 on DFMA and f32 on FFMA through explicit fma(); nothing is left
//     for the compiler to contract.
//
// Why it is bitwise solve_vector: an element's accumulator is a value in
// shared memory or a register and receives every term of its row exactly
// once, as one fma, in the chain's order -- strip by strip in the solve's
// direction and within a strip in the same direction -- then one div_rn.
// Moving the accumulator between registers and shared memory is exact and
// negating T is exact.  Each column of X depends only on T and its own
// column of B, never on NC, the strip or which columns share a block, so the
// kernel is column-decomposable as the look-ahead schedules need.
#include "dense.cuh"

constexpr int64_t MAX_B = 256;

// ---------------------------------------------------------------------------
// The contract, one thread a right-hand side (also the small LU solve).
// ---------------------------------------------------------------------------
constexpr int CHAIN_NC = 32;  // right-hand sides per block

// RIGHT: the right-hand side `rhs` is row `rhs` of B (X*L^T = B, LOWER
// only); otherwise column `rhs` of B.
template <typename T, bool LOWER, bool UNIT, bool RIGHT>
__global__ void __launch_bounds__(CHAIN_NC)
trsm_chain_kernel(int64_t b, int64_t n, const T* __restrict__ t, int64_t ldt,
                  const T* B, int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int64_t rhs = static_cast<int64_t>(blockIdx.x) * CHAIN_NC + threadIdx.x;
  if (rhs >= n) return;
  for (int64_t i = 0; i < b; ++i) x[i * CHAIN_NC] = RIGHT ? B[rhs * ldb + i] : B[i * ldb + rhs];
  solve_vector<T, LOWER, UNIT>(b, t, ldt, x, CHAIN_NC);
  for (int64_t i = 0; i < b; ++i) {
    if (RIGHT) X[rhs * ldx + i] = x[i * CHAIN_NC];
    else X[i * ldx + rhs] = x[i * CHAIN_NC];
  }
}

template <typename T>
__global__ void __launch_bounds__(CHAIN_NC)
lu_solve_kernel(int64_t n, int64_t nrhs, const T* __restrict__ lu, int64_t ldl,
                const T* B, int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * CHAIN_NC + threadIdx.x;
  if (col >= nrhs) return;
  for (int64_t i = 0; i < n; ++i) x[i * CHAIN_NC] = B[i * ldb + col];
  solve_vector<T, true, true>(n, lu, ldl, x, CHAIN_NC);    // L*y = b (unit lower)
  solve_vector<T, false, false>(n, lu, ldl, x, CHAIN_NC);  // U*x = y
  for (int64_t i = 0; i < n; ++i) X[i * ldx + col] = x[i * CHAIN_NC];
}

template <typename Kernel, typename... Args>
static cudaError_t launch_columns(Kernel kernel, int64_t rows, int64_t cols,
                                  size_t elem, cudaStream_t stream,
                                  Args... args) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  if (rows > MAX_B) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(rows) * CHAIN_NC * elem;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>((cols + CHAIN_NC - 1) / CHAIN_NC), CHAIN_NC, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The strip kernel.
// ---------------------------------------------------------------------------
constexpr int R = 16;             // rows of a strip
constexpr int THREADS = 256, BLOCKS_PER_SM = 2;
constexpr int ROWS_AT_ONCE = 2;   // update rows a thread carries at once
constexpr int NC_WIDE = 32, NC_NARROW = 8;
template <typename T>
constexpr int V16 = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes

// Shared memory: two strip buffers ts[rows][RS], then the x tile
// xs[b][NCP].  RS pads a strip row by 16 bytes, so the rows that one warp
// reads at once fall on different banks; every strip row starts 16-byte
// aligned.  A buffer holds b rows rounded up to a whole strip, so the
// diagonal solve addresses all R rows of a ragged strip.
template <typename T, int NC, bool RIGHT>
struct Layout {
  static constexpr int NCP = RIGHT ? NC + 1 : NC;
  static constexpr int RS = R + V16<T>;
  __host__ __device__ static constexpr size_t strip(int64_t b) {
    return (b + R - 1) / R * R * RS;
  }
  __host__ __device__ static constexpr size_t bytes(int64_t b) {
    return (2 * strip(b) + static_cast<size_t>(b) * NCP) * sizeof(T);
  }
};

// 16 bytes of T read as one vector, taken apart by constant index.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
template <typename T>
union Lanes {
  typename Vec16<T>::type v;
  T e[V16<T>];
};

// The strip [lo, lo + w) of the triangle: rows [r0, r1) of columns
// [lo, lo + w) into ts[row - r0][0 .. R), zero past w.
template <typename T, int RS, bool VEC>
__device__ __forceinline__ void load_strip(T* ts, const T* __restrict__ t, int64_t ldt,
                                           int r0, int r1, int lo, int w) {
  if (VEC) {
    constexpr int V = V16<T>, CH = R / V;
    for (int e = threadIdx.x; e < (r1 - r0) * CH; e += THREADS) {
      const int rr = e / CH, cc = (e % CH) * V;
      int valid = w - cc;
      valid = valid < 0 ? 0 : (valid > V ? V : valid);
      cp_async16(ts + rr * RS + cc, valid > 0 ? t + (r0 + rr) * ldt + lo + cc : t,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = threadIdx.x; e < (r1 - r0) * R; e += THREADS) {
      const int rr = e / R, cc = e % R;
      const bool ok = cc < w;
      cp_async_elem<sizeof(T)>(ts + rr * RS + cc, ok ? t + (r0 + rr) * ldt + lo + cc : t,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// The rows [lo, lo + w) of a strip: lo, w, and the first row r0 that its
// buffer holds ([lo, b) for a lower, [0, lo + w) for an upper triangle).
struct Strip {
  int lo, w, r0;
};

// Phase 1 of a strip, right-hand side c (one thread): the diagonal solve.
// x[p] is final once its row has its terms and division; it then gives
// every later row of the strip its term p, so each row takes its terms in
// the chain's order while the rows' FMAs are independent of each other.
// Column p of the triangle is in registers, the next column loading
// meanwhile.  Rows past a ragged strip's w compute on stale values and are
// never stored (the buffer holds whole strips, so they stay inside it).
template <typename T, bool LOWER, bool UNIT, int NCP, int RS>
__device__ __forceinline__ void diag_solve(T* xs, const T* ts, Strip st, int c) {
  const T* tq = ts + (st.lo - st.r0) * RS;  // row q of the strip at tq + q * RS
  T xr[R], cols[2][R];
#pragma unroll
  for (int q = 0; q < R; ++q) xr[q] = q < st.w ? xs[(st.lo + q) * NCP + c] : T(0);
  // rows p.. (lower) or ..p (upper) of column p
  auto load_col = [&](int p, T(&dst)[R]) {
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (LOWER ? q >= p : q <= p) dst[q] = tq[q * RS + p];
  };
  load_col(LOWER ? 0 : R - 1, cols[0]);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = LOWER ? k : R - 1 - k;
    const T(&col)[R] = cols[k & 1];
    if (k + 1 < R) load_col(LOWER ? p + 1 : p - 1, cols[(k + 1) & 1]);
    if (p < st.w) {
      if (!UNIT) xr[p] = div_rn(xr[p], col[p]);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (LOWER ? q > p : q < p) xr[q] = fma(-col[q], xr[p], xr[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (q < st.w) xs[(st.lo + q) * NCP + c] = xr[q];
}

// Phase 2 of a strip: its terms applied to the rows [u0, u1), by thread
// (c, g) of G per column, ROWS_AT_ONCE rows at a time.  In a ragged strip
// the terms past w are fma(-0, +0, acc): T's columns there are zero-filled
// and x's are +0, so they leave every accumulator as it is.
template <typename T, bool LOWER, int NCP, int RS>
__device__ __forceinline__ void update_rows(T* xs, const T* ts, Strip st, int u0, int u1,
                                            int c, int g, int G) {
  using Vec = typename Vec16<T>::type;
  constexpr int V = V16<T>;
  if (u0 + g >= u1) return;
  T xv[R];
#pragma unroll
  for (int p = 0; p < R; ++p) xv[p] = p < st.w ? xs[(st.lo + p) * NCP + c] : T(0);
  for (int i0 = u0 + g; i0 < u1; i0 += ROWS_AT_ONCE * G) {
    T acc[ROWS_AT_ONCE];
    const T* trow[ROWS_AT_ONCE];
#pragma unroll
    for (int a = 0; a < ROWS_AT_ONCE; ++a) {
      const int i = i0 + a * G;
      acc[a] = i < u1 ? xs[i * NCP + c] : T(0);
      trow[a] = ts + ((i < u1 ? i : u0) - st.r0) * RS;
    }
#pragma unroll
    for (int v0 = 0; v0 < R; v0 += V) {
      const int p0 = LOWER ? v0 : R - V - v0;  // the 16 bytes of T taken now
      Lanes<T> tv[ROWS_AT_ONCE];
#pragma unroll
      for (int a = 0; a < ROWS_AT_ONCE; ++a) tv[a].v = *reinterpret_cast<const Vec*>(trow[a] + p0);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int pe = LOWER ? e : V - 1 - e;
#pragma unroll
        for (int a = 0; a < ROWS_AT_ONCE; ++a) acc[a] = fma(-tv[a].e[pe], xv[p0 + pe], acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < ROWS_AT_ONCE; ++a) {
      const int i = i0 + a * G;
      if (i < u1) xs[i * NCP + c] = acc[a];
    }
  }
}

// Solve NC right-hand sides (columns c0.. of B, or rows c0.. of B when
// RIGHT) against the b x b triangle t.  VEC: t and (left) B have 16-byte
// aligned rows.
template <typename T, bool LOWER, bool UNIT, bool RIGHT, int NC, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
trsm_strip_kernel(int b, int64_t n, const T* __restrict__ t, int64_t ldt, const T* B,
                  int64_t ldb, T* X, int64_t ldx) {
  using L = Layout<T, NC, RIGHT>;
  constexpr int NCP = L::NCP, RS = L::RS, V = V16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ts0 = reinterpret_cast<T*>(smem_raw);
  T* xs = ts0 + 2 * L::strip(b);
  const int tid = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * NC;
  const int cols = static_cast<int>(min(static_cast<int64_t>(NC), n - c0));

  // the x tile
  if (RIGHT) {
    for (int e = tid; e < NC * b; e += THREADS) {
      const int cc = e / b, i = e % b;
      const bool ok = cc < cols;
      cp_async_elem<sizeof(T)>(xs + i * NCP + cc, ok ? B + (c0 + cc) * ldb + i : B,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  } else if (VEC) {
    constexpr int CH = NC / V;
    for (int e = tid; e < b * CH; e += THREADS) {
      const int i = e / CH, cc = (e % CH) * V;
      int valid = cols - cc;
      valid = valid < 0 ? 0 : (valid > V ? V : valid);
      cp_async16(xs + i * NCP + cc, valid > 0 ? B + i * ldb + c0 + cc : B,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = tid; e < b * NC; e += THREADS) {
      const int i = e / NC, cc = e % NC;
      const bool ok = cc < cols;
      cp_async_elem<sizeof(T)>(xs + i * NCP + cc, ok ? B + i * ldb + c0 + cc : B,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }

  // Strip s covers rows [s*R, min(b, s*R + R)); step k takes strip k
  // (lower) or strip S-1-k (upper), held in buffer k % 2 while strip k+1
  // loads into the other.
  const int S = (b + R - 1) / R;
  auto strip = [&](int k) {
    const int lo = (LOWER ? k : S - 1 - k) * R, w = min(b, lo + R) - lo;
    return Strip{lo, w, LOWER ? lo : 0};
  };
  auto buffer = [&](int k) { return ts0 + (k & 1) * L::strip(b); };
  auto stage = [&](int k) {
    const Strip st = strip(k);
    load_strip<T, RS, VEC>(buffer(k), t, ldt, st.r0, LOWER ? b : st.lo + st.w, st.lo, st.w);
    cp_async_commit();
  };
  stage(0);  // with the tile
  for (int k = 0; k < S; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // strip k landed; the other buffer's last reader is done
    if (k + 1 < S) stage(k + 1);
    const Strip st = strip(k);
    const T* ts = buffer(k);
    if (tid < NC) diag_solve<T, LOWER, UNIT, NCP, RS>(xs, ts, st, tid);
    __syncthreads();
    update_rows<T, LOWER, NCP, RS>(xs, ts, st, LOWER ? st.lo + st.w : 0, LOWER ? b : st.lo,
                                   tid % NC, tid / NC, THREADS / NC);
  }
  __syncthreads();

  // write the tile back
  if (RIGHT) {
    for (int e = tid; e < cols * b; e += THREADS) {
      const int cc = e / b, i = e % b;
      X[(c0 + cc) * ldx + i] = xs[i * NCP + cc];
    }
  } else {
    for (int e = tid; e < b * NC; e += THREADS) {
      const int i = e / NC, cc = e % NC;
      if (cc < cols) X[i * ldx + c0 + cc] = xs[i * NCP + cc];
    }
  }
}

// How a solve of n right-hand sides of length b runs.
struct Plan {
  int nc, blocks;
  size_t smem;
};

static int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

template <typename T, bool RIGHT>
static Plan make_plan(int64_t b, int64_t n) {
  // NC_NARROW while its tiles run in one wave, else NC_WIDE
  const int nc = (n + NC_NARROW - 1) / NC_NARROW <= BLOCKS_PER_SM * sm_count() ? NC_NARROW
                                                                               : NC_WIDE;
  const size_t smem = nc == NC_WIDE ? Layout<T, NC_WIDE, RIGHT>::bytes(b)
                                    : Layout<T, NC_NARROW, RIGHT>::bytes(b);
  return {nc, static_cast<int>((n + nc - 1) / nc), smem};
}

// One instantiation's launch; its shared-memory limit is raised once, to
// what b = MAX_B needs (a host call per launch would cost as much as a
// narrow solve).
template <typename T, bool LOWER, bool UNIT, bool RIGHT, int NC, bool VEC>
static cudaError_t launch_strip(const Plan& p, int64_t b, int64_t n, const T* t, int64_t ldt,
                                const T* B, int64_t ldb, T* X, int64_t ldx, cudaStream_t s) {
  auto kernel = trsm_strip_kernel<T, LOWER, UNIT, RIGHT, NC, VEC>;
  static const cudaError_t raised = allow_smem(kernel, Layout<T, NC, RIGHT>::bytes(MAX_B));
  if (raised != cudaSuccess) return raised;
  kernel<<<p.blocks, THREADS, p.smem, s>>>(static_cast<int>(b), n, t, ldt, B, ldb, X, ldx);
  return cudaGetLastError();
}

template <typename T, bool LOWER, bool UNIT, bool RIGHT>
static cudaError_t run_strip(int64_t b, int64_t n, const void* t, int64_t ldt, const void* B,
                             int64_t ldb, void* X, int64_t ldx, cudaStream_t s) {
  if (b <= 0 || n <= 0) return cudaSuccess;
  if (b > MAX_B) return cudaErrorInvalidValue;
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  const Plan p = make_plan<T, RIGHT>(b, n);
  const bool vec = aligned16(t, ldt, sizeof(T)) && (RIGHT || aligned16(B, ldb, sizeof(T)));
  if (p.nc == NC_WIDE)
    return vec ? launch_strip<T, LOWER, UNIT, RIGHT, NC_WIDE, true>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s)
               : launch_strip<T, LOWER, UNIT, RIGHT, NC_WIDE, false>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s);
  return vec ? launch_strip<T, LOWER, UNIT, RIGHT, NC_NARROW, true>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s)
             : launch_strip<T, LOWER, UNIT, RIGHT, NC_NARROW, false>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s);
}

template <typename T>
static cudaError_t launch_trsm(int64_t b, int64_t n, int lower, int unit, const void* t,
                               int64_t ldt, const void* B, int64_t ldb, void* X, int64_t ldx,
                               cudaStream_t s) {
  if (lower && unit) return run_strip<T, true, true, false>(b, n, t, ldt, B, ldb, X, ldx, s);
  if (lower) return run_strip<T, true, false, false>(b, n, t, ldt, B, ldb, X, ldx, s);
  if (unit) return run_strip<T, false, true, false>(b, n, t, ldt, B, ldb, X, ldx, s);
  return run_strip<T, false, false, false>(b, n, t, ldt, B, ldb, X, ldx, s);
}

// X*L^T = B for B with m rows: m right-hand sides of length b.
template <typename T>
static cudaError_t launch_trsm_right(int64_t b, int64_t m, int unit, const void* t, int64_t ldt,
                                     const void* B, int64_t ldb, void* X, int64_t ldx,
                                     cudaStream_t s) {
  if (unit) return run_strip<T, true, true, true>(b, m, t, ldt, B, ldb, X, ldx, s);
  return run_strip<T, true, false, true>(b, m, t, ldt, B, ldb, X, ldx, s);
}

template <typename T>
static cudaError_t launch_chain(int64_t b, int64_t n, int lower, int unit, int right,
                                const void* t, int64_t ldt, const void* B, int64_t ldb,
                                void* X, int64_t ldx, cudaStream_t s) {
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  const size_t e = sizeof(T);
  if (right) {
    if (!lower) return cudaErrorInvalidValue;
    return unit ? launch_columns(trsm_chain_kernel<T, true, true, true>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx)
                : launch_columns(trsm_chain_kernel<T, true, false, true>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx);
  }
  if (lower && unit)
    return launch_columns(trsm_chain_kernel<T, true, true, false>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx);
  if (lower)
    return launch_columns(trsm_chain_kernel<T, true, false, false>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx);
  if (unit)
    return launch_columns(trsm_chain_kernel<T, false, true, false>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx);
  return launch_columns(trsm_chain_kernel<T, false, false, false>, b, n, e, s, b, n, tp, ldt, bp, ldb, xp, ldx);
}

template <typename T>
static cudaError_t launch_lu_solve(int64_t n, int64_t nrhs, const void* lu,
                                   int64_t ldl, const void* B, int64_t ldb,
                                   void* X, int64_t ldx, cudaStream_t s) {
  return launch_columns(lu_solve_kernel<T>, n, nrhs, sizeof(T), s, n, nrhs,
                        static_cast<const T*>(lu), ldl, static_cast<const T*>(B),
                        ldb, static_cast<T*>(X), ldx);
}

extern "C" int repro_trsm_f32(int64_t b, int64_t n, int lower, int unit,
                              const void* t, int64_t ldt, const void* B,
                              int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_trsm<float>(b, n, lower, unit, t, ldt, B, ldb, X, ldx,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_f64(int64_t b, int64_t n, int lower, int unit,
                              const void* t, int64_t ldt, const void* B,
                              int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_trsm<double>(b, n, lower, unit, t, ldt, B, ldb, X, ldx,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_right_f32(int64_t b, int64_t m, int unit,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx,
                                    void* stream) {
  return launch_trsm_right<float>(b, m, unit, t, ldt, B, ldb, X, ldx,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_right_f64(int64_t b, int64_t m, int unit,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx,
                                    void* stream) {
  return launch_trsm_right<double>(b, m, unit, t, ldt, B, ldb, X, ldx,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_chain_f32(int64_t b, int64_t n, int lower, int unit, int right,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_chain<float>(b, n, lower, unit, right, t, ldt, B, ldb, X, ldx,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_trsm_chain_f64(int64_t b, int64_t n, int lower, int unit, int right,
                                    const void* t, int64_t ldt, const void* B,
                                    int64_t ldb, void* X, int64_t ldx, void* stream) {
  return launch_chain<double>(b, n, lower, unit, right, t, ldt, B, ldb, X, ldx,
                              static_cast<cudaStream_t>(stream));
}

// The strip kernel's plan for b x n (n right-hand sides): out = {NC, R,
// threads, dynamic shared memory bytes, blocks}.
template <typename T>
static int plan_into(int64_t b, int64_t n, int right, int64_t* out) {
  if (b <= 0 || b > MAX_B || n <= 0) return cudaErrorInvalidValue;
  const Plan p = right ? make_plan<T, true>(b, n) : make_plan<T, false>(b, n);
  out[0] = p.nc;
  out[1] = R;
  out[2] = THREADS;
  out[3] = static_cast<int64_t>(p.smem);
  out[4] = p.blocks;
  return cudaSuccess;
}

extern "C" int repro_trsm_plan_f32(int64_t b, int64_t n, int right, int64_t* out) {
  return plan_into<float>(b, n, right, out);
}

extern "C" int repro_trsm_plan_f64(int64_t b, int64_t n, int right, int64_t* out) {
  return plan_into<double>(b, n, right, out);
}

extern "C" int repro_lu_solve_f32(int64_t n, int64_t nrhs, const void* lu,
                                  int64_t ldl, const void* B, int64_t ldb,
                                  void* X, int64_t ldx, void* stream) {
  return launch_lu_solve<float>(n, nrhs, lu, ldl, B, ldb, X, ldx,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_lu_solve_f64(int64_t n, int64_t nrhs, const void* lu,
                                  int64_t ldl, const void* B, int64_t ldb,
                                  void* X, int64_t ldx, void* stream) {
  return launch_lu_solve<double>(n, nrhs, lu, ldl, B, ldb, X, ldx,
                                 static_cast<cudaStream_t>(stream));
}
