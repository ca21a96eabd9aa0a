// Triangular solves for Hopper (sm_90a): left TRSM, right transposed TRSM
// and the fused small LU solve, all on one strip kernel.
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
// hold trsm_strip_kernel bitwise to it, the small LU solve to two chain
// launches (unit lower, then upper).
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
//   * The triangle is walked in strips of R rows (strip.cuh, which the
//     fused LU panel update's U12 solve shares), top-down for a lower and
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
//   * Any b: the x tile is sized to b, NC narrows to NC_NARROW where a
//     tile of NC_WIDE would not fit, and where the strip buffers for all b
//     rows would not fit beside the tile (b past about 600 in f64) they
//     stage the rows in segments, each a step of the walk (strip.cuh).
//     The plan gives the segment rows and the widest b the card takes
//     (about 3400 in f64, 7000 in f32); the wrappers refuse wider ones.
//   * The kernel is a template on its walks (Walk: direction and diagonal).
//     A TRSM runs one.  The small LU solve runs two on the same x tile: the
//     unit-lower strips top-down, then the upper strips bottom-up, as one
//     sequence of steps, so the first upper strip stages while the last
//     lower one is used; the tile is loaded once and X written once.
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
// kernel is column-decomposable as the look-ahead schedules need.  The LU
// solve's second walk starts from the first walk's x exactly as a second
// launch would start from its output, so it is bitwise the two chains.
#include "strip.cuh"

using strip::Layout;
using strip::Walk;

// ---------------------------------------------------------------------------
// The contract, one thread a right-hand side.
// ---------------------------------------------------------------------------
constexpr int CHAIN_NC = 32;  // right-hand sides per block

// RIGHT: the right-hand side `rhs` is row `rhs` of B (X*L^T = B, LOWER
// only); otherwise column `rhs` of B.  SMEM: x in shared memory (b rows of
// CHAIN_NC), else solved in place in X (a triangle too wide for that).
template <typename T, bool LOWER, bool UNIT, bool RIGHT, bool SMEM>
__global__ void __launch_bounds__(CHAIN_NC)
trsm_chain_kernel(int64_t b, int64_t n, const T* __restrict__ t, int64_t ldt,
                  const T* B, int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t rhs = static_cast<int64_t>(blockIdx.x) * CHAIN_NC + threadIdx.x;
  if (rhs >= n) return;
  T* x = SMEM ? reinterpret_cast<T*>(smem_raw) + threadIdx.x : X + (RIGHT ? rhs * ldx : rhs);
  const int64_t xs = SMEM ? CHAIN_NC : (RIGHT ? 1 : ldx);
  for (int64_t i = 0; i < b; ++i) x[i * xs] = RIGHT ? B[rhs * ldb + i] : B[i * ldb + rhs];
  solve_vector<T, LOWER, UNIT>(b, t, ldt, x, xs);
  if (SMEM)
    for (int64_t i = 0; i < b; ++i) {
      if (RIGHT) X[rhs * ldx + i] = x[i * xs];
      else X[i * ldx + rhs] = x[i * xs];
    }
}

static int smem_limit() {
  static const int limit = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return limit;
}

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

template <typename T, bool LOWER, bool UNIT, bool RIGHT>
static cudaError_t launch_columns(int64_t b, int64_t n, const T* t, int64_t ldt, const T* B,
                                  int64_t ldb, T* X, int64_t ldx, cudaStream_t stream) {
  if (b <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((n + CHAIN_NC - 1) / CHAIN_NC));
  const size_t smem = static_cast<size_t>(b) * CHAIN_NC * sizeof(T);
  if (smem <= static_cast<size_t>(smem_limit())) {
    auto kernel = trsm_chain_kernel<T, LOWER, UNIT, RIGHT, true>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, CHAIN_NC, smem, stream>>>(b, n, t, ldt, B, ldb, X, ldx);
  } else {
    trsm_chain_kernel<T, LOWER, UNIT, RIGHT, false><<<grid, CHAIN_NC, 0, stream>>>(
        b, n, t, ldt, B, ldb, X, ldx);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The strip kernel (the routines are strip.cuh's).
// ---------------------------------------------------------------------------
constexpr int THREADS = 256, BLOCKS_PER_SM = 2;
constexpr int NC_WIDE = 32, NC_NARROW = 8;

// Solve NC right-hand sides (columns blockIdx.x*NC.. of B, or rows when
// RIGHT) against the b x b triangle t: the walk W0, then W1 unless it is
// void, `seg` rows of the triangle staged a step (SEG: fewer than b).
template <typename T, bool RIGHT, int NC, bool VEC, bool SEG, class W0, class W1>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
trsm_strip_kernel(int b, int seg, int64_t n, const T* __restrict__ t, int64_t ldt, const T* B,
                  int64_t ldb, T* X, int64_t ldx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  strip::solve_tile<T, RIGHT, NC, VEC, SEG, THREADS, W0, W1>(
      smem_raw, b, seg, n, static_cast<int64_t>(blockIdx.x) * NC, t, ldt, B, ldb, X, ldx);
}

// How a solve of n right-hand sides of length b runs: NC, the rows a
// segment stages (b rounded up to whole strips: one segment a strip),
// blocks and shared memory; nc 0 where b is wider than the card takes.
struct Plan {
  int nc, seg, blocks;
  size_t smem;
};

template <typename T, bool RIGHT>
static Plan make_plan(int64_t b, int64_t n) {
  const size_t limit = static_cast<size_t>(smem_limit());
  // NC_NARROW while its tiles run in one wave, else NC_WIDE where its tile
  // and the whole triangle's strips fit
  const bool one_wave = (n + NC_NARROW - 1) / NC_NARROW <= BLOCKS_PER_SM * sm_count();
  const int64_t wide_seg = strip::segment_rows<T, NC_WIDE, RIGHT>(b, limit);
  if (!one_wave && wide_seg >= b) {
    return {NC_WIDE, static_cast<int>(wide_seg), static_cast<int>((n + NC_WIDE - 1) / NC_WIDE),
            Layout<T, NC_WIDE, RIGHT>::bytes(b, wide_seg)};
  }
  const int64_t seg = strip::segment_rows<T, NC_NARROW, RIGHT>(b, limit);
  if (seg <= 0) return {0, 0, 0, 0};
  return {NC_NARROW, static_cast<int>(seg), static_cast<int>((n + NC_NARROW - 1) / NC_NARROW),
          Layout<T, NC_NARROW, RIGHT>::bytes(b, seg)};
}

// The widest triangle of a left (or right) solve: the narrow tile's.
template <typename T, bool RIGHT>
static int64_t widest_rows() {
  return strip::widest<T, NC_NARROW, RIGHT>(static_cast<size_t>(smem_limit()));
}

// One instantiation's launch; its shared-memory limit is raised once, to
// the card's limit (a host call per launch would cost as much as a narrow
// solve).
template <typename T, bool RIGHT, int NC, bool VEC, bool SEG, class W0, class W1>
static cudaError_t launch_strip(const Plan& p, int64_t b, int64_t n, const T* t, int64_t ldt,
                                const T* B, int64_t ldb, T* X, int64_t ldx, cudaStream_t s) {
  auto kernel = trsm_strip_kernel<T, RIGHT, NC, VEC, SEG, W0, W1>;
  static const cudaError_t raised = allow_smem(kernel, static_cast<size_t>(smem_limit()));
  if (raised != cudaSuccess) return raised;
  kernel<<<p.blocks, THREADS, p.smem, s>>>(static_cast<int>(b), p.seg, n, t, ldt, B, ldb, X, ldx);
  return cudaGetLastError();
}

template <typename T, bool RIGHT, class W0, class W1 = void>
static cudaError_t run_strip(int64_t b, int64_t n, const void* t, int64_t ldt, const void* B,
                             int64_t ldb, void* X, int64_t ldx, cudaStream_t s) {
  if (b <= 0 || n <= 0) return cudaSuccess;
  const Plan p = make_plan<T, RIGHT>(b, n);
  if (p.nc == 0) return cudaErrorInvalidValue;
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  const bool vec = aligned16(t, ldt, sizeof(T)) && (RIGHT || aligned16(B, ldb, sizeof(T)));
  // the wide tile never stages in segments (make_plan)
  if (p.nc == NC_WIDE)
    return vec ? launch_strip<T, RIGHT, NC_WIDE, true, false, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s)
               : launch_strip<T, RIGHT, NC_WIDE, false, false, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s);
  if (p.seg < b)
    return vec ? launch_strip<T, RIGHT, NC_NARROW, true, true, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s)
               : launch_strip<T, RIGHT, NC_NARROW, false, true, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s);
  return vec ? launch_strip<T, RIGHT, NC_NARROW, true, false, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s)
             : launch_strip<T, RIGHT, NC_NARROW, false, false, W0, W1>(p, b, n, tp, ldt, bp, ldb, xp, ldx, s);
}

template <typename T>
static cudaError_t launch_trsm(int64_t b, int64_t n, int lower, int unit, const void* t,
                               int64_t ldt, const void* B, int64_t ldb, void* X, int64_t ldx,
                               cudaStream_t s) {
  if (lower && unit) return run_strip<T, false, Walk<true, true>>(b, n, t, ldt, B, ldb, X, ldx, s);
  if (lower) return run_strip<T, false, Walk<true, false>>(b, n, t, ldt, B, ldb, X, ldx, s);
  if (unit) return run_strip<T, false, Walk<false, true>>(b, n, t, ldt, B, ldb, X, ldx, s);
  return run_strip<T, false, Walk<false, false>>(b, n, t, ldt, B, ldb, X, ldx, s);
}

// X*L^T = B for B with m rows: m right-hand sides of length b.
template <typename T>
static cudaError_t launch_trsm_right(int64_t b, int64_t m, int unit, const void* t, int64_t ldt,
                                     const void* B, int64_t ldb, void* X, int64_t ldx,
                                     cudaStream_t s) {
  if (unit) return run_strip<T, true, Walk<true, true>>(b, m, t, ldt, B, ldb, X, ldx, s);
  return run_strip<T, true, Walk<true, false>>(b, m, t, ldt, B, ldb, X, ldx, s);
}

template <typename T>
static cudaError_t launch_chain(int64_t b, int64_t n, int lower, int unit, int right,
                                const void* t, int64_t ldt, const void* B, int64_t ldb,
                                void* X, int64_t ldx, cudaStream_t s) {
  const T* tp = static_cast<const T*>(t);
  const T* bp = static_cast<const T*>(B);
  T* xp = static_cast<T*>(X);
  if (right) {
    if (!lower) return cudaErrorInvalidValue;
    return unit ? launch_columns<T, true, true, true>(b, n, tp, ldt, bp, ldb, xp, ldx, s)
                : launch_columns<T, true, false, true>(b, n, tp, ldt, bp, ldb, xp, ldx, s);
  }
  if (lower && unit) return launch_columns<T, true, true, false>(b, n, tp, ldt, bp, ldb, xp, ldx, s);
  if (lower) return launch_columns<T, true, false, false>(b, n, tp, ldt, bp, ldb, xp, ldx, s);
  if (unit) return launch_columns<T, false, true, false>(b, n, tp, ldt, bp, ldb, xp, ldx, s);
  return launch_columns<T, false, false, false>(b, n, tp, ldt, bp, ldb, xp, ldx, s);
}

// L*U*X = B from the packed LU: the unit-lower walk, then the upper one.
template <typename T>
static cudaError_t launch_lu_solve(int64_t n, int64_t nrhs, const void* lu,
                                   int64_t ldl, const void* B, int64_t ldb,
                                   void* X, int64_t ldx, cudaStream_t s) {
  return run_strip<T, false, Walk<true, true>, Walk<false, false>>(n, nrhs, lu, ldl, B, ldb, X,
                                                                    ldx, s);
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
// threads, dynamic shared memory bytes, blocks, rows a segment stages, the
// widest b the card takes}.  Returns cudaErrorInvalidValue, with out[6]
// set, where b is wider than that.
template <typename T>
static int plan_into(int64_t b, int64_t n, int right, int64_t* out) {
  if (b <= 0 || n <= 0) return cudaErrorInvalidValue;
  if (smem_limit() <= 0 || sm_count() <= 0) return cudaErrorNoDevice;
  out[6] = right ? widest_rows<T, true>() : widest_rows<T, false>();
  const Plan p = right ? make_plan<T, true>(b, n) : make_plan<T, false>(b, n);
  if (p.nc == 0) return cudaErrorInvalidValue;
  out[0] = p.nc;
  out[1] = strip::R;
  out[2] = THREADS;
  out[3] = static_cast<int64_t>(p.smem);
  out[4] = p.blocks;
  out[5] = p.seg;
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
