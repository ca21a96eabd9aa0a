// Strip-blocked triangular solves on a tile of right-hand sides held in
// shared memory: the routines of the TRSM kernels (trsm.cu), of the fused
// LU panel update's U12 solve and of the fused Cholesky kernel's solve of
// the rows below its diagonal block (fused_pu.cu), which must round alike.
//
// A block owns NC right-hand sides and all b rows of them: an x tile
// xs[b][NCP] (NC columns of B, or NC rows of B staged transposed for a
// right solve).  It walks the triangle in strips of R rows, top-down for a
// lower and bottom-up for an upper one.  A strip is
//   1. the diagonal solve: NC threads, one a right-hand side, finish the
//      strip's R accumulators in registers column by column;
//   2. the rank-R update of the rows not yet solved by every thread,
//      ROWS_AT_ONCE independent accumulators at a time, 16 bytes of T a
//      load.
// The strip's columns of T (the rows not yet solved) are staged in shared
// memory by cp.async, the next step's while this one is used (two
// buffers).  Where a buffer for all those rows does not fit beside the x
// tile (b past about 600 in f64), the rows are staged in segments of `seg`
// rows: the segment that holds the diagonal block first, and each segment
// is a step of its own.  An element still takes every term of its row
// exactly once, as one fma, in solve_vector's order (dense.cuh): strip by
// strip in the solve's direction and within a strip in the same direction,
// then one div_rn.  So the result does not depend on NC, the segment size or
// which columns share a block; it is bitwise solve_vector.
#pragma once

#include <type_traits>

#include "dense.cuh"

namespace strip {

constexpr int R = 16;            // rows of a strip
constexpr int ROWS_AT_ONCE = 2;  // update rows a thread carries at once
template <typename T>
constexpr int V16 = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes

// Shared memory: two strip buffers ts[rows][RS], then the x tile
// xs[b][NCP].  RS pads a strip row by 16 bytes, so the rows that one warp
// reads at once fall on different banks; every strip row starts 16-byte
// aligned.  A buffer holds the triangle's b rows rounded up to a whole
// strip where one segment covers them (seg >= b), else a segment and one
// strip more, so the diagonal solve addresses all R rows of a ragged strip
// inside it.  NCP pads a right solve's transposed writes over the banks.
template <typename T, int NC, bool RIGHT>
struct Layout {
  static constexpr int NCP = RIGHT ? NC + 1 : NC;
  static constexpr int RS = R + V16<T>;
  __host__ __device__ static constexpr int64_t rows(int64_t b, int64_t seg) {
    return seg >= b ? (b + R - 1) / R * R : seg + R;
  }
  __host__ __device__ static constexpr size_t strip(int64_t b, int64_t seg) {
    return static_cast<size_t>(rows(b, seg)) * RS;
  }
  __host__ __device__ static constexpr size_t bytes(int64_t b, int64_t seg) {
    return (2 * strip(b, seg) + static_cast<size_t>(b) * NCP) * sizeof(T);
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

// Rows [r0, r1) of columns [lo, lo + w) of the triangle into
// ts[row - r0][0 .. R), zero past w.
template <typename T, int RS, int NT, bool VEC>
__device__ __forceinline__ void load_strip(T* ts, const T* __restrict__ t, int64_t ldt,
                                           int r0, int r1, int lo, int w) {
  if (VEC) {
    constexpr int V = V16<T>, CH = R / V;
    for (int e = threadIdx.x; e < (r1 - r0) * CH; e += NT) {
      const int rr = e / CH, cc = (e % CH) * V;
      int valid = w - cc;
      valid = valid < 0 ? 0 : (valid > V ? V : valid);
      cp_async16(ts + rr * RS + cc, valid > 0 ? t + (r0 + rr) * ldt + lo + cc : t,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = threadIdx.x; e < (r1 - r0) * R; e += NT) {
      const int rr = e / R, cc = e % R;
      const bool ok = cc < w;
      cp_async_elem<sizeof(T)>(ts + rr * RS + cc, ok ? t + (r0 + rr) * ldt + lo + cc : t,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

// The strip's diagonal rows [lo, lo + w), and r0, the first row that its
// buffer holds.
struct Strip {
  int lo, w, r0;
};

// One step of a walk: strip `st`, its rows [st.r0, r1) staged, the update
// applied to rows [u0, u1).
struct Segment {
  Strip st;
  int r1, u0, u1;
};

// Segment s of strip k of a walk over a b-row triangle: strip k (lower)
// or S-1-k (upper) of the S strips [i*R, min(b, i*R + R)).  A lower strip
// stages rows lo.. downwards, an upper one rows ..lo+w upwards, `seg` rows a
// segment, so segment 0 holds the diagonal block.  !SEG: one segment a
// strip (seg >= b), known at compile time.
template <bool LOWER, bool SEG>
__device__ __forceinline__ Segment segment_of(int b, int seg, int k, int s) {
  const int S = (b + R - 1) / R;
  const int lo = (LOWER ? k : S - 1 - k) * R, w = min(b, lo + R) - lo;
  if (!SEG) return LOWER ? Segment{Strip{lo, w, lo}, b, lo + w, b}
                         : Segment{Strip{lo, w, 0}, lo + w, 0, lo};
  if (LOWER) {
    const int r0 = lo + s * seg, r1 = min(b, r0 + seg);
    return Segment{Strip{lo, w, r0}, r1, max(r0, lo + w), r1};
  }
  const int r1 = lo + w - s * seg, r0 = max(0, r1 - seg);
  return Segment{Strip{lo, w, r0}, r1, r0, min(r1, lo)};
}

__device__ __forceinline__ int segments(bool lower, int b, int seg, int k) {
  const int S = (b + R - 1) / R;
  const int lo = (lower ? k : S - 1 - k) * R;
  const int span = lower ? b - lo : min(b, lo + R);
  return (span + seg - 1) / seg;
}

// Phase 1 of a strip, right-hand side c (one thread): the diagonal solve.
// x[p] is final once its row has its terms and division; it then gives
// every later row of the strip its term p, so each row takes its terms in
// the chain's order while the rows' FMAs are independent of each other.
// Column p of the triangle is in registers, the next column loading
// meanwhile.  Rows past a ragged strip's w compute on stale values and are
// never stored (the buffer holds whole strips, so they stay inside it).
// ncp: the x tile's row stride (NCP unless the tile is sized at run time).
template <typename T, bool LOWER, bool UNIT, int NCP, int RS>
__device__ __forceinline__ void diag_solve(T* xs, const T* ts, Strip st, int c,
                                           int ncp = NCP) {
  const T* tq = ts + (st.lo - st.r0) * RS;  // row q of the strip at tq + q * RS
  T xr[R], cols[2][R];
#pragma unroll
  for (int q = 0; q < R; ++q) xr[q] = q < st.w ? xs[(st.lo + q) * ncp + c] : T(0);
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
    if (q < st.w) xs[(st.lo + q) * ncp + c] = xr[q];
}

// Phase 2 of a strip: its terms applied to the rows [u0, u1), by thread
// (c, g) of G per column, ROWS_AT_ONCE rows at a time.  In a ragged strip
// the terms past w are fma(-0, +0, acc): T's columns there are zero-filled
// and x's are +0, so they leave every accumulator as it is.
template <typename T, bool LOWER, int NCP, int RS>
__device__ __forceinline__ void update_rows(T* xs, const T* ts, Strip st, int u0, int u1,
                                            int c, int g, int G, int ncp = NCP) {
  using Vec = typename Vec16<T>::type;
  constexpr int V = V16<T>;
  if (u0 + g >= u1) return;
  T xv[R];
#pragma unroll
  for (int p = 0; p < R; ++p) xv[p] = p < st.w ? xs[(st.lo + p) * ncp + c] : T(0);
  for (int i0 = u0 + g; i0 < u1; i0 += ROWS_AT_ONCE * G) {
    T acc[ROWS_AT_ONCE];
    const T* trow[ROWS_AT_ONCE];
#pragma unroll
    for (int a = 0; a < ROWS_AT_ONCE; ++a) {
      const int i = i0 + a * G;
      acc[a] = i < u1 ? xs[i * ncp + c] : T(0);
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
      if (i < u1) xs[i * ncp + c] = acc[a];
    }
  }
}

// A walk of the triangle: top-down over a lower or bottom-up over an upper
// one, with a unit diagonal or not.
template <bool LOWER_, bool UNIT_>
struct Walk {
  static constexpr bool LOWER = LOWER_, UNIT = UNIT_;
};

// Where the walks W0 then W1 (W1 void: W0 alone) stand: segment s of strip
// k of walk `walk`; walk == the number of walks once they are done.
struct Cursor {
  int walk, k, s;
};

template <class W0, class W1, bool SEG>
__device__ __forceinline__ Cursor advance(Cursor c, int b, int seg) {
  if constexpr (SEG) {
    bool lower = W0::LOWER;
    if constexpr (!std::is_void<W1>::value) lower = c.walk == 0 ? W0::LOWER : W1::LOWER;
    if (c.s + 1 < segments(lower, b, seg, c.k)) return Cursor{c.walk, c.k, c.s + 1};
  }
  if (c.k + 1 < (b + R - 1) / R) return Cursor{c.walk, c.k + 1, 0};
  return Cursor{c.walk + 1, 0, 0};
}

template <typename T, int RS, int NT, bool VEC, bool SEG, class W>
__device__ __forceinline__ void stage_segment(T* buf, const T* __restrict__ t, int64_t ldt,
                                              int b, int seg, int k, int s) {
  const Segment g = segment_of<W::LOWER, SEG>(b, seg, k, s);
  load_strip<T, RS, NT, VEC>(buf, t, ldt, g.st.r0, g.r1, g.st.lo, g.st.w);
  cp_async_commit();
}

template <typename T, class W, int NC, int NCP, int RS, int NT, bool SEG>
__device__ __forceinline__ void solve_segment(T* xs, const T* ts, int b, int seg, int k, int s) {
  const int tid = threadIdx.x;
  const Segment g = segment_of<W::LOWER, SEG>(b, seg, k, s);
  if (s == 0) {
    if (tid < NC) diag_solve<T, W::LOWER, W::UNIT, NCP, RS>(xs, ts, g.st, tid);
    __syncthreads();
  }
  update_rows<T, W::LOWER, NCP, RS>(xs, ts, g.st, g.u0, g.u1, tid % NC, tid / NC, NT / NC);
}

template <typename T, int RS, int NT, bool VEC, bool SEG, class W0, class W1>
__device__ __forceinline__ void stage_at(T* buf, const T* __restrict__ t, int64_t ldt, int b,
                                         int seg, Cursor c) {
  if constexpr (std::is_void<W1>::value)
    stage_segment<T, RS, NT, VEC, SEG, W0>(buf, t, ldt, b, seg, c.k, c.s);
  else if (c.walk == 0) stage_segment<T, RS, NT, VEC, SEG, W0>(buf, t, ldt, b, seg, c.k, c.s);
  else stage_segment<T, RS, NT, VEC, SEG, W1>(buf, t, ldt, b, seg, c.k, c.s);
}

template <typename T, int NC, int NCP, int RS, int NT, bool SEG, class W0, class W1>
__device__ __forceinline__ void solve_at(T* xs, const T* ts, int b, int seg, Cursor c) {
  if constexpr (std::is_void<W1>::value)
    solve_segment<T, W0, NC, NCP, RS, NT, SEG>(xs, ts, b, seg, c.k, c.s);
  else if (c.walk == 0) solve_segment<T, W0, NC, NCP, RS, NT, SEG>(xs, ts, b, seg, c.k, c.s);
  else solve_segment<T, W1, NC, NCP, RS, NT, SEG>(xs, ts, b, seg, c.k, c.s);
}

// Solve NC right-hand sides (columns c0.. of B, or rows c0.. of B when
// RIGHT) against the b x b triangle t by a block of NT threads: the walk
// W0, then W1 unless it is void, the triangle staged `seg` rows at a time
// (Layout<T, NC, RIGHT>::bytes(b, seg) bytes at smem; SEG false: seg >= b,
// one segment a strip, with the segment logic compiled out).  VEC: t and
// (left) B have 16-byte aligned rows.  X may alias B: the tile is read
// whole before it is written, and only the tile is written.
template <typename T, bool RIGHT, int NC, bool VEC, bool SEG, int NT, class W0, class W1>
__device__ void solve_tile(unsigned char* smem, int b, int seg, int64_t n, int64_t c0,
                           const T* __restrict__ t, int64_t ldt, const T* B, int64_t ldb,
                           T* X, int64_t ldx) {
  using L = Layout<T, NC, RIGHT>;
  constexpr int NCP = L::NCP, RS = L::RS, V = V16<T>;
  constexpr int WALKS = std::is_void<W1>::value ? 1 : 2;
  T* ts0 = reinterpret_cast<T*>(smem);
  T* xs = ts0 + 2 * L::strip(b, seg);
  const int tid = threadIdx.x;
  const int cols = static_cast<int>(min(static_cast<int64_t>(NC), n - c0));

  // the x tile
  if (RIGHT) {
    for (int e = tid; e < NC * b; e += NT) {
      const int cc = e / b, i = e % b;
      const bool ok = cc < cols;
      cp_async_elem<sizeof(T)>(xs + i * NCP + cc, ok ? B + (c0 + cc) * ldb + i : B,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  } else if (VEC) {
    constexpr int CH = NC / V;
    for (int e = tid; e < b * CH; e += NT) {
      const int i = e / CH, cc = (e % CH) * V;
      int valid = cols - cc;
      valid = valid < 0 ? 0 : (valid > V ? V : valid);
      cp_async16(xs + i * NCP + cc, valid > 0 ? B + i * ldb + c0 + cc : B,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = tid; e < b * NC; e += NT) {
      const int i = e / NC, cc = e % NC;
      const bool ok = cc < cols;
      cp_async_elem<sizeof(T)>(xs + i * NCP + cc, ok ? B + i * ldb + c0 + cc : B,
                               ok ? static_cast<int>(sizeof(T)) : 0);
    }
  }

  // Step i of the walks is held in buffer i % 2 while step i+1 loads into
  // the other.
  auto buffer = [&](int i) { return ts0 + (i & 1) * L::strip(b, seg); };
  Cursor cur{0, 0, 0};
  stage_at<T, RS, NT, VEC, SEG, W0, W1>(buffer(0), t, ldt, b, seg, cur);  // with the tile
  for (int step = 0;; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // step landed; the other buffer's last reader is done
    const Cursor nxt = advance<W0, W1, SEG>(cur, b, seg);
    const bool more = nxt.walk < WALKS;
    if (more) stage_at<T, RS, NT, VEC, SEG, W0, W1>(buffer(step + 1), t, ldt, b, seg, nxt);
    solve_at<T, NC, NCP, RS, NT, SEG, W0, W1>(xs, buffer(step), b, seg, cur);
    if (!more) break;
    cur = nxt;
  }
  __syncthreads();

  // write the tile back
  if (RIGHT) {
    for (int e = tid; e < cols * b; e += NT) {
      const int cc = e / b, i = e % b;
      X[(c0 + cc) * ldx + i] = xs[i * NCP + cc];
    }
  } else {
    for (int e = tid; e < b * NC; e += NT) {
      const int i = e / NC, cc = e % NC;
      if (cc < cols) X[i * ldx + c0 + cc] = xs[i * NCP + cc];
    }
  }
}

// Solve the n right-hand sides of an x tile already in shared memory,
// xs[b][ncp] (right-hand side c in column c), against the b x b triangle t
// by a block of NT threads: the walk W, the triangle staged `seg` rows a
// step (SEG: fewer than b) into two buffers at ts0, each
// Layout<T, 1, RIGHT>::strip(b, seg) values.  The steps are solve_tile's;
// thread c (and c + NT, ...) solves right-hand side c's diagonal blocks, and
// each right-hand side's update takes NT / n threads (one where n >= NT).
// Each element takes the terms it takes in solve_tile, in the same order,
// so the result is bitwise solve_vector's.  The tile stays in shared memory.
// ready(k), called by every thread before strip k is staged, returns once
// the triangle's columns of strip k may be read (a triangle still being
// written by another block).
template <typename T, bool VEC, bool SEG, int NT, class W, class Ready>
__device__ void solve_resident(T* ts0, T* xs, int ncp, int n, int b, int seg,
                               const T* __restrict__ t, int64_t ldt, Ready ready) {
  constexpr int RS = R + V16<T>;
  const size_t len = static_cast<size_t>(Layout<T, 1, true>::rows(b, seg)) * RS;
  auto buffer = [&](int i) { return ts0 + (i & 1) * len; };
  const int tid = threadIdx.x, G = n >= NT ? 1 : NT / n;
  Cursor cur{0, 0, 0};
  ready(0);
  stage_segment<T, RS, NT, VEC, SEG, W>(buffer(0), t, ldt, b, seg, 0, 0);
  for (int step = 0;; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // step landed; the other buffer's last reader is done
    const Cursor nxt = advance<W, void, SEG>(cur, b, seg);
    const bool more = nxt.walk < 1;
    if (more) {
      if (nxt.k != cur.k) ready(nxt.k);
      stage_segment<T, RS, NT, VEC, SEG, W>(buffer(step + 1), t, ldt, b, seg, nxt.k, nxt.s);
    }
    const T* ts = buffer(step);
    const Segment g = segment_of<W::LOWER, SEG>(b, seg, cur.k, cur.s);
    if (cur.s == 0) {
      for (int c = tid; c < n; c += NT) diag_solve<T, W::LOWER, W::UNIT, 0, RS>(xs, ts, g.st, c, ncp);
      __syncthreads();
    }
    if (n >= NT) {
      for (int c = tid; c < n; c += NT)
        update_rows<T, W::LOWER, 0, RS>(xs, ts, g.st, g.u0, g.u1, c, 0, 1, ncp);
    } else if (tid < G * n) {
      update_rows<T, W::LOWER, 0, RS>(xs, ts, g.st, g.u0, g.u1, tid % n, tid / n, G, ncp);
    }
    if (!more) break;
    cur = nxt;
  }
  __syncthreads();
}

// The widest triangle a block takes next to an x tile of NC columns: the
// tile and two buffers of the shortest segment (one strip) in `limit`
// bytes of shared memory.
template <typename T, int NC, bool RIGHT>
__host__ __device__ constexpr int64_t widest(size_t limit) {
  using L = Layout<T, NC, RIGHT>;
  const size_t fixed = 2 * static_cast<size_t>(2 * R) * L::RS * sizeof(T);
  return limit <= fixed ? 0 : static_cast<int64_t>((limit - fixed) / (L::NCP * sizeof(T)));
}

// The rows a segment stages for a b-row triangle beside an x tile of NC
// columns in `limit` bytes: all of them (b rounded up to whole strips)
// where that fits, else the most whole strips that fit; 0 where b is
// wider than widest().
template <typename T, int NC, bool RIGHT>
__host__ __device__ constexpr int64_t segment_rows(int64_t b, size_t limit) {
  using L = Layout<T, NC, RIGHT>;
  if (b > widest<T, NC, RIGHT>(limit)) return 0;
  const int64_t full = (b + R - 1) / R * R;
  if (L::bytes(b, full) <= limit) return full;
  const int64_t room = static_cast<int64_t>(limit / sizeof(T)) - b * L::NCP;
  return (room / (2 * L::RS) - R) / R * R;
}

}  // namespace strip
