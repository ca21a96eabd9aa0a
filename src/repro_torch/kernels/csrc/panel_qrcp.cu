// QR panel with column pivoting (xLAQPS) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/panel_qrcp.py::qrcp_panel, whose body
// is repro/kernels/panels.py::_qrcp_sweep: over an r x c trailing block, for
// `steps` columns j, pick the trailing column of largest partial norm
// (first index on ties), swap it into place (B, F and the norms), bring
// column j current (B[j:, j] -= V[j:, :j] * F[j, :j]), form its Householder
// reflector, extend F = B0^T * V * T by one column
// (F[:, j] = tau * (B^T v - F * (V^T v))), complete pivot row j of every
// trailing column (B[j, i] -= V[j, :j+1] * F[i, :j+1]) and downdate the
// norms exactly (vn[i] = max(vn[i] - B[j, i]^2, 0)).  The block is updated
// in place; V (r x steps), F (c x steps, stored as F^T: steps x c), tau and
// the panel-relative int32 pivots are outputs.  Global QRCP hands it the
// whole trailing block, qrcp_local the bare panel window.
//
// What bounds it on an H100: F[:, j] needs B^T v over the whole block at
// every step.  The global path's first block is 16384 x 4096 f64, 512 MiB:
// no on-chip memory of this card holds it (the TPU kernel kept its block in
// VMEM), so each step streams it from device memory once, 128 passes of
// about 20 ms at 3.35 TB/s in all -- bound by bytes.  A qrcp_local window
// (16384 x 128, 16 MiB) fits the SMs' shared memory: there the steps are
// bound by latency, a chain of `steps` dependent cross-block reductions.
//
// Design: a cooperative grid of G blocks of QP_THREADS threads, at most one
// block an SM (G = min(ceil(r / 32), SMs); the plan in kernels/panel_qrcp.py
// sizes it).  The rows come in chunks of 32 dealt round-robin over the
// blocks (Dealt in dense.cuh: block b owns chunks b, b + G, ...), every
// column sum is one chain over the block's rows in order ("flat") and every
// row is brought current by the same lanes at every height, so a block
// padded with zero rows and tiny-norm columns (a bucketed geqp3,
// serve/bucketing.py) gives its real columns the same bits and pivots at
// every height; where a block's rows of the whole r x c block fit shared
// memory (the window: 125 rows of 128 in f64) the block loads them once,
// runs every step there and writes them back once ("resident"), else the
// same code runs on the rows in device memory ("streamed"), with the rows'
// first `steps` columns (V) copied to shared memory where they fit.  The columns
// are owned by the first `owners` blocks (column i by block i mod owners, a
// warp a column, at least QP_WARPS columns an owner): the owner computes
// F[i, :], the pivot row entries B[l, i] (l < steps) and the norm of column
// i.  The pivot rows' entries right of the diagonal so live in device
// memory, the rest of a row with its block.  Per step j, two grid barriers:
//   A. every block reduces the owners' published (norm, column) candidates
//      with a warp (the same pivot p in every block), reads F[p, :j] once,
//      swaps columns j and p of its rows >= j, brings them current (a few
//      lanes a row, then a butterfly) and publishes, in one pass over its
//      rows > j (columns over the threads, several at once where the block
//      is wide, streamed rows read past L1), the partials P_i =
//      sum_q x_q * B[q, i] for every column i (P_j is |x|^2 below row j);
//      the owner of row j publishes that row.  The owners of columns j and
//      p read what they swap in step B.
//   -- barrier --
//   B. warp 0 of each block sums P_j and reads alpha (the reflector, shared
//      through shared memory: one warp a block asks L2 for those lines);
//      meanwhile every owner loads what its warps' first columns read and
//      sums the partials of the columns l < j, which give w_l = V[j, l] +
//      P_l / denom = (V^T v)_l (the identity v^T B = B[j, :] + x^T B / denom
//      over the rows below j, so v need not be scaled before the sums); then
//      a warp a column, the next column's loads in flight: w_i, F[i, j] =
//      tau * (w_i - F[i, :j] . w[:j]), the pivot-row entry, the downdate and
//      the block's best candidate for step j + 1.  The blocks scale their
//      rows of v.
//   -- barrier --
// Every cross-block sum is a warp's: lane l takes blocks l, l+32, ... (all
// loaded before the first is added), then a fixed butterfly.  Rounding: the
// longest chain one element's value runs through in a step -- the row's
// bring-current, the block's column sum, the cross-block sum, the F
// recurrence -- is what kernels/panel_qrcp.py's plan() counts ("chain").
//
// Determinism: no atomics; every sum and comparison runs in a fixed order,
// so a block gives the same bits and the same pivots on every run, which
// keeps the qrcp_local variants and global rtm bitwise equal to mtb.  The
// route is a function of the shape.  The kernel is held to its plain
// version within 4 * chain * eps, pivots equal.
#include <type_traits>

#include "dense.cuh"

constexpr int QP_THREADS = 512, QP_WARPS = QP_THREADS / 32;
constexpr int QP_PAD = 4;            // resident rows' extra columns (bank spread)
constexpr int QP_HEAD = 512;         // shared bytes of scalars before the vectors
constexpr int QP_PREF = 4;           // F entries a lane loads ahead for its next column (l < 128)

// Shared memory a block needs besides its rows: the scalars, then F[p, :j],
// F[j, :j], the R entries of columns p and j, w and row j ([steps] each).
template <typename T>
__host__ __device__ constexpr size_t qrcp_extras(int64_t steps) {
  return (QP_HEAD + 6 * static_cast<size_t>(steps) * sizeof(T) + 15) / 16 * 16;
}

// Workspace bytes of a grid of G blocks: the owners' candidates (column,
// norm: [G] each), the column partials ([c][G]), row j and the norms ([c]).
template <typename T>
__host__ __device__ constexpr size_t qrcp_workspace(int64_t c, int64_t G) {
  return 8 * static_cast<size_t>(G) + (G + c * G + 2 * c) * sizeof(T);
}

// The block's best candidate (norm, column) of its warps (lane 0 of each
// holds the warp's in bv, bi), published for the next step's pivot.
template <typename T>
__device__ __forceinline__ void publish_best(T bv, int64_t bi, T* wv, int64_t* wi, T* cval,
                                             int64_t* cidx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < QP_WARPS; ++w)
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    cval[blockIdx.x] = bv;
    cidx[blockIdx.x] = bi;
  }
}

// What an owner warp reads of device memory for column i, loaded a column
// ahead: its lane's share of the partials of P_i, row j's entry, the norm
// and the first 32 * QP_PREF entries of F[i, :j].
template <typename T>
struct QpCol {
  T s, row, vn, f[QP_PREF];
};

// RESIDENT: the block's rows live in shared memory (row-major, ld c +
// QP_PAD) after qrcp_extras(steps) bytes.  Otherwise, where vcopy is set,
// their first `steps` columns (V below the diagonal) are kept there (ld
// steps + QP_PAD) for bringing column j current.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(QP_THREADS, 1)
qrcp_panel_kernel(int64_t r, int64_t c64, int64_t steps64, T* b, int64_t ldb, T* v, T* ft,
                  T* tau, int32_t* piv, unsigned char* wsp, int owners, int vcopy) {
  using I = std::conditional_t<RESIDENT, int, int64_t>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = static_cast<int>(c64), steps = static_cast<int>(steps64);
  const Dealt D(r, G, blk);
  const int nr = D.n;
  const bool owner = blk < owners;

  int64_t* s_p = reinterpret_cast<int64_t*>(smem_raw);         // the pivot
  T* sc = reinterpret_cast<T*>(smem_raw + 16);                 // alpha, |x|^2 below row j
  int64_t* wi = reinterpret_cast<int64_t*>(smem_raw + 64);     // [QP_WARPS]
  T* wv = reinterpret_cast<T*>(smem_raw + 64 + 8 * QP_WARPS);  // [QP_WARPS]
  T* fp = reinterpret_cast<T*>(smem_raw + QP_HEAD);            // F[p, :j] before the swap
  T* fj = fp + steps;                                          // F[j, :j] before the swap
  T* rp = fj + steps;                                          // B[:j, p] before the swap
  T* rj = rp + steps;                                          // B[:j, j] before the swap
  T* wl = rj + steps;                                          // w[:j]
  T* pr = wl + steps;                                          // row j: V[j, :j]
  const DealtRows<T, I, RESIDENT> B{
      RESIDENT ? reinterpret_cast<T*>(smem_raw + qrcp_extras<T>(steps)) : b,
      RESIDENT ? static_cast<I>(c + QP_PAD) : static_cast<I>(ldb), D};
  // V's rows of the block (columns < steps): the resident rows, their copy
  // in shared memory (vcopy), or device memory
  T* const vloc = reinterpret_cast<T*>(smem_raw + qrcp_extras<T>(steps));
  const int vld = steps + QP_PAD;
  const bool vshared = !RESIDENT && vcopy;
  auto vat = [&](int rr, int l) -> T { return vshared ? vloc[rr * vld + l] : B.at(rr, l); };
  // the column sums' rows, dealt (streamed rows read past L1)
  auto row_at = [&](int rr) -> const T* { return &B.at(rr, 0); };
  int64_t* cidx = reinterpret_cast<int64_t*>(wsp);  // [G] owners' best column
  T* cval = reinterpret_cast<T*>(wsp + 8 * static_cast<size_t>(G));  // [G] and its norm
  T* ps = cval + G;                                  // [c][G] column partials
  T* prow = ps + static_cast<int64_t>(c) * G;        // [c] row j
  T* vn = prow + c;                                  // [c] partial column norms

  if (RESIDENT) {
    for (int rr = warp; rr < nr; rr += QP_WARPS)
      for (int i = lane; i < c; i += 32) B.at(rr, i) = b[D.row(rr) * ldb + i];
    __syncthreads();
  }

  // the first norms: the blocks' column sums of squares, then the owners'
  // cross-block sums and candidates for step 0
  flat_col_sums<T, true, !RESIDENT>(row_at, [](int) { return T(0); }, 0, nr, c, ps);
  grid.sync();
  if (owner) {
    T bv = T(-1);
    int64_t bi = c;
    for (int i = blk + owners * warp; i < c; i += owners * QP_WARPS) {
      const T s = warp_sum(lane_partials(ps + static_cast<int64_t>(i) * G, 1, G, lane));
      if (lane == 0) {
        vn[i] = s;
        if (better(s, i, bv, bi)) {
          bv = s;
          bi = i;
        }
      }
    }
    publish_best(bv, bi, wv, wi, cval, cidx);
  }
  grid.sync();

  // lanes a row bringing column j current: as for a block of one chunk,
  // whatever its rows, so a row's sum does not depend on the height
  const int lg = group_lg(DEAL_ROWS, QP_THREADS);
  for (int j = 0; j < steps; ++j) {
    // A. the pivot: the owners' first largest norm (j where none is left)
    if (warp == 0) {
      T bv = T(-1);
      int64_t bi = c;
#pragma unroll
      for (int k = 0; k < LANE_PARTIALS; ++k) {
        const int g = lane + 32 * k;
        if (g < owners) {
          const T x = __ldcg(cval + g);
          const int64_t i = __ldcg(cidx + g);
          if (i < c && better(x, i, bv, bi)) {
            bv = x;
            bi = i;
          }
        }
      }
      warp_best(bv, bi);
      if (lane == 0) *s_p = bi < c ? bi : j;
    }
    __syncthreads();
    const int p = static_cast<int>(*s_p);
    const bool swap = p != j;
    if (blk == 0 && tid == 0) piv[j] = p;
    // what this step reads of the columns it swaps, before step B writes it
    for (int l = tid; l < j; l += QP_THREADS) {
      fp[l] = __ldcg(ft + static_cast<int64_t>(l) * c + p);
      if (swap && owner && p % owners == blk) {
        fj[l] = __ldcg(ft + static_cast<int64_t>(l) * c + j);
        rj[l] = __ldcg(b + l * ldb + j);
      }
      if (swap && owner && j % owners == blk) rp[l] = __ldcg(b + l * ldb + p);
    }
    __syncthreads();
    // swap columns j and p of the rows >= j; bring column j current:
    // x_q = B[q, p] - V[q, :j] . F[p, :j]
    const int lo = D.lower(j);
    group_sums<T>(
        nr - lo, lg, [](int) { return 0; }, [&](int) { return j; },
        [&](int e, int l, T acc) { return fma(vat(lo + e, l), fp[l], acc); },
        [&](int e, T dot) {
          const int rr = lo + e;
          const T x = B.at(rr, p);
          if (swap) B.at(rr, p) = B.at(rr, j);
          B.at(rr, j) = x - dot;
        });
    __syncthreads();
    if (D.owns(j)) {  // row j as the pass finds it (column j: alpha)
      const T* rowj = &B.at(D.lower(j), 0);
      for (int i0 = tid; i0 < c; i0 += 4 * QP_THREADS) {
        T x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = i0 + u * QP_THREADS < c ? rowj[i0 + u * QP_THREADS] : T(0);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u * QP_THREADS < c) prow[i0 + u * QP_THREADS] = x[u];
      }
    }
    // P_i over the rows below j (P_j = |x|^2 there)
    flat_col_sums<T, false, !RESIDENT>(row_at, [&](int rr) { return B.at(rr, j); },
                                       D.lower(j + 1), nr, c, ps);
    grid.sync();

    // B. warp 0 sums |x|^2 below row j and reads alpha; meanwhile the
    // owners load what their first columns read and sum the partials of the
    // columns l < j
    if (warp == 0) {
      const T s = warp_sum(lane_partials(ps + static_cast<int64_t>(j) * G, 1, G, lane));
      if (lane == 0) {
        sc[0] = __ldcg(prow + j);
        sc[1] = s;
      }
    }
    auto load_col = [&](int i) {
      QpCol<T> in{};
      if (i > j) {
        in.s = lane_partials(ps + static_cast<int64_t>(i) * G, 1, G, lane);
        in.row = __ldcg(prow + i);
        in.vn = __ldcg(vn + (i == p ? j : i));
      }
      if (i != j && i != p)
#pragma unroll
        for (int m = 0; m < QP_PREF; ++m) {
          const int l = lane + 32 * m;
          in.f[m] = l < j ? __ldcg(ft + static_cast<int64_t>(l) * c + i) : T(0);
        }
      return in;
    };
    const int stride = owners * QP_WARPS;
    QpCol<T> cur{};
    if (owner) {
      if (blk + owners * warp < c) cur = load_col(blk + owners * warp);
      for (int l = tid; l < j; l += QP_THREADS) pr[l] = __ldcg(prow + l);
      cross_sums(ps, j, G, [&](int l, T s) {
        if (lane == 0) wl[l] = s;
      });
    }
    __syncthreads();
    const T alpha = sc[0], s2 = sc[1];
    const T xnorm = sqrt_rn(fma(alpha, alpha, s2));
    const bool safe = xnorm > T(0);
    const T beta = alpha >= T(0) ? -xnorm : xnorm;
    const T tj = safe ? div_rn(beta - alpha, beta) : T(0);
    const T denom = safe ? alpha - beta : T(1);
    const T diag = safe ? beta : alpha;
    if (owner) {
      for (int l = tid; l < j; l += QP_THREADS) wl[l] = pr[l] + div_rn(wl[l], denom);
      __syncthreads();
      T bv = T(-1);
      int64_t bi = c;
      for (int i = blk + owners * warp; i < c; i += stride) {
        const QpCol<T> nxt = i + stride < c ? load_col(i + stride) : QpCol<T>{};
        T wi_;
        if (i < j) {
          wi_ = wl[i];
        } else if (i == j) {  // v^T (beta, v below): beta + |x|^2 / denom^2
          wi_ = diag + div_rn(div_rn(s2, denom), denom);
        } else {
          wi_ = cur.row + div_rn(warp_sum(cur.s), denom);
        }
        // F[i, :j] is column i's row before the swap: F[p, :j] for i = j,
        // F[j, :j] for i = p
        T t = T(0), q = T(0);
        auto term = [&](int l, T fl) {
          const T f = i == j ? fp[l] : (i == p ? fj[l] : fl);
          t = fma(f, wl[l], t);
          q = fma(pr[l], f, q);
          if (swap && (i == j || i == p)) {
            ft[static_cast<int64_t>(l) * c + i] = f;
            b[l * ldb + i] = i == j ? rp[l] : rj[l];
          }
        };
#pragma unroll
        for (int m = 0; m < QP_PREF; ++m)
          if (lane + 32 * m < j) term(lane + 32 * m, cur.f[m]);
        for (int l = lane + 32 * QP_PREF; l < j; l += 32)
          term(l, i == j || i == p ? T(0) : __ldcg(ft + static_cast<int64_t>(l) * c + i));
        t = warp_sum(t);
        q = warp_sum(q);
        const T fij = tj * (wi_ - t);
        if (lane == 0) {
          ft[static_cast<int64_t>(j) * c + i] = fij;
          if (i > j) {  // pivot row j, then the exact downdate
            const T x = cur.row - q - fij;
            b[j * ldb + i] = x;
            const T d = cur.vn - x * x;
            const T nv = d > T(0) ? d : T(0);
            vn[i] = nv;
            if (better(nv, i, bv, bi)) {
              bv = nv;
              bi = i;
            }
          }
        }
        cur = nxt;
      }
      publish_best(bv, bi, wv, wi, cval, cidx);
    }
    // the block's rows of v (row j keeps beta) and of V
    for (int rr = lo + tid; rr < nr; rr += QP_THREADS) {
      const int64_t qg = D.row(rr);
      T vq;
      if (qg == j) {
        vq = T(1);
        B.at(rr, j) = diag;
      } else {
        vq = div_rn(B.at(rr, j), denom);
        B.at(rr, j) = vq;
        if (vshared) vloc[rr * vld + j] = vq;
      }
      v[qg * steps + j] = vq;
    }
    if (blk == 0 && tid == 0) tau[j] = tj;
    if (j + 1 < steps) grid.sync();
  }

  if (RESIDENT) {  // rows < steps: their entries right of the diagonal are in device memory
    __syncthreads();
    for (int rr = warp; rr < nr; rr += QP_WARPS) {
      const int64_t qg = D.row(rr);
      const int hi = qg < steps ? static_cast<int>(qg) + 1 : c;
      for (int i = lane; i < hi; i += 32) b[qg * ldb + i] = B.at(rr, i);
    }
  }
}

// How an r x c block runs `steps` steps: out = {blocks, resident (1) or
// streamed (0), rows a dealt chunk (32), dynamic shared memory bytes,
// workspace bytes, threads a block, owner blocks, lanes a row (log2) of
// the bring-current, the most steps whose shared memory fits, V's rows in
// shared memory on the streamed route (1) or not (0), rows a block at
// most}.
template <typename T>
static cudaError_t qrcp_plan(int64_t r, int64_t c, int64_t steps, int64_t* out) {
  if (r <= 0 || c <= 0 || steps <= 0) return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = panel_card(&sms, &optin);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(optin), extras = qrcp_extras<T>(steps);
  out[8] = static_cast<int64_t>((limit - qrcp_extras<T>(0)) / (6 * sizeof(T)));
  if (extras > limit) return cudaErrorInvalidValue;
  const int64_t cap = sms < PANEL_MAX_BLOCKS ? sms : PANEL_MAX_BLOCKS;
  const int64_t g = dealt_grid(r, cap), rows = dealt_max_rows(r, g);
  const size_t whole = extras + static_cast<size_t>(rows * (c + QP_PAD)) * sizeof(T);
  bool resident = whole <= limit;
  if (resident)
    err = fits_one_block(qrcp_panel_kernel<T, true>, QP_THREADS, whole, &resident);
  if (err != cudaSuccess) return err;
  // streamed: V's rows in shared memory where they fit
  const size_t vrows = extras + static_cast<size_t>(rows * (steps + QP_PAD)) * sizeof(T);
  const bool vcopy = !resident && vrows <= limit;
  const size_t smem = resident ? whole : vcopy ? vrows : extras;
  bool streamed = true;
  if (!resident)
    err = fits_one_block(qrcp_panel_kernel<T, false>, QP_THREADS, smem, &streamed);
  if (err != cudaSuccess) return err;
  if (!streamed) return cudaErrorInvalidConfiguration;
  const int64_t own = (c + QP_WARPS - 1) / QP_WARPS;
  out[0] = g;
  out[1] = resident ? 1 : 0;
  out[2] = DEAL_ROWS;
  out[3] = static_cast<int64_t>(smem);
  out[4] = static_cast<int64_t>(qrcp_workspace<T>(c, g));
  out[5] = QP_THREADS;
  out[6] = own < g ? own : g;
  out[7] = group_lg(DEAL_ROWS, QP_THREADS);
  out[9] = vcopy ? 1 : 0;
  out[10] = rows;
  return cudaSuccess;
}

template <typename T>
static cudaError_t launch_qrcp(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                               void* v, void* ft, void* tau, void* piv, int grid, int resident,
                               int64_t smem, int owners, int vcopy, void* ws,
                               cudaStream_t stream) {
  if (r <= 0 || c <= 0 || steps <= 0) return cudaSuccess;
  if (grid < 1 || grid > PANEL_MAX_BLOCKS || owners < 1 || owners > grid)
    return cudaErrorInvalidValue;
  T* bp = static_cast<T*>(b);
  T* vp = static_cast<T*>(v);
  T* fp = static_cast<T*>(ft);
  T* tp = static_cast<T*>(tau);
  int32_t* pp = static_cast<int32_t*>(piv);
  unsigned char* wp = static_cast<unsigned char*>(ws);
  void* args[] = {&r, &c, &steps, &bp, &ldb, &vp, &fp, &tp, &pp, &wp, &owners, &vcopy};
  return resident ? launch_cooperative(qrcp_panel_kernel<T, true>, grid, smem, args, stream,
                                       QP_THREADS)
                  : launch_cooperative(qrcp_panel_kernel<T, false>, grid, smem, args, stream,
                                       QP_THREADS);
}

extern "C" int repro_qrcp_panel_plan_f32(int64_t r, int64_t c, int64_t steps, int64_t* out) {
  return qrcp_plan<float>(r, c, steps, out);
}

extern "C" int repro_qrcp_panel_plan_f64(int64_t r, int64_t c, int64_t steps, int64_t* out) {
  return qrcp_plan<double>(r, c, steps, out);
}

extern "C" int repro_qrcp_panel_f32(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                                    void* v, void* ft, void* tau, void* piv, int grid,
                                    int resident, int64_t smem, int owners, int vcopy,
                                    void* ws, void* stream) {
  return launch_qrcp<float>(r, c, steps, b, ldb, v, ft, tau, piv, grid, resident, smem, owners,
                            vcopy, ws, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_qrcp_panel_f64(int64_t r, int64_t c, int64_t steps, void* b, int64_t ldb,
                                    void* v, void* ft, void* tau, void* piv, int grid,
                                    int resident, int64_t smem, int owners, int vcopy,
                                    void* ws, void* stream) {
  return launch_qrcp<double>(r, c, steps, b, ldb, v, ft, tau, piv, grid, resident, smem, owners,
                             vcopy, ws, static_cast<cudaStream_t>(stream));
}
