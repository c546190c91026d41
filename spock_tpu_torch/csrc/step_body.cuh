// The node-per-thread sweep body, laid out for Hopper: one Chambolle-Pock
// sweep of one lane, with the metric image of its residual and, at a
// candidate, of the direction, run by one 512-thread block.  The node
// instances of the SuperMann step kernels (sp_step.cu) and of the CP sweep
// kernels (cp_sweep.cu) run it, for problems whose nx, nu, ny + 2 d and
// polytope rows are at most 32 (node_fits); the metric kernel
// (metric_apply.cu) runs its metric pass, metric_node, alone.  It
// computes what sweep_body.cuh's sweep_lane computes (costs uniform or per
// node; risk data uniform or per node; with or without polytope rows), in
// fewer and cheaper passes:
//
//   * L and L' by node.  One thread owns a node and computes every entry of
//     it: the primal column of the node, the dual column of its edge from the
//     parent, and its non-leaf or leaf dual columns.  The input column of a
//     matrix block (a parent's x, the sum of the children's qx, a leaf's x)
//     is read once into registers, and every output row is a dot product
//     with a matrix row.  Uniform cost matrices are staged in shared memory
//     once per block (sqrtQ, sqrtR, sqrtQN and their transposes, rows padded
//     to 4 values and read as 16-byte vectors).  Per-node ones are read from
//     their node-minor copies in device memory ([rows, cols, nodes], made
//     once per problem by the wrapper): the threads of a warp own
//     consecutive nodes, so each load of a warp reads 32 consecutive values
//     and one copy serves a matrix and its transpose.  L' cannot sum the
//     children's columns first when each child has its own matrix: the
//     thread accumulates M_k' a_k child by child, one input value against a
//     matrix row at a time, into a register column.  Stage, parent and child
//     indices are worked out once per node.  A composed input (z + tau d,
//     c - o) is formed once per element as it is loaded.
//   * w1 = c - gamma L' c_v and the S2 projector in one pass: the thread of
//     a non-leaf node forms its own y and its children's s and tau itself,
//     so the projector needs no barrier and no second read.  The dual half,
//     v1 = c_v + sigma L (2 wbar - c_z), projects each second-order cone in
//     the thread that formed its column.
//   * M r and M d in one traversal: the thread of a node computes the node's
//     entries of M r (stored when asked: each entry by the one thread that
//     owns it) and then of M d, with the node's indices worked out once and
//     two accumulators.  (Sharing each matrix-row load between the two
//     products needs two register columns, which spill.)
//   * Loads batched: a thread loads the values of 8 rows of a node before
//     it uses them, so it waits for device memory once per 8 rows; a lane
//     alone on the card is bound by these waits and by the Riccati stages,
//     not by bandwidth.
//   * The Riccati sweeps by node.  A group of G threads (G = 4 .. 32 by the
//     stage's width) carries one node's whole backward chain, w = u1 -
//     sum_k B_k' q_k, dvec = Rtinv w, inner_k = P_k B_k dvec + q_k, q = ...,
//     exchanging its vectors in shared memory with __syncwarp, so a stage
//     costs two block barriers (its matrices' staging and its end) instead
//     of four.  The stage's K, Rtinv, ABK, PB (and B) sit in shared memory;
//     the costates of a stage and its children sit in shared memory when
//     they fit (device memory otherwise), dvec goes to device memory for the
//     forward rollout.  (The Riccati factors do not depend on the costs.)
//
// Every reduction is a fixed-order block reduction, so a launch is
// deterministic.  No tensor cores: float32 stays true float32.

#pragma once

#include "sweep_body.cuh"

// Whether the body reads per-node cost matrices.  sp_step.cu, whose class
// has uniform costs, sets it to 0 before including this file, which leaves
// its code free of the per-node paths.
#ifndef SPOCK_NODE_COSTS
#define SPOCK_NODE_COSTS 1
#endif

namespace spock {

constexpr bool kNodeCosts = SPOCK_NODE_COSTS != 0;

// nx, nu, ny + 2 d, and the polytope rows of a node are at most this: a
// column fits in registers, and a Riccati node's rows in one warp.
constexpr int kMaxDim = 32;
constexpr int kMaxRed = 9;             // values of one block reduction
// dynamic shared memory per block: the 227 KB a block may use, less 4 KB
// for the kernels' static shared memory
constexpr int kSmemLimit = 232448 - 4096;
constexpr int kMaxGroups = kThreads / 4;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Offsets (in values of T) of the dynamic shared memory of one block.
struct StepSmem {
  int ldx, ldu, ldk;               // padded row lengths: nx, nu, ny + 2 d
  int QT, Q, RT, R, QNT, QN;       // sqrtQ', sqrtQ, sqrtR', sqrtR, ...
  int Bt, Bf;                      // B_k' [d, nu, ldx] and B_k [d, nx, ldu]
  int ker;                         // the uniform S2 projector [mker, ldk]
  int Rti, PB, ABKt, Kt;           // one backward stage
  int Kf, ABKf;                    // one forward stage (the same region)
  int xch, xch_node, cmax;         // Riccati exchange: cmax groups
  int work;                        // costates or reduction scratch
  int qhalf;                       // offset of the second costate half
  int qsize;                       // values of a lane's costate buffer
  int q_shared;                    // 1: costates in shared memory
  int bytes;
};

// Whether the node body takes geometry g: a node's columns fit in registers
// (nx, nu, the S2 projector's ny + 2 d and the polytope rows of a node).
inline bool node_fits(const Geo& g) {
  return g.nx <= kMaxDim && g.nu <= kMaxDim && g.ny + 2 * g.d <= kMaxDim &&
         g.nc <= kMaxDim && g.ncL <= kMaxDim;
}

// Plans the first region of a block's shared memory: the uniform cost
// matrices and their transposes (sqrtQ, sqrtR, sqrtQN; per-node ones are not
// staged), rows padded to ldx or ldu values.  Returns its values.
inline int plan_cost_mats(StepSmem& s, const Geo& g, const int* dims) {
  const int ldx = pad4(g.nx), ldu = pad4(g.nu);
  const bool q = dims[DIM_PN_Q] == 0, r = dims[DIM_PN_R] == 0;
  const bool qn = dims[DIM_PN_QN] == 0;
  s.ldx = ldx;
  s.ldu = ldu;
  int o = 0;
  auto take = [&](int n) {
    const int at = o;
    o += pad4(n);
    return at;
  };
  s.QT = take(q ? g.nx * ldx : 0);
  s.Q = take(q ? g.nx * ldx : 0);
  s.RT = take(r ? g.nu * ldu : 0);
  s.R = take(r ? g.nu * ldu : 0);
  s.QNT = take(qn ? g.nx * ldx : 0);
  s.QN = take(qn ? g.nx * ldx : 0);
  return o;
}

// The shared memory of a metric launch (metric_apply.cu): the cost matrices
// of plan_cost_mats alone, for values of ``vsize`` bytes; the other offsets
// stay 0.  Returns false where the node body does not take g.
inline bool metric_plan(StepSmem& s, const Geo& g, const int* dims,
                        int vsize) {
  s = StepSmem{};
  s.bytes = plan_cost_mats(s, g, dims) * vsize;
  return node_fits(g) && s.bytes <= kSmemLimit;
}

// Plans the shared memory of a block for geometry g, the per-node flags of
// dims (uniform matrices are staged, per-node ones are not) and values of
// ``vsize`` bytes, with ``tail`` bytes more at the end (the step kernels'
// phase clock); returns false if no layout fits.
inline bool plan_smem(StepSmem& s, const Geo& g, const int* dims,
                      int vsize, int tail = 0) {
  const int mker = g.ny + 2 * g.d, ldk = pad4(mker);
  const bool ker = dims[DIM_PN_RISK] == 0;
  s.ldk = ldk;
  int o = plan_cost_mats(s, g, dims);
  const int ldx = s.ldx, ldu = s.ldu;
  auto take = [&](int n) {
    const int at = o;
    o += pad4(n);
    return at;
  };
  s.Bt = take(g.d * g.nu * ldx);
  s.Bf = take(g.d * g.nx * ldu);
  s.ker = take(ker ? mker * ldk : 0);
  int b = o;
  s.Rti = b;
  b += g.nu * ldu;
  s.PB = b;
  b += g.d * g.nx * ldu;
  s.ABKt = b;
  b += g.d * g.nx * ldx;
  s.Kt = b;
  b += g.nx * ldu;
  int f = o;
  s.Kf = f;
  f += g.nu * ldx;
  s.ABKf = f;
  f += g.d * g.nx * ldx;
  o = pad4(b > f ? b : f);
  s.xch = o;
  s.xch_node = 3 * ldu + g.d * ldx;
  s.qhalf = g.n_lf * ldx;
  s.qsize = (g.n_lf + g.mmax) * ldx;
  const int red = kMaxRed * kThreads;
  for (int q_shared = 1; q_shared >= 0; --q_shared) {
    for (int cmax = kMaxGroups; cmax >= (q_shared ? 16 : 1); cmax /= 2) {
      const int work = q_shared && s.qsize > red ? s.qsize : red;
      const long total = o + static_cast<long>(cmax) * s.xch_node + work;
      if (total * vsize + tail <= kSmemLimit) {
        s.cmax = cmax;
        s.work = o + cmax * s.xch_node;
        s.q_shared = q_shared;
        s.bytes = static_cast<int>(total * vsize + tail);
        return true;
      }
    }
  }
  return false;
}

// A lane of a pair: its 19 blocks' base pointers (null for an absent one).
template <typename T>
struct Lane {
  T* p[kPairBlocks];
};

// Called by the first kPairBlocks threads; the caller syncs.
template <typename T>
__device__ __forceinline__ void make_lane(Lane<T>& l, const Pair<T>& pr,
                                          int64_t lane, const Geo& g) {
  const int b = threadIdx.x;
  if (b < kPairBlocks) {
    l.p[b] = pr.p[b] ? pr.p[b] + lane * g.lsz[b] : nullptr;
  }
}

// (z, v) + tau (dz, dv) when DIR, (z, v) otherwise.
template <typename T, bool DIR>
struct LaneIn {
  const Lane<T>* z;
  const Lane<T>* d;
  T tau;
  __device__ __forceinline__ T operator()(int b, int i) const {
    if constexpr (DIR) {
      return z->p[b][i] + tau * d->p[b][i];
    } else {
      return z->p[b][i];
    }
  }
};

template <typename T>
struct LaneAt {
  const Lane<T>* l;
  __device__ __forceinline__ T operator()(int b, int i) const {
    return l->p[b][i];
  }
};

// c - o: the fixed-point residual.
template <typename T, class C>
struct LaneRes {
  C c;
  const Lane<T>* o;
  __device__ __forceinline__ T operator()(int b, int i) const {
    return c(b, i) - o->p[b][i];
  }
};

// 2 o - c: what the dual half applies L to.
template <typename T, class C>
struct LaneRefl {
  C c;
  const Lane<T>* o;
  __device__ __forceinline__ T operator()(int b, int i) const {
    return T(2) * o->p[b][i] - c(b, i);
  }
};

__device__ __forceinline__ void load4(const float* p, float& a, float& b,
                                      float& c, float& d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x;
  b = v.y;
  c = v.z;
  d = v.w;
}

__device__ __forceinline__ void load4(const double* p, double& a, double& b,
                                      double& c, double& d) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  a = v0.x;
  b = v0.y;
  c = v1.x;
  d = v1.y;
}

// row . w over ld values (a multiple of 4): row 16-byte aligned in shared
// memory, zero past the matrix's width; w zero past the column's height.
template <typename T>
__device__ __forceinline__ T dot_v(const T* row, const T (&w)[kMaxDim],
                                   int ld) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < kMaxDim; q += 4) {
    if (q < ld) {
      T m0, m1, m2, m3;
      load4(row + q, m0, m1, m2, m3);
      acc += m0 * w[q];
      acc += m1 * w[q + 1];
      acc += m2 * w[q + 2];
      acc += m3 * w[q + 3];
    }
  }
  return acc;
}

// row . w over n values, row anywhere (the per-node S2 projector).
template <typename T>
__device__ __forceinline__ T dot_g(const T* row, const T (&w)[kMaxDim],
                                   int n) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < kMaxDim; ++q) {
    if (q < n) acc += row[q] * w[q];
  }
  return acc;
}

// a . b over ld values (a multiple of 4), both 16-byte aligned and zero
// past their length (the Riccati's vectors).
template <typename T>
__device__ __forceinline__ T dot_s(const T* a, const T* b, int ld) {
  // four independent chains: a node's Riccati chain waits on these sums
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  for (int q = 0; q < ld; q += 4) {
    T a0, a1, a2, a3, b0, b1, b2, b3;
    load4(a + q, a0, a1, a2, a3);
    load4(b + q, b0, b1, b2, b3);
    s0 += a0 * b0;
    s1 += a1 * b1;
    s2 += a2 * b2;
    s3 += a3 * b3;
  }
  return (s0 + s1) + (s2 + s3);
}

// w[q] = the sum over a node's d children k of at(q, k) for q < h, 0 past
// h: one child at a time, so the h loads of a child are in flight
// together.
template <typename T, class At>
__device__ __forceinline__ void child_column(T (&w)[kMaxDim], int h, int d,
                                             At&& at) {
#pragma unroll
  for (int q = 0; q < kMaxDim; ++q) w[q] = q < h ? at(q, 0) : T(0);
  for (int k = 1; k < d; ++k) {
#pragma unroll
    for (int q = 0; q < kMaxDim; ++q) {
      if (q < h) w[q] += at(q, k);
    }
  }
}

// Sums (the first nsum values) and NaN-keeping maxima (the rest) of v over
// the block, in a fixed tree order; every thread gets the results.
template <typename T, int K>
__device__ void block_reduce(T (&v)[K], int nsum, T* sh) {
  static_assert(K <= kMaxRed, "reduction scratch");
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k * kThreads + tid] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T* a = sh + k * kThreads + tid;
        a[0] = k < nsum ? a[0] + a[s] : absmax(a[0], a[s]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = sh[k * kThreads];
  __syncthreads();
}

// The constants of a step launch: the sweep's and the shared-memory plan.
template <typename T>
struct StepConsts {
  SweepConsts<T> k;
  StepSmem s;
};

// Stages the uniform cost matrices and their transposes of plan_cost_mats
// (per-node ones have node-minor copies), thread tid of nthreads; the caller
// syncs.
template <typename T>
__device__ __forceinline__ void stage_cost_mats(const StepConsts<T>& X, T* sm,
                                                int tid, int nthreads) {
  const Geo& g = X.k.g;
  const StepSmem& s = X.s;
  const LMats<T>& m = X.k.lm;
  const int nx = g.nx, nu = g.nu, ldx = s.ldx, ldu = s.ldu;
  const bool q = m.sq == 0, qn = m.sqn == 0;
  for (int e = tid; e < nx * ldx; e += nthreads) {
    const int r = e / ldx, c = e % ldx;
    const bool in = c < nx;
    if (q) {
      sm[s.Q + e] = in ? m.sqrtQ[r * nx + c] : T(0);
      sm[s.QT + e] = in ? m.sqrtQ[c * nx + r] : T(0);
    }
    if (qn) {
      sm[s.QN + e] = in ? m.sqrtQN[r * nx + c] : T(0);
      sm[s.QNT + e] = in ? m.sqrtQN[c * nx + r] : T(0);
    }
  }
  for (int e = tid; e < nu * ldu && m.sr == 0; e += nthreads) {
    const int r = e / ldu, c = e % ldu;
    const bool in = c < nu;
    sm[s.R + e] = in ? m.sqrtR[r * nu + c] : T(0);
    sm[s.RT + e] = in ? m.sqrtR[c * nu + r] : T(0);
  }
}

// Stages the matrices that stay for the whole launch; the caller syncs.
template <typename T>
__device__ void stage_consts(const StepConsts<T>& X, T* sm) {
  const Geo& g = X.k.g;
  const StepSmem& s = X.s;
  const int tid = threadIdx.x;
  const int nx = g.nx, nu = g.nu, ldx = s.ldx, ldu = s.ldu;
  stage_cost_mats(X, sm, tid, kThreads);
  // B [d, nx, nu]: B_k' rows for the backward sweep, B_k rows forward
  for (int e = tid; e < g.d * nu * ldx; e += kThreads) {
    const int kc = e / ldx, r = e % ldx;
    const int k = kc / nu, c = kc % nu;
    sm[s.Bt + e] = r < nx ? X.k.Bm[(k * nx + r) * nu + c] : T(0);
  }
  for (int e = tid; e < g.d * nx * ldu; e += kThreads) {
    const int kr = e / ldu, c = e % ldu;
    sm[s.Bf + e] = c < nu ? X.k.Bm[kr * nu + c] : T(0);
  }
  if (X.k.sker == 0) {
    const int mker = g.ny + 2 * g.d;
    for (int e = tid; e < mker * s.ldk; e += kThreads) {
      const int a = e / s.ldk, b = e % s.ldk;
      sm[s.ker + e] = b < mker ? X.k.ker[a * mker + b] : T(0);
    }
  }
  // the Riccati exchange: its padding stays zero
  for (int e = tid; e < s.cmax * s.xch_node; e += kThreads) {
    sm[s.xch + e] = T(0);
  }
}

// The nodes a stage of m nodes works on per round, and the threads per node.
__device__ __forceinline__ void stage_groups(int m, int cmax, int& C,
                                             int& G) {
  C = m < cmax ? m : cmax;
  G = 32;
  while (G > 1 && C * G > kThreads) G >>= 1;
}

// The costate (or state) buffer of stage t: the leaves' parity in the first
// half (room for n_lf nodes), the other stages' in the second (mmax).
__device__ __forceinline__ int qhalf_of(const Geo& g, const StepSmem& s,
                                        int t) {
  return ((g.N - 1 - t) & 1) ? s.qhalf : 0;
}

// Polytope rows: sum_q G[q, r] v(W, q cols + col) (L' side).
template <int W, typename T, class V>
__device__ __forceinline__ T poly_lt(const T* Gm, int rows, int a, int r,
                                     int cols, int col, const V& v) {
  T acc = T(0);
  for (int q = 0; q < rows; ++q) acc += Gm[q * a + r] * v(W, q * cols + col);
  return acc;
}

template <typename T>
struct Two {
  T a, b;
};

template <typename T>
struct Three {
  T a, b, c;
};

// Calls use(r, load(r)) for r in [0, n), in order, loading BATCH rows
// ahead: the loads of a batch are independent and in flight together, so a
// thread waits for device memory once per batch instead of once per row.
// The sweeps batch kBatch rows; the metric kernel, whose registers bound
// it, fewer (metric_apply.cu).
constexpr int kBatch = 8;

template <int BATCH = kBatch, class Load, class Use>
__device__ __forceinline__ void rows(int n, Load&& load, Use&& use) {
  using V = decltype(load(0));
  for (int r0 = 0; r0 < n; r0 += BATCH) {
    V v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (r0 + k < n) v[k] = load(r0 + k);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (r0 + k < n) use(r0 + k, v[k]);
    }
  }
}

// rows() with every row index a compile-time constant (the loop unrolled
// over kMaxDim), so that ``use`` may index a register column by it.
template <int BATCH = kBatch, class Load, class Use>
__device__ __forceinline__ void rows_all(int n, Load&& load, Use&& use) {
  using V = decltype(load(0));
#pragma unroll
  for (int r0 = 0; r0 < kMaxDim; r0 += BATCH) {
    if (r0 < n) {
      V v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (r0 + k < n) v[k] = load(r0 + k);
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (r0 + k < n) use(r0 + k, v[k]);
      }
    }
  }
}

// sum_q p[q cs] w[q] over n values: a row of a node-minor copy in device
// memory (read-only, through the L2 and the read-only cache).
template <typename T>
__device__ __forceinline__ T dot_nm(const T* p, int cs, const T (&w)[kMaxDim],
                                    int n) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < kMaxDim; ++q) {
    if (q < n) acc += __ldg(p + q * cs) * w[q];
  }
  return acc;
}

// The rows of one node's matrix of L: entry (r, q) at p[r rs + q cs].
// Uniform: rows staged in shared memory (cs = 1, rows of rs values, a
// multiple of 4, 16-byte aligned and zero-padded); per node: a node's
// entries in its node-minor copy.
template <typename T>
struct MatRows {
  const T* p;
  int rs, cs;
  bool node;
};

// The rows of the h x h matrix of column j of a block whose matrix is
// staged at ``at`` (row length ld) when uniform, or is per node with the
// node-minor copy nm [h, h, nn]; with ``adj`` the rows of its transpose.
template <typename T>
__device__ __forceinline__ MatRows<T> mat_rows(const T* at, int ld,
                                               const T* nm, int h, int nn,
                                               int j, bool adj) {
  if constexpr (kNodeCosts) {
    if (nm != nullptr) {
      return adj ? MatRows<T>{nm + j, nn, h * nn, true}
                 : MatRows<T>{nm + j, h * nn, nn, true};
    }
  }
  return MatRows<T>{at, ld, 1, false};
}

// Calls use(r, load(r), t) for r < h in order, with t row r of m against
// the register column w of n values.  The choice between staged and
// node-minor rows is made once, outside the loop over the rows.
template <int BATCH = kBatch, typename T, class Load, class Use>
__device__ __forceinline__ void mat_rows_dot(const MatRows<T>& m,
                                             const T (&w)[kMaxDim], int n,
                                             int h, Load&& load, Use&& use) {
  using V = decltype(load(0));
  if constexpr (kNodeCosts) {
    if (m.node) {
      rows<BATCH>(h, load, [&](int r, const V& v) {
        use(r, v, dot_nm(m.p + r * m.rs, m.cs, w, n));
      });
      return;
    }
  }
  rows<BATCH>(h, load, [&](int r, const V& v) {
    use(r, v, dot_v(m.p + r * m.rs, w, m.rs));
  });
}

// w[q] = sum over the d children k of a non-leaf node (columns c0 + k m of
// a per-node block) of (M_k' a_k)[q] for q < h, 0 past h; M_k from the
// node-minor copy nm [h, h, nn], a_k[p] = at(p, k).  One input value at a
// time against a row of M_k, so the h loads of a row are in flight together.
template <typename T, class At>
__device__ __forceinline__ void child_product(T (&w)[kMaxDim], const T* nm,
                                              int nn, int h, int d, int c0,
                                              int m, At&& at) {
#pragma unroll
  for (int q = 0; q < kMaxDim; ++q) w[q] = T(0);
  for (int k = 0; k < d; ++k) {
    const T* mk = nm + c0 + k * m;
    for (int p = 0; p < h; ++p) {
      const T a = at(p, k);
      const T* row = mk + p * h * nn;
#pragma unroll
      for (int q = 0; q < kMaxDim; ++q) {
        if (q < h) w[q] += __ldg(row + q * nn) * a;
      }
    }
  }
}

// Calls use(r, load(r), t) for r < h in order, with t row r of
// sum_k M_k' a_k over the d children k of a non-leaf node: the child sums
// of L' (a_k[q] = at(q, k), the child's column c0 + k m of a dual block).
// Uniform M: M' (sum_k a_k), with the rows of M' staged at mt (row length
// ld).  Per-node M: child by child from the node-minor copy nm [h, h, nn].
template <int BATCH = kBatch, typename T, class At, class Load, class Use>
__device__ __forceinline__ void child_rows(const T* mt, int ld, const T* nm,
                                           int nn, int h, int d, int c0,
                                           int m, At&& at, Load&& load,
                                           Use&& use) {
  using V = decltype(load(0));
  T w[kMaxDim];
  if constexpr (kNodeCosts) {
    if (nm != nullptr) {
      child_product(w, nm, nn, h, d, c0, m, at);
      rows_all<BATCH>(h, load, [&](int r, const V& v) { use(r, v, w[r]); });
      return;
    }
  }
  child_column(w, h, d, at);
  rows<BATCH>(h, load,
       [&](int r, const V& v) { use(r, v, dot_v(mt + r * ld, w, ld)); });
}

// The residual of a metric pass that accumulates nothing (M x alone, in
// metric_apply.cu): it reads no memory, and metric_node then skips its sums
// and maxima.
template <typename T>
struct NoResidual {
  __device__ __forceinline__ T operator()(int, int) const { return T(0); }
};

template <class RA>
constexpr bool kAccumulates = true;
template <typename T>
constexpr bool kAccumulates<NoResidual<T>> = false;

// The metric image of x at the entries node nd owns, accumulated against
// the residual rr: sum += rr . (M x), mz / mv = max |M x| over its primal /
// dual entries (not with a NoResidual rr); each entry is also written to
// the lane mo unless it is null.  An entry of M x is val = x - scale * (L or
// L' x).  Row loads are batched BATCH at a time (rows()).
template <typename T, class XA, class RA, int BATCH = kBatch>
__device__ void metric_node(const StepConsts<T>& X, const T* sm, int nd,
                            const XA& x, const RA& rr, const Lane<T>* mo,
                            T& sum, T& mz, T& mv) {
  const Geo& g = X.k.g;
  const StepSmem& s = X.s;
  const LMats<T>& lm = X.k.lm;
  const T gamma = X.k.gamma, sigma = X.k.sigma;
  const int nx = g.nx, nu = g.nu, n = g.n, n_nl = g.n_nl, n_nr = g.n_nr;
  const int n_lf = g.n_lf, ldx = s.ldx, ldu = s.ldu;
  T* const* out = mo ? mo->p : nullptr;
  auto acc = [&](int b, int i, T xv, T rv, T l, T scale, T& m) {
    const T val = xv - scale * l;
    if constexpr (kAccumulates<RA>) {
      sum += rv * val;
      m = absmax(m, val);
    }
    if (out) out[b][i] = val;
  };
  T w[kMaxDim];
  // (x, rr, and a third value) of rows of two blocks
  auto three = [&](int b0, int i0, int b1, int i1) {
    return Three<T>{x(b0, i0), rr(b0, i0), x(b1, i1)};
  };
  if (nd < n_nl) {
    const int t = stage_of(g, nd);
    const int c0 = child_of(g, nd, t, 0) - 1;
    const int mt = g.off[t + 1] - g.off[t];
    // x: cx + sum_k sqrtQ_k' qx_k + Gx' pnl
    child_rows<BATCH>(
        sm + s.QT, ldx, X.k.nmQ, n_nr, nx, g.d, c0, mt,
        [&](int q, int k) { return x(DQX, q * n_nr + c0 + k * mt); },
        [&](int r) { return three(PX, r * n + nd, DCX, r * n_nl + nd); },
        [&](int r, const Three<T>& v, T ct) {
          const T lt =
              v.c + ct + poly_lt<DPNL>(lm.Gx, g.nc, nx, r, n_nl, nd, x);
          acc(PX, r * n + nd, v.a, v.b, lt, gamma, mz);
        });
    child_rows<BATCH>(
        sm + s.RT, ldu, X.k.nmR, n_nr, nu, g.d, c0, mt,
        [&](int q, int k) { return x(DRU, q * n_nr + c0 + k * mt); },
        [&](int r) { return three(PU, r * n_nl + nd, DCU, r * n_nl + nd); },
        [&](int r, const Three<T>& v, T ct) {
          const T lt =
              v.c + ct + poly_lt<DPNL>(lm.Gu, g.nc, nu, r, n_nl, nd, x);
          acc(PU, r * n_nl + nd, v.a, v.b, lt, gamma, mz);
        });
    const T sby = x(DSBY, nd);
    acc(PS, nd, x(PS, nd), rr(PS, nd), sby, gamma, mz);
    const T* bb = lm.b + nd * lm.sb;
    rows<BATCH>(
        g.ny,
        [&](int r) { return three(PY, r * n_nl + nd, DY, r * n_nl + nd); },
        [&](int r, const Three<T>& v) {
          acc(PY, r * n_nl + nd, v.a, v.b, v.c - bb[r] * sby, gamma, mz);
        });
    // dual: y, sby, cx, cu, pnl of the node
    T by = T(0);
    rows<BATCH>(
        g.ny,
        [&](int r) { return three(DY, r * n_nl + nd, PY, r * n_nl + nd); },
        [&](int r, const Three<T>& v) {
          by += bb[r] * v.c;
          acc(DY, r * n_nl + nd, v.a, v.b, v.c, sigma, mv);
        });
    acc(DSBY, nd, x(DSBY, nd), rr(DSBY, nd), x(PS, nd) - by, sigma, mv);
    rows<BATCH>(
        nx,
        [&](int r) { return three(DCX, r * n_nl + nd, PX, r * n + nd); },
        [&](int r, const Three<T>& v) {
          acc(DCX, r * n_nl + nd, v.a, v.b, v.c, sigma, mv);
        });
    rows<BATCH>(
        nu,
        [&](int r) { return three(DCU, r * n_nl + nd, PU, r * n_nl + nd); },
        [&](int r, const Three<T>& v) {
          acc(DCU, r * n_nl + nd, v.a, v.b, v.c, sigma, mv);
        });
    for (int r = 0; r < g.nc; ++r) {
      T ax = T(0);
      for (int k = 0; k < nx; ++k) ax += lm.Gx[r * nx + k] * x(PX, k * n + nd);
      T au = T(0);
      for (int k = 0; k < nu; ++k) {
        au += lm.Gu[r * nu + k] * x(PU, k * n_nl + nd);
      }
      acc(DPNL, r * n_nl + nd, x(DPNL, r * n_nl + nd),
          rr(DPNL, r * n_nl + nd), ax + au, sigma, mv);
    }
  } else {
    const int l = nd - n_nl;
#pragma unroll
    for (int q = 0; q < kMaxDim; ++q) {
      w[q] = q < nx ? x(DQNX, q * n_lf + l) : T(0);
    }
    mat_rows_dot<BATCH>(
        mat_rows(sm + s.QNT, ldx, X.k.nmQN, nx, n_lf, l, true), w, nx, nx,
        [&](int r) { return three(PX, r * n + nd, DCXN, r * n_lf + l); },
        [&](int r, const Three<T>& v, T t) {
          const T lt =
              v.c + t + poly_lt<DPLF>(lm.GxN, g.ncL, nx, r, n_lf, l, x);
          acc(PX, r * n + nd, v.a, v.b, lt, gamma, mz);
        });
    acc(PS, nd, x(PS, nd), rr(PS, nd), T(0.5) * (x(DS12, l) + x(DS13, l)),
        gamma, mz);
    // dual: qNx, s12, s13, cxN, plf of the leaf
#pragma unroll
    for (int q = 0; q < kMaxDim; ++q) {
      w[q] = q < nx ? x(PX, q * n + nd) : T(0);
    }
    mat_rows_dot<BATCH>(
        mat_rows(sm + s.QN, ldx, X.k.nmQN, nx, n_lf, l, false), w, nx, nx,
        [&](int r) {
          return Two<T>{x(DQNX, r * n_lf + l), rr(DQNX, r * n_lf + l)};
        },
        [&](int r, const Two<T>& v, T t) {
          acc(DQNX, r * n_lf + l, v.a, v.b, t, sigma, mv);
        });
    const T hs = T(0.5) * x(PS, nd);
    acc(DS12, l, x(DS12, l), rr(DS12, l), hs, sigma, mv);
    acc(DS13, l, x(DS13, l), rr(DS13, l), hs, sigma, mv);
    rows<BATCH>(
        nx,
        [&](int r) { return three(DCXN, r * n_lf + l, PX, r * n + nd); },
        [&](int r, const Three<T>& v) {
          acc(DCXN, r * n_lf + l, v.a, v.b, v.c, sigma, mv);
        });
    for (int r = 0; r < g.ncL; ++r) {
      T ax = T(0);
      for (int k = 0; k < nx; ++k) {
        ax += lm.GxN[r * nx + k] * x(PX, k * n + nd);
      }
      acc(DPLF, r * n_lf + l, x(DPLF, r * n_lf + l), rr(DPLF, r * n_lf + l),
          ax, sigma, mv);
    }
  }
  if (nd > 0) {
    // tau of the node, and the dual column of its edge from the parent
    const int j = nd - 1;
    const int p = parent_of(g, nd);
    acc(PTAU, j, x(PTAU, j), rr(PTAU, j), T(0.5) * (x(DT5, j) + x(DT6, j)),
        gamma, mz);
#pragma unroll
    for (int q = 0; q < kMaxDim; ++q) {
      w[q] = q < nx ? x(PX, q * n + p) : T(0);
    }
    mat_rows_dot<BATCH>(
        mat_rows(sm + s.Q, ldx, X.k.nmQ, nx, n_nr, j, false), w, nx, nx,
        [&](int r) {
          return Two<T>{x(DQX, r * n_nr + j), rr(DQX, r * n_nr + j)};
        },
        [&](int r, const Two<T>& v, T t) {
          acc(DQX, r * n_nr + j, v.a, v.b, t, sigma, mv);
        });
#pragma unroll
    for (int q = 0; q < kMaxDim; ++q) {
      w[q] = q < nu ? x(PU, q * n_nl + p) : T(0);
    }
    mat_rows_dot<BATCH>(
        mat_rows(sm + s.R, ldu, X.k.nmR, nu, n_nr, j, false), w, nu, nu,
        [&](int r) {
          return Two<T>{x(DRU, r * n_nr + j), rr(DRU, r * n_nr + j)};
        },
        [&](int r, const Two<T>& v, T t) {
          acc(DRU, r * n_nr + j, v.a, v.b, t, sigma, mv);
        });
    const T ht = T(0.5) * x(PTAU, j);
    acc(DT5, j, x(DT5, j), rr(DT5, j), ht, sigma, mv);
    acc(DT6, j, x(DT6, j), rr(DT6, j), ht, sigma, mv);
  }
}

// Rows of one Riccati node a thread of its group owns: gl, gl + G, ...
// (at most kMaxDim / 4, since a group has at least 4 threads).
constexpr int kGroupRows = kMaxDim / 4;

// One sweep of one lane at c = (z, v) (+ tau (dz, dv) when DIR) into the
// output lane o; with ``metric`` (always with DIR) also <r, M r> and the
// inf-norms of M r, M r stored into the lane mr unless it is null, and with
// DIR <r, M d> and the inf-norms of M d.  gdv: the lane's [n_nl, ldu]
// feedforward terms; qg: its costate buffer when they are not in shared
// memory; x0: its root state; sm: the block's dynamic shared memory, with
// stage_consts done.  Starts and ends with a barrier.  Not inlined: the
// kernels of a source share one copy of each sweep, which keeps the build
// short.  ``Clk`` times its parts (PhaseClock in the step kernels; the
// opening barrier closes the caller's pending part).
template <typename T, bool DIR, class Clk = NoClock>
__device__ __noinline__ SweepRed<T> step_sweep(
    const StepConsts<T>& X, const Lane<T>& zl, const Lane<T>& dl, T tau,
    const Lane<T>& ol, const Lane<T>* mr, bool metric, T* gdv, T* qg,
    const T* x0, T* sm) {
  const Geo& g = X.k.g;
  const StepSmem& s = X.s;
  const LMats<T>& lm = X.k.lm;
  const int tid = threadIdx.x;
  const T gamma = X.k.gamma, sigma = X.k.sigma;
  const int nx = g.nx, nu = g.nu, ny = g.ny, d = g.d;
  const int n = g.n, n_nl = g.n_nl, n_nr = g.n_nr, n_lf = g.n_lf;
  const int ldx = s.ldx, ldu = s.ldu;
  const int mker = ny + 2 * d;
  const LaneIn<T, DIR> c{&zl, &dl, tau};
  T* const* o = ol.p;
  T* qbuf = s.q_shared ? sm + s.work : qg;
  __syncthreads();
  Clk::lap_pending();

  // ---- w1 = c - gamma L' c_v, the S2 projector, s_root - gamma and the
  // leaf costates -x1, one thread per node ----
  auto w1_s = [&](int ch) {
    const T lt = ch < n_nl ? c(DSBY, ch)
                           : T(0.5) * (c(DS12, ch - n_nl) + c(DS13, ch - n_nl));
    return c(PS, ch) - gamma * lt;
  };
  auto w1_tau = [&](int j) {
    return c(PTAU, j) - gamma * (T(0.5) * (c(DT5, j) + c(DT6, j)));
  };
  for (int i = tid; i < n; i += kThreads) {
    T w[kMaxDim];
    if (i < n_nl) {
      const int t = stage_of(g, i);
      const int mt = g.off[t + 1] - g.off[t];
      const int c0 = child_of(g, i, t, 0) - 1;
      child_rows(
          sm + s.QT, ldx, X.k.nmQ, n_nr, nx, d, c0, mt,
          [&](int q, int k) { return c(DQX, q * n_nr + c0 + k * mt); },
          [&](int r) {
            return Two<T>{c(DCX, r * n_nl + i), c(PX, r * n + i)};
          },
          [&](int r, const Two<T>& v, T ct) {
            const T lt =
                v.a + ct + poly_lt<DPNL>(lm.Gx, g.nc, nx, r, n_nl, i, c);
            o[PX][r * n + i] = v.b - gamma * lt;
          });
      child_rows(
          sm + s.RT, ldu, X.k.nmR, n_nr, nu, d, c0, mt,
          [&](int q, int k) { return c(DRU, q * n_nr + c0 + k * mt); },
          [&](int r) {
            return Two<T>{c(DCU, r * n_nl + i), c(PU, r * n_nl + i)};
          },
          [&](int r, const Two<T>& v, T ct) {
            const T lt =
                v.a + ct + poly_lt<DPNL>(lm.Gu, g.nc, nu, r, n_nl, i, c);
            o[PU][r * n_nl + i] = v.b - gamma * lt;
          });
      // (y; s_children; tau_children) through the node's S2 projector
      const T* bb = lm.b + i * lm.sb;
      const T sby = c(DSBY, i);
#pragma unroll
      for (int a = 0; a < kMaxDim; ++a) {
        T e = T(0);
        if (a < ny) {
          e = c(PY, a * n_nl + i) - gamma * (c(DY, a * n_nl + i) - bb[a] * sby);
        } else if (a < ny + d) {
          e = w1_s(c0 + 1 + (a - ny) * mt);
        } else if (a < mker) {
          e = w1_tau(c0 + (a - ny - d) * mt);
        }
        w[a] = e;
      }
      const T* ker = X.k.sker ? X.k.ker + i * X.k.sker : nullptr;
      for (int a = 0; a < mker; ++a) {
        const T res = ker ? dot_g(ker + a * mker, w, mker)
                          : dot_v(sm + s.ker + a * s.ldk, w, s.ldk);
        if (a < ny) {
          o[PY][a * n_nl + i] = res;
        } else if (a < ny + d) {
          o[PS][c0 + 1 + (a - ny) * mt] = res;
        } else {
          o[PTAU][c0 + (a - ny - d) * mt] = res;
        }
      }
      if (i == 0) o[PS][0] = w1_s(0) - gamma;
    } else {
      const int l = i - n_nl;
#pragma unroll
      for (int q = 0; q < kMaxDim; ++q) {
        w[q] = q < nx ? c(DQNX, q * n_lf + l) : T(0);
      }
      T* ql = qbuf + l * ldx;  // the leaves' half
      mat_rows_dot(
          mat_rows(sm + s.QNT, ldx, X.k.nmQN, nx, n_lf, l, true), w, nx, nx,
          [&](int r) {
            return Two<T>{c(DCXN, r * n_lf + l), c(PX, r * n + i)};
          },
          [&](int r, const Two<T>& v, T t) {
            const T lt =
                v.a + t + poly_lt<DPLF>(lm.GxN, g.ncL, nx, r, n_lf, l, c);
            const T x1 = v.b - gamma * lt;
            o[PX][r * n + i] = x1;
            ql[r] = -x1;
          });
      for (int r = nx; r < ldx; ++r) ql[r] = T(0);
    }
  }

  // ---- S1 backward sweep: a group of G threads per node, each thread
  // owning the rows gl, gl + G, ... of the node's vectors ----
  for (int st = g.N - 2; st >= 0; --st) {
    const int m = g.off[st + 1] - g.off[st];
    const int base = g.off[st];
    const T* K = X.k.K + st * nu * nx;
    const T* Rti = X.k.Rti + st * nu * nu;
    const T* ABK = X.k.ABK + st * d * nx * nx;
    const T* PB = X.k.PB + st * d * nx * nu;
    __syncthreads();  // the previous stage is done with the stage matrices
    // the part before: the first stage's is w1 and S2, a later one's the
    // stage before it
    Clk::lap(st == g.N - 2 ? kSlotLprimeS2 : kSlotBackward);
    for (int e = tid; e < nu * ldu; e += kThreads) {
      const int r = e / ldu, q = e % ldu;
      sm[s.Rti + e] = q < nu ? Rti[r * nu + q] : T(0);
    }
    for (int e = tid; e < d * nx * ldu; e += kThreads) {
      const int kr = e / ldu, q = e % ldu;
      sm[s.PB + e] = q < nu ? PB[kr * nu + q] : T(0);
    }
    for (int e = tid; e < d * nx * ldx; e += kThreads) {
      const int kr = e / ldx, q = e % ldx;
      const int k = kr / nx, r = kr % nx;
      sm[s.ABKt + e] = q < nx ? ABK[(k * nx + q) * nx + r] : T(0);
    }
    for (int e = tid; e < nx * ldu; e += kThreads) {
      const int r = e / ldu, q = e % ldu;
      sm[s.Kt + e] = q < nu ? K[q * nx + r] : T(0);
    }
    __syncthreads();
    int C, G;
    stage_groups(m, s.cmax, C, G);
    const int gi = tid / G, gl = tid % G;
    const T* qc = qbuf + qhalf_of(g, s, st + 1);
    T* qo = qbuf + qhalf_of(g, s, st);
    T* sw = sm + s.xch + (gi < C ? gi : 0) * s.xch_node;
    T* sd = sw + ldu;
    T* sdu = sd + ldu;
    T* si = sdu + ldu;
    for (int r0 = 0; r0 < m; r0 += C) {
      const int l = r0 + gi;
      const bool act = gi < C && l < m;
      const int node = base + l;
      // the node's targets u1 and x1, loaded together
      T u1[kGroupRows], x1[kGroupRows];
#pragma unroll
      for (int k = 0; k < kGroupRows; ++k) {
        const int cc = gl + k * G;
        u1[k] = act && cc < nu ? o[PU][cc * n_nl + node] : T(0);
        x1[k] = act && cc < nx ? o[PX][cc * n + node] : T(0);
      }
      if (act) {
#pragma unroll
        for (int k = 0; k < kGroupRows; ++k) {
          const int cc = gl + k * G;
          if (cc < nu) {
            T sum_d = T(0);
            for (int kk = 0; kk < d; ++kk) {
              const T term = dot_s(sm + s.Bt + (kk * nu + cc) * ldx,
                                   qc + (kk * m + l) * ldx, ldx);
              sum_d = kk == 0 ? term : sum_d + term;
            }
            sw[cc] = u1[k] - sum_d;
          }
        }
      }
      __syncwarp();
      if (act) {
#pragma unroll
        for (int k = 0; k < kGroupRows; ++k) {
          const int cc = gl + k * G;
          if (cc < ldu) {
            T dv = T(0);
            if (cc < nu) {
              dv = dot_s(sm + s.Rti + cc * ldu, sw, ldu);
              sd[cc] = dv;
              sdu[cc] = dv - u1[k];
            }
            gdv[node * ldu + cc] = dv;
          }
        }
      }
      __syncwarp();
      if (act) {
        for (int kr = gl; kr < d * nx; kr += G) {
          const int k = kr / nx, r = kr % nx;
          si[k * ldx + r] = dot_s(sm + s.PB + kr * ldu, sd, ldu) +
                            qc[(k * m + l) * ldx + r];
        }
      }
      __syncwarp();
      if (act) {
#pragma unroll
        for (int k = 0; k < kGroupRows; ++k) {
          const int r = gl + k * G;
          if (r < ldx) {
            T qi = T(0);
            if (r < nx) {
              for (int kk = 0; kk < d; ++kk) {
                const T term = dot_s(sm + s.ABKt + (kk * nx + r) * ldx,
                                     si + kk * ldx, ldx);
                qi = kk == 0 ? term : qi + term;
              }
              const T kt = dot_s(sm + s.Kt + r * ldu, sdu, ldu);
              qi = (qi + kt) - x1[k];
            }
            qo[l * ldx + r] = qi;
          }
        }
      }
      __syncwarp();
    }
  }

  // ---- S1 forward rollout from x0: u = K x + dvec, x_child = ABK_k x +
  // B_k dvec, the stage's states in the costate buffer ----
  __syncthreads();  // the backward sweep is done with the buffers
  Clk::lap(kSlotBackward);
  {
    T* x0b = qbuf + qhalf_of(g, s, 0);
    for (int r = tid; r < ldx; r += kThreads) {
      const T v = r < nx ? x0[r] : T(0);
      x0b[r] = v;
      if (r < nx) o[PX][r * n] = v;
    }
  }
  for (int st = 0; st < g.N - 1; ++st) {
    const int m = g.off[st + 1] - g.off[st];
    const int base = g.off[st];
    const T* K = X.k.K + st * nu * nx;
    const T* ABK = X.k.ABK + st * d * nx * nx;
    __syncthreads();  // the stage's states are written
    for (int e = tid; e < nu * ldx; e += kThreads) {
      const int cc = e / ldx, q = e % ldx;
      sm[s.Kf + e] = q < nx ? K[cc * nx + q] : T(0);
    }
    for (int e = tid; e < d * nx * ldx; e += kThreads) {
      const int kr = e / ldx, q = e % ldx;
      sm[s.ABKf + e] = q < nx ? ABK[kr * nx + q] : T(0);
    }
    __syncthreads();
    int C, G;
    stage_groups(m, s.cmax, C, G);
    const int gi = tid / G, gl = tid % G;
    const T* xb = qbuf + qhalf_of(g, s, st);
    T* xn = qbuf + qhalf_of(g, s, st + 1);
    T* sd = sm + s.xch + (gi < C ? gi : 0) * s.xch_node + ldu;
    const bool last = st + 1 == g.N - 1;
    for (int r0 = 0; r0 < m; r0 += C) {
      const int l = r0 + gi;
      const bool act = gi < C && l < m;
      const int node = base + l;
      const T* xv = xb + l * ldx;
      // the node's dvec into the group's shared memory
      if (act) {
#pragma unroll
        for (int k = 0; k < kGroupRows; ++k) {
          const int cc = gl + k * G;
          if (cc < nu) sd[cc] = gdv[node * ldu + cc];
        }
      }
      __syncwarp();
      if (act) {
#pragma unroll
        for (int k = 0; k < kGroupRows; ++k) {
          const int cc = gl + k * G;
          if (cc < nu) {
            o[PU][cc * n_nl + node] =
                dot_s(sm + s.Kf + cc * ldx, xv, ldx) + sd[cc];
          }
        }
        for (int kr = gl; kr < d * ldx; kr += G) {
          const int k = kr / ldx, r = kr % ldx;
          T xc = T(0);
          if (r < nx) {
            const T ax = dot_s(sm + s.ABKf + (k * nx + r) * ldx, xv, ldx);
            const T bd = dot_s(sm + s.Bf + (k * nx + r) * ldu, sd, ldu);
            xc = ax + bd;
            o[PX][r * n + g.off[st + 1] + k * m + l] = xc;
          }
          if (!last) xn[(k * m + l) * ldx + r] = xc;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  Clk::lap(kSlotForward);

  // ---- ubar = prox_h*(c_v + sigma L (2 wbar - c_z)), one thread per node:
  // the prox argument, projected where it is formed ----
  {
    const LaneRefl<T, LaneIn<T, DIR>> rf{c, &ol};
    const T inv = T(1) / sigma;
    const Segments& segs = X.k.segs;
    for (int nd = tid; nd < n; nd += kThreads) {
      T w[kMaxDim];
      if (nd > 0) {
        // (t6; qx, ru, t5) of the edge from the parent
        const int j = nd - 1;
        const int p = parent_of(g, nd);
#pragma unroll
        for (int q = 0; q < kMaxDim; ++q) {
          w[q] = q < nx ? rf(PX, q * n + p) : T(0);
        }
        T acc = T(0);
        mat_rows_dot(
            mat_rows(sm + s.Q, ldx, X.k.nmQ, nx, n_nr, j, false), w, nx, nx,
            [&](int r) { return c(DQX, r * n_nr + j); },
            [&](int r, T cv, T t) {
              const T a = (cv + sigma * t) * inv;
              o[DQX][r * n_nr + j] = a;
              acc += a * a;
            });
#pragma unroll
        for (int q = 0; q < kMaxDim; ++q) {
          w[q] = q < nu ? rf(PU, q * n_nl + p) : T(0);
        }
        mat_rows_dot(
            mat_rows(sm + s.R, ldu, X.k.nmR, nu, n_nr, j, false), w, nu, nu,
            [&](int r) { return c(DRU, r * n_nr + j); },
            [&](int r, T cv, T t) {
              const T a = (cv + sigma * t) * inv;
              o[DRU][r * n_nr + j] = a;
              acc += a * a;
            });
        const T ht = T(0.5) * rf(PTAU, j);
        const T t5 = (c(DT5, j) + sigma * ht) * inv - T(0.5);
        const T t6 = (c(DT6, j) + sigma * ht) * inv + T(0.5);
        acc += t5 * t5;
        T t_out, xs;
        soc_pieces(t6, acc, t_out, xs);
        o[DT6][j] = sigma * (t6 - t_out);
        rows(nx, [&](int r) { return o[DQX][r * n_nr + j]; },
             [&](int r, T a) { o[DQX][r * n_nr + j] = sigma * (a - xs * a); });
        rows(nu, [&](int r) { return o[DRU][r * n_nr + j]; },
             [&](int r, T a) { o[DRU][r * n_nr + j] = sigma * (a - xs * a); });
        o[DT5][j] = sigma * (t5 - xs * t5);
      }
      if (nd < n_nl) {
        const int i = nd;
        const T* bb = lm.b + i * lm.sb;
        T by = T(0);
        rows(ny,
             [&](int r) {
               return Two<T>{rf(PY, r * n_nl + i), c(DY, r * n_nl + i)};
             },
             [&](int r, const Two<T>& v) {
               by += bb[r] * v.a;
               const T a = (v.b + sigma * v.a) * inv;
               int kind = 3;
               for (int q = 0; q < segs.n; ++q) {
                 if (r >= segs.lo[q] && r < segs.hi[q]) kind = segs.kind[q];
               }
               T pr = a;
               if (kind == kNonneg) {
                 pr = a < T(0) ? T(0) : a;
               } else if (kind == kNonpos) {
                 pr = a > T(0) ? T(0) : a;
               } else if (kind == kZero) {
                 pr = T(0);
               }
               o[DY][r * n_nl + i] = sigma * (a - pr);
             });
        {
          const T a = (c(DSBY, i) + sigma * (rf(PS, i) - by)) * inv;
          o[DSBY][i] = sigma * (a - (a < T(0) ? T(0) : a));
        }
        rows(nx,
             [&](int r) {
               return Two<T>{c(DCX, r * n_nl + i), rf(PX, r * n + i)};
             },
             [&](int r, const Two<T>& v) {
               const T a = (v.a + sigma * v.b) * inv;
               o[DCX][r * n_nl + i] =
                   sigma * (a - clip(a, X.k.xmin[r], X.k.xmax[r]));
             });
        rows(nu,
             [&](int r) {
               return Two<T>{c(DCU, r * n_nl + i), rf(PU, r * n_nl + i)};
             },
             [&](int r, const Two<T>& v) {
               const T a = (v.a + sigma * v.b) * inv;
               o[DCU][r * n_nl + i] =
                   sigma * (a - clip(a, X.k.umin[r], X.k.umax[r]));
             });
        for (int r = 0; r < g.nc; ++r) {
          T ax = T(0);
          for (int k = 0; k < nx; ++k) {
            ax += lm.Gx[r * nx + k] * rf(PX, k * n + i);
          }
          T au = T(0);
          for (int k = 0; k < nu; ++k) {
            au += lm.Gu[r * nu + k] * rf(PU, k * n_nl + i);
          }
          const T a = (c(DPNL, r * n_nl + i) + sigma * (ax + au)) * inv;
          o[DPNL][r * n_nl + i] =
              sigma * (a - clip(a, X.k.plo[r], X.k.phi[r]));
        }
      } else {
        // (s13; qNx, s12) of the leaf, its boxes and polytope rows
        const int l = nd - n_nl;
#pragma unroll
        for (int q = 0; q < kMaxDim; ++q) {
          w[q] = q < nx ? rf(PX, q * n + nd) : T(0);
        }
        T acc = T(0);
        mat_rows_dot(
            mat_rows(sm + s.QN, ldx, X.k.nmQN, nx, n_lf, l, false), w, nx, nx,
            [&](int r) { return c(DQNX, r * n_lf + l); },
            [&](int r, T cv, T t) {
              const T a = (cv + sigma * t) * inv;
              o[DQNX][r * n_lf + l] = a;
              acc += a * a;
            });
        const T hs = T(0.5) * rf(PS, nd);
        const T s12 = (c(DS12, l) + sigma * hs) * inv - T(0.5);
        const T s13 = (c(DS13, l) + sigma * hs) * inv + T(0.5);
        acc += s12 * s12;
        T t_out, xs;
        soc_pieces(s13, acc, t_out, xs);
        o[DS13][l] = sigma * (s13 - t_out);
        rows(nx, [&](int r) { return o[DQNX][r * n_lf + l]; },
             [&](int r, T a) { o[DQNX][r * n_lf + l] = sigma * (a - xs * a); });
        o[DS12][l] = sigma * (s12 - xs * s12);
        rows(nx,
             [&](int r) {
               return Two<T>{c(DCXN, r * n_lf + l), rf(PX, r * n + nd)};
             },
             [&](int r, const Two<T>& v) {
               const T a = (v.a + sigma * v.b) * inv;
               o[DCXN][r * n_lf + l] =
                   sigma * (a - clip(a, X.k.xmin[r], X.k.xmax[r]));
             });
        for (int r = 0; r < g.ncL; ++r) {
          T ax = T(0);
          for (int k = 0; k < nx; ++k) {
            ax += lm.GxN[r * nx + k] * rf(PX, k * n + nd);
          }
          const T a = (c(DPLF, r * n_lf + l) + sigma * ax) * inv;
          o[DPLF][r * n_lf + l] =
              sigma * (a - clip(a, X.k.pNlo[r], X.k.pNhi[r]));
        }
      }
    }
  }
  __syncthreads();
  Clk::lap(kSlotProx);
  SweepRed<T> out{T(0), T(0), T(0), T(0), T(0), T(0)};
  if (!DIR && !metric) return out;

  // ---- M r (and M d) per node, both in one traversal ----
  const LaneRes<T, LaneIn<T, DIR>> res{c, &ol};
  T red[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int nd = tid; nd < n; nd += kThreads) {
    metric_node(X, sm, nd, res, res, mr, red[0], red[1], red[2]);
    if constexpr (DIR) {
      metric_node(X, sm, nd, LaneAt<T>{&dl}, res,
                  static_cast<const Lane<T>*>(nullptr), red[3], red[4],
                  red[5]);
    }
  }
  T* sh = sm + s.work;
  if constexpr (DIR) {
    // sums first: dot, rho; then the four maxima
    T v[6] = {red[0], red[3], red[1], red[2], red[4], red[5]};
    block_reduce(v, 2, sh);
    out = SweepRed<T>{v[0], v[2], v[3], v[1], v[4], v[5]};
  } else {
    T v[3] = {red[0], red[1], red[2]};
    block_reduce(v, 1, sh);
    out.dot = v[0];
    out.nz = v[1];
    out.nv = v[2];
  }
  Clk::lap(kSlotMetric);
  return out;
}

// Launches ``kernel`` on ``grid`` blocks with the planned dynamic shared
// memory of P.x.s.  Every launch lifts the kernel's limit above 48 KB: the
// attribute belongs to the current device, and the call is cheap.
template <class K, class Params>
int launch_kernel(K kernel, const Params& P, int grid, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid == 0) return 0;
  kernel<<<grid, kThreads, P.x.s.bytes, static_cast<cudaStream_t>(stream)>>>(
      P);
  return static_cast<int>(cudaGetLastError());
}

// The node body's shared-memory plan for dims and values of T with
// ``tail`` bytes more (plan_smem's), into out[4]: {bytes, costates in
// shared memory, Riccati groups, costate values per lane}; -1 entries and an
// error when the problem is outside the body's class or no layout fits.
template <typename T>
int node_plan(const int* dims, int* out, int tail = 0) {
  SweepConsts<T> k;
  void* none[kConstPtrs + 4] = {};
  StepSmem s;
  if (!make_consts(k, none, dims, 1.0, 1.0) || !node_fits(k.g) ||
      !plan_smem(s, k.g, dims, static_cast<int>(sizeof(T)), tail)) {
    out[0] = out[1] = out[2] = out[3] = -1;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = s.bytes;
  out[1] = s.q_shared;
  out[2] = s.cmax;
  out[3] = s.qsize;
  return 0;
}

}  // namespace spock
