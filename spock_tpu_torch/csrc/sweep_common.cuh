// Tree geometry, lane accessors and the blocks of the linear operator L and
// its adjoint L', shared by the one-block-per-lane kernels cp_sweep.cu,
// metric_apply.cu and sp_step.cu.
//
// A lane's (primal, dual) pair is 19 arrays, feature-major with the node axis
// last, in the order of the JAX package's kernels (and of
// spock_tpu_torch.zv.Primal then zv.DUAL_BLOCKS, pnl, plf):
//   primal  x [nx, n], u [nu, n_nl], s [n], tau [n_nr], y [ny, n_nl]
//   dual    y [ny, n_nl], sby [n_nl], qx [nx, n_nr], ru [nu, n_nr],
//           t5 [n_nr], t6 [n_nr], cx [nx, n_nl], cu [nu, n_nl],
//           qNx [nx, n_lf], s12 [n_lf], s13 [n_lf], cxN [nx, n_lf],
//           pnl [nc, n_nl], plf [ncL, n_lf]
// Each array is [B, rows, cols] in device memory; lane b starts at
// b * rows * cols.  The two polytope blocks have no rows (and a null
// pointer) when the problem has no polytope: every loop over their elements
// is then empty.
//
// The tree is sibling-major (spock_tpu_torch/tree.py): stage t holds nodes
// [off[t], off[t+1]); the k-th children of the stage-t nodes are the block
// [off[t+1] + k m, off[t+1] + (k+1) m) with m = d^t, and non-root node c is
// column c - 1 of qx, ru, t5, t6 and tau.  The cost matrices and the risk
// data are uniform over nodes (one matrix, node stride 0) or per node:
// sqrtQ[c - 1] and sqrtR[c - 1] weight the parent's (x, u) on the edge to
// non-root node c, sqrtQN[l] belongs to leaf l, b[i] to non-leaf node i.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spock {

constexpr int kMaxStages = 24;

// The 19 blocks of a (primal, dual) pair.
enum Block {
  PX, PU, PS, PTAU, PY,
  DY, DSBY, DQX, DRU, DT5, DT6, DCX, DCU, DQNX, DS12, DS13, DCXN, DPNL, DPLF,
  kPairBlocks
};

// Leading entries of the int array ``dims`` every launch takes: the sizes,
// the polytope rows per non-leaf and per leaf node, and whether sqrtQ,
// sqrtR, sqrtQN and the risk data (b, ker_proj) are per node (1) or
// uniform (0).
enum Dim {
  DIM_NX, DIM_NU, DIM_NY, DIM_N, DIM_D, DIM_NC, DIM_NCL,
  DIM_PN_Q, DIM_PN_R, DIM_PN_QN, DIM_PN_RISK,
  kDims
};

template <int B>
struct Blk {
  static constexpr int value = B;
};

struct Geo {
  int nx, nu, ny, N, d;
  int nc, ncL;  // polytope rows per non-leaf and per leaf node (0: none)
  int n, n_nl, n_nr, n_lf;
  int mmax;  // nodes of the widest non-leaf stage, d^(N-2)
  int off[kMaxStages + 1];
  int rows[kPairBlocks], cols[kPairBlocks], lsz[kPairBlocks];
};

// Fills g from the leading entries of dims; returns false if the tree is
// too deep.
inline bool make_geo(Geo& g, const int* dims) {
  const int nx = dims[DIM_NX], nu = dims[DIM_NU], ny = dims[DIM_NY];
  const int N = dims[DIM_N], d = dims[DIM_D];
  const int nc = dims[DIM_NC], ncL = dims[DIM_NCL];
  if (N < 2 || N > kMaxStages || d < 2 || nc < 0 || ncL < 0) return false;
  g.nx = nx;
  g.nu = nu;
  g.ny = ny;
  g.N = N;
  g.d = d;
  g.nc = nc;
  g.ncL = ncL;
  int size = 1;
  g.off[0] = 0;
  for (int t = 0; t < N; ++t) {
    g.off[t + 1] = g.off[t] + size;
    if (t < N - 1) g.mmax = size;
    size *= d;
  }
  g.n = g.off[N];
  g.n_nl = g.off[N - 1];
  g.n_nr = g.n - 1;
  g.n_lf = g.n - g.n_nl;
  const int rows[kPairBlocks] = {nx, nu, 1, 1, ny, ny, 1, nx, nu, 1, 1,
                                 nx, nu, nx, 1, 1, nx, nc, ncL};
  const int cols[kPairBlocks] = {
      g.n, g.n_nl, g.n, g.n_nr, g.n_nl, g.n_nl, g.n_nl, g.n_nr, g.n_nr,
      g.n_nr, g.n_nr, g.n_nl, g.n_nl, g.n_lf, g.n_lf, g.n_lf, g.n_lf,
      g.n_nl, g.n_lf};
  for (int b = 0; b < kPairBlocks; ++b) {
    g.rows[b] = rows[b];
    g.cols[b] = cols[b];
    g.lsz[b] = rows[b] * cols[b];
  }
  return true;
}

// Base pointers of the 19 [B, rows, cols] arrays of a pair (null for an
// absent polytope block).
template <typename T>
struct Pair {
  T* p[kPairBlocks];
};

// The matrices of L: sqrtQ [1 | n_nr, nx, nx], sqrtR [1 | n_nr, nu, nu],
// sqrtQN [1 | n_lf, nx, nx] and the risk vectors b [1 | n_nl, ny], each with
// its node stride (0 when uniform); the polytope rows Gx [nc, nx],
// Gu [nc, nu] and GxN [ncL, nx] (null when absent).
template <typename T>
struct LMats {
  const T* sqrtQ;
  const T* sqrtR;
  const T* sqrtQN;
  const T* b;
  const T* Gx;
  const T* Gu;
  const T* GxN;
  int sq, sr, sqn, sb;  // node strides
};

// The number of pointers make_lmats reads.
constexpr int kLMatPtrs = 7;

// Fills m from the host pointers p (sqrtQ, sqrtR, sqrtQN, b, Gx, Gu, GxN)
// and the per-node flags of dims.
template <typename T>
void make_lmats(LMats<T>& m, void* const* p, const Geo& g, const int* dims) {
  m.sqrtQ = static_cast<const T*>(p[0]);
  m.sqrtR = static_cast<const T*>(p[1]);
  m.sqrtQN = static_cast<const T*>(p[2]);
  m.b = static_cast<const T*>(p[3]);
  m.Gx = static_cast<const T*>(p[4]);
  m.Gu = static_cast<const T*>(p[5]);
  m.GxN = static_cast<const T*>(p[6]);
  m.sq = dims[DIM_PN_Q] ? g.nx * g.nx : 0;
  m.sr = dims[DIM_PN_R] ? g.nu * g.nu : 0;
  m.sqn = dims[DIM_PN_QN] ? g.nx * g.nx : 0;
  m.sb = dims[DIM_PN_RISK] ? g.ny : 0;
}

// One lane of a pair in device memory.
template <typename T>
struct Ref {
  const Pair<T>* pair;
  const Geo* g;
  int64_t lane;
  __device__ __forceinline__ T& operator()(int blk, int idx) const {
    return pair->p[blk][lane * g->lsz[blk] + idx];
  }
};

// The lane read at (z, v) + tau (dz, dv) when DIR, at (z, v) otherwise.
template <typename T, bool DIR>
struct Cand {
  Ref<T> a, d;
  T tau;
  __device__ __forceinline__ T operator()(int blk, int idx) const {
    if constexpr (DIR) {
      return a(blk, idx) + tau * d(blk, idx);
    } else {
      return a(blk, idx);
    }
  }
};

// a - b, elementwise (the fixed-point residual r = w - wbar).
template <typename T, class A, class B>
struct Diff {
  A a;
  B b;
  __device__ __forceinline__ T operator()(int blk, int idx) const {
    return a(blk, idx) - b(blk, idx);
  }
};

// 2 zbar - z, the reflection that the dual half of a sweep applies L to.
template <typename T, class Z>
struct Refl {
  Ref<T> zbar;
  Z z;
  __device__ __forceinline__ T operator()(int blk, int idx) const {
    return T(2) * zbar(blk, idx) - z(blk, idx);
  }
};

__device__ __forceinline__ int stage_of(const Geo& g, int i) {
  int t = 0;
  while (g.off[t + 1] <= i) ++t;
  return t;
}

__device__ __forceinline__ int parent_of(const Geo& g, int c) {
  const int t = stage_of(g, c);
  const int m = g.off[t] - g.off[t - 1];
  return g.off[t - 1] + (c - g.off[t]) % m;
}

// k-th child of node i of stage t.
__device__ __forceinline__ int child_of(const Geo& g, int i, int t, int k) {
  const int m = g.off[t + 1] - g.off[t];
  return g.off[t + 1] + k * m + (i - g.off[t]);
}

// Calls f(Blk<b>{}) for every primal (dual) block b.
template <class F>
__device__ __forceinline__ void each_primal(F&& f) {
  f(Blk<PX>{});
  f(Blk<PU>{});
  f(Blk<PS>{});
  f(Blk<PTAU>{});
  f(Blk<PY>{});
}

template <class F>
__device__ __forceinline__ void each_dual(F&& f) {
  f(Blk<DY>{});
  f(Blk<DSBY>{});
  f(Blk<DQX>{});
  f(Blk<DRU>{});
  f(Blk<DT5>{});
  f(Blk<DT6>{});
  f(Blk<DCX>{});
  f(Blk<DCU>{});
  f(Blk<DQNX>{});
  f(Blk<DS12>{});
  f(Blk<DS13>{});
  f(Blk<DCXN>{});
  f(Blk<DPNL>{});
  f(Blk<DPLF>{});
}

// Calls f(row, col, idx) for the elements of block BLK that this thread
// owns: the threads of the block stride over the lane's array.
template <int BLK, class F>
__device__ __forceinline__ void for_elems(const Geo& g, F&& f) {
  const int cols = g.cols[BLK];
  const int size = g.lsz[BLK];
  for (int idx = threadIdx.x; idx < size; idx += blockDim.x) {
    f(idx / cols, idx % cols, idx);
  }
}

// Element (r, j) of dual block BLK of L z, for a primal accessor z.
template <int BLK, typename T, class Z>
__device__ __forceinline__ T L_at(const Geo& g, const LMats<T>& m, int r,
                                  int j, const Z& z) {
  if constexpr (BLK == DY) {
    return z(PY, r * g.n_nl + j);
  } else if constexpr (BLK == DSBY) {
    const T* b = m.b + j * m.sb;
    T by = T(0);
    for (int k = 0; k < g.ny; ++k) by += b[k] * z(PY, k * g.n_nl + j);
    return z(PS, j) - by;
  } else if constexpr (BLK == DQX) {
    const int p = parent_of(g, j + 1);
    const T* M = m.sqrtQ + j * m.sq + r * g.nx;
    T acc = T(0);
    for (int k = 0; k < g.nx; ++k) acc += M[k] * z(PX, k * g.n + p);
    return acc;
  } else if constexpr (BLK == DRU) {
    const int p = parent_of(g, j + 1);
    const T* M = m.sqrtR + j * m.sr + r * g.nu;
    T acc = T(0);
    for (int k = 0; k < g.nu; ++k) acc += M[k] * z(PU, k * g.n_nl + p);
    return acc;
  } else if constexpr (BLK == DT5 || BLK == DT6) {
    return T(0.5) * z(PTAU, j);
  } else if constexpr (BLK == DCX) {
    return z(PX, r * g.n + j);
  } else if constexpr (BLK == DCU) {
    return z(PU, r * g.n_nl + j);
  } else if constexpr (BLK == DQNX) {
    const T* M = m.sqrtQN + j * m.sqn + r * g.nx;
    T acc = T(0);
    for (int k = 0; k < g.nx; ++k) acc += M[k] * z(PX, k * g.n + g.n_nl + j);
    return acc;
  } else if constexpr (BLK == DS12 || BLK == DS13) {
    return T(0.5) * z(PS, g.n_nl + j);
  } else if constexpr (BLK == DCXN) {
    return z(PX, r * g.n + g.n_nl + j);
  } else if constexpr (BLK == DPNL) {
    // Gx x_j + Gu u_j
    T ax = T(0);
    for (int k = 0; k < g.nx; ++k) ax += m.Gx[r * g.nx + k] * z(PX, k * g.n + j);
    T au = T(0);
    for (int k = 0; k < g.nu; ++k) au += m.Gu[r * g.nu + k] * z(PU, k * g.n_nl + j);
    return ax + au;
  } else {
    static_assert(BLK == DPLF, "not a dual block");
    // GxN x_leaf
    T acc = T(0);
    for (int k = 0; k < g.nx; ++k) {
      acc += m.GxN[r * g.nx + k] * z(PX, k * g.n + g.n_nl + j);
    }
    return acc;
  }
}

// sum over the d children c of non-leaf node i of (M_c' w)[r] with w column
// c - 1 of the dual block W (rows a) and M_c the matrix of the edge to child
// c (M + (c - 1) stride): the child sums of L'.
template <int W, typename T, class V>
__device__ __forceinline__ T child_sum_t(const Geo& g, const T* M, int stride,
                                         int a, int r, int i, const V& v) {
  const int t = stage_of(g, i);
  T acc = T(0);
  for (int k = 0; k < g.d; ++k) {
    const int col = child_of(g, i, t, k) - 1;
    const T* Mc = M + col * stride;
    T term = T(0);
    for (int q = 0; q < a; ++q) term += Mc[q * a + r] * v(W, q * g.n_nr + col);
    acc = k == 0 ? term : acc + term;
  }
  return acc;
}

// (G' w)[r] for the polytope rows G [rows, a] and w column ``col`` of the
// dual block W (0 when the block has no rows).
template <int W, typename T, class V>
__device__ __forceinline__ T poly_t(const Geo& g, const T* G, int rows,
                                    int a, int r, int col, const V& v) {
  T acc = T(0);
  for (int q = 0; q < rows; ++q) {
    acc += G[q * a + r] * v(W, q * g.cols[W] + col);
  }
  return acc;
}

// Element (r, i) of primal block BLK of L' v, for a dual accessor v.
template <int BLK, typename T, class V>
__device__ __forceinline__ T LT_at(const Geo& g, const LMats<T>& m, int r,
                                   int i, const V& v) {
  if constexpr (BLK == PX) {
    if (i < g.n_nl) {
      return v(DCX, r * g.n_nl + i) +
             child_sum_t<DQX>(g, m.sqrtQ, m.sq, g.nx, r, i, v) +
             poly_t<DPNL>(g, m.Gx, g.nc, g.nx, r, i, v);
    }
    const int l = i - g.n_nl;
    const T* M = m.sqrtQN + l * m.sqn;
    T acc = T(0);
    for (int q = 0; q < g.nx; ++q) acc += M[q * g.nx + r] * v(DQNX, q * g.n_lf + l);
    return v(DCXN, r * g.n_lf + l) + acc +
           poly_t<DPLF>(g, m.GxN, g.ncL, g.nx, r, l, v);
  } else if constexpr (BLK == PU) {
    return v(DCU, r * g.n_nl + i) +
           child_sum_t<DRU>(g, m.sqrtR, m.sr, g.nu, r, i, v) +
           poly_t<DPNL>(g, m.Gu, g.nc, g.nu, r, i, v);
  } else if constexpr (BLK == PS) {
    if (i < g.n_nl) return v(DSBY, i);
    const int l = i - g.n_nl;
    return T(0.5) * (v(DS12, l) + v(DS13, l));
  } else if constexpr (BLK == PTAU) {
    return T(0.5) * (v(DT5, i) + v(DT6, i));
  } else {
    static_assert(BLK == PY, "not a primal block");
    return v(DY, r * g.n_nl + i) - m.b[i * m.sb + r] * v(DSBY, i);
  }
}

}  // namespace spock
