// One whole Chambolle-Pock sweep per lane in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of spock_tpu/ops/pallas_sweep.py (the kernel
// body _make_kernel and its three entry points):
//   cp_sweep_fused         (WITH_METRIC = false)
//   cp_sweep_metric_fused  (WITH_METRIC = true)
//   candidate_sweep_fused  (WITH_METRIC = WITH_DIRECTION = true)
// Their plain PyTorch versions are cp_sweep_ref, cp_sweep_metric_ref and
// candidate_sweep_ref in spock_tpu_torch/algorithms/common.py; the wrappers,
// the launch counts and the checks live in spock_tpu_torch/ops/sweep_kernels.py.
//
// What one launch computes for every lane, at (w, u) = (z, v) or, with
// WITH_DIRECTION, at (w, u) = (z, v) + tau (dz, dv) with a per-lane tau:
//   w1    = w - gamma L' u
//   wbar  = prox_f(w1): s_root - gamma; the S1 Riccati backward sweep over the
//           N - 1 stage transitions and the forward rollout from x0; the S2
//           kernel projector per non-leaf node on (y; s_children; tau_children)
//   ubar  = prox_h*(u + sigma L (2 wbar - w)): the polyhedral dual cone, the
//           half-line, the two second-order cones and the boxes
// With WITH_METRIC also r = (w - wbar, u - ubar), M r = (r_z - gamma L' r_v,
// r_v - sigma L r_z), <r, M r> and the inf-norms of both halves of M r.  With
// WITH_DIRECTION also <r, M d> and the inf-norms of both halves of M d, for
// d = (dz, dv), without storing M d.
//
// What bounds it: memory.  Every lane reads its iterate (and direction) and
// writes its outputs once; at the headline size (B = 128 lanes of
// server_heat N=10 nx=nu=20 d=2, float32, 123,214 values a pair) that is
// 126 MB for the plain sweep and 252 MB for the candidate sweep, 38-75 us at
// 3.35 TB/s, against 1.4-2.6 GFLOP of arithmetic (21-39 us at 67 TFLOP/s).
//
// Design (simple and right first): one thread block per lane, 512 threads.
// The tree's stages are walked in a loop inside the block, with
// __syncthreads() between dependent phases: the backward Riccati sweep
// depends stage on stage, and each stage is four dependent steps.  Inside a
// phase the threads stride over the (row, node) elements of a block of the
// lane, so neighbouring threads touch neighbouring addresses.  A lane's
// working set (~0.5 MB) does not fit in shared memory, so the intermediates
// live in device memory (L2-resident at this size): the z-outputs first hold
// w1 and are projected in place, the dual outputs hold the prox argument
// before the cone projections, and four scratch arrays (allocated by the
// wrapper) hold the costates and the feedforward terms.  Per-lane reductions
// are block reductions in shared memory, in a fixed order: no atomics, so
// the results are deterministic.  At B = 128 the launch fills 128 of the 132
// SMs with one block each; nothing more is done about the memory bound yet.

#include "sweep_common.cuh"

namespace spock {
namespace {

constexpr int kThreads = 512;
constexpr int kMaxSegments = 8;
constexpr int kMaxKer = 32;  // ny + 2 d, the S2 projector's size

// Kind codes of the dual-cone row segments (same as sweep_kernels.py).
constexpr int kZero = 0;
constexpr int kNonneg = 1;
constexpr int kNonpos = 2;

struct Segments {
  int n;
  int kind[kMaxSegments];
  int lo[kMaxSegments];
  int hi[kMaxSegments];
};

template <typename T>
struct SweepParams {
  Geo g;
  Pair<T> in, dir, out, mr;
  T* scal[6];  // [B] each: <r,Mr>, |Mr_z|, |Mr_v|, <r,Md>, |Md_z|, |Md_v|
  const T* x0;   // [B, nx]
  const T* tau;  // [B]
  LMats<T> lm;
  const T* ker;   // [mker, mker]
  const T* K;     // [N-1, nu, nx]
  const T* Rti;   // [N-1, nu, nu]
  const T* ABK;   // [N-1, d, nx, nx]
  const T* PB;    // [N-1, d, nx, nu]
  const T* Bm;    // [d, nx, nu]
  const T* xmin;  // [nx] and the other box bounds
  const T* xmax;
  const T* umin;
  const T* umax;
  T* gq;      // [B, nx, n] costates
  T* gw;      // [B, nu, mmax] u - sum_k B_k' q_k of one stage
  T* gdv;     // [B, nu, n_nl] feedforward terms
  T* ginner;  // [B, d nx, mmax] P_k B_k dvec + q_k of one stage
  Segments segs;
  T gamma, sigma;
};

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T clip(T w, T lo, T hi) {
  // min(max(w, lo), hi); NaN passes through as in torch.clamp
  const T c = w < lo ? lo : w;
  return c > hi ? hi : c;
}

template <typename T>
__device__ __forceinline__ T absmax(T m, T a) {
  // max(m, |a|) that keeps a NaN, as torch.amax does
  const T b = a < T(0) ? -a : a;
  return (b > m || b != b) ? b : m;
}

// SOC projection factors from t and ||x||^2 (the JAX kernel's _soc_pieces).
template <typename T>
__device__ __forceinline__ void soc_pieces(T t, T xn_sq, T& t_out, T& scale) {
  const T xn = root(xn_sq);
  const bool inside = xn <= t;
  const bool polar = xn <= -t;
  const T safe = xn > T(0) ? xn : T(1);
  const T t_new = (t + xn) / T(2);
  t_out = inside ? t : (polar ? T(0) : t_new);
  scale = inside ? T(1) : (polar ? T(0) : t_new / safe);
}

// Block-wide sum and NaN-keeping max over kThreads partial values, in a fixed
// tree order; every thread gets the result.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ T block_max(T v, T* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = absmax(sh[tid], sh[tid + s]);
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

template <typename T, bool WITH_METRIC, bool WITH_DIRECTION>
__global__ void __launch_bounds__(kThreads)
cp_sweep_kernel(const __grid_constant__ SweepParams<T> P) {
  __shared__ T sh[kThreads];
  const Geo& g = P.g;
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const T gamma = P.gamma;
  const T sigma = P.sigma;
  const T tau = WITH_DIRECTION ? P.tau[lane] : T(0);
  const Cand<T, WITH_DIRECTION> c{Ref<T>{&P.in, &g, lane},
                                  Ref<T>{&P.dir, &g, lane}, tau};
  const Ref<T> o{&P.out, &g, lane};
  T* gq = P.gq + lane * g.nx * g.n;
  T* gw = P.gw + lane * g.nu * g.mmax;
  T* gdv = P.gdv + lane * g.nu * g.n_nl;
  T* gin = P.ginner + lane * g.d * g.nx * g.mmax;
  const int nx = g.nx, nu = g.nu, n = g.n, n_nl = g.n_nl, mmax = g.mmax;

  // ---- w1 = w - gamma L' u, into the z-outputs ----
  each_primal([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int i, int idx) {
      o(BLK, idx) = c(BLK, idx) - gamma * LT_at<BLK>(g, P.lm, r, i, c);
    });
  });
  __syncthreads();

  // ---- S2 projector per non-leaf node, in place; s_root shift; the leaf
  // costates q = -x1 that start the backward sweep ----
  const int mker = g.ny + 2 * g.d;
  for (int i = tid; i < n_nl; i += kThreads) {
    const int t = stage_of(g, i);
    T vec[kMaxKer];
    for (int k = 0; k < g.ny; ++k) vec[k] = o(PY, k * n_nl + i);
    for (int k = 0; k < g.d; ++k) {
      const int ch = child_of(g, i, t, k);
      vec[g.ny + k] = o(PS, ch);
      vec[g.ny + g.d + k] = o(PTAU, ch - 1);
    }
    T res[kMaxKer];
    for (int a = 0; a < mker; ++a) {
      T acc = T(0);
      for (int b = 0; b < mker; ++b) acc += P.ker[a * mker + b] * vec[b];
      res[a] = acc;
    }
    for (int k = 0; k < g.ny; ++k) o(PY, k * n_nl + i) = res[k];
    for (int k = 0; k < g.d; ++k) {
      const int ch = child_of(g, i, t, k);
      o(PS, ch) = res[g.ny + k];
      o(PTAU, ch - 1) = res[g.ny + g.d + k];
    }
  }
  if (tid == 0) o(PS, 0) = o(PS, 0) - gamma;
  for (int e = tid; e < nx * g.n_lf; e += kThreads) {
    const int idx = (e / g.n_lf) * n + n_nl + e % g.n_lf;
    gq[idx] = -o(PX, idx);
  }
  __syncthreads();

  // ---- S1 backward sweep: costates q and feedforward dvec, stage by stage
  // (x1, u1 are the targets held in the z-outputs) ----
  for (int st = g.N - 2; st >= 0; --st) {
    const int m = g.off[st + 1] - g.off[st];
    const int base = g.off[st];
    const int cb = g.off[st + 1];
    const T* K = P.K + st * nu * nx;
    const T* Rti = P.Rti + st * nu * nu;
    const T* ABK = P.ABK + st * g.d * nx * nx;
    const T* PB = P.PB + st * g.d * nx * nu;
    // w = u1 - sum_k B_k' q_k
    for (int e = tid; e < nu * m; e += kThreads) {
      const int cc = e / m, l = e % m;
      T sum_d = T(0);
      for (int k = 0; k < g.d; ++k) {
        T term = T(0);
        for (int r = 0; r < nx; ++r) {
          term += P.Bm[(k * nx + r) * nu + cc] * gq[r * n + cb + k * m + l];
        }
        sum_d = k == 0 ? term : sum_d + term;
      }
      gw[cc * mmax + l] = o(PU, cc * n_nl + base + l) - sum_d;
    }
    __syncthreads();
    // dvec = Rtinv w
    for (int e = tid; e < nu * m; e += kThreads) {
      const int cc = e / m, l = e % m;
      T acc = T(0);
      for (int k = 0; k < nu; ++k) acc += Rti[cc * nu + k] * gw[k * mmax + l];
      gdv[cc * n_nl + base + l] = acc;
    }
    __syncthreads();
    // inner_k = P_k B_k dvec + q_k
    for (int e = tid; e < g.d * nx * m; e += kThreads) {
      const int kr = e / m, l = e % m;
      const int k = kr / nx, r = kr % nx;
      T acc = T(0);
      for (int cc = 0; cc < nu; ++cc) {
        acc += PB[(k * nx + r) * nu + cc] * gdv[cc * n_nl + base + l];
      }
      gin[kr * mmax + l] = acc + gq[r * n + cb + k * m + l];
    }
    __syncthreads();
    // q_i = sum_k ABK_k' inner_k + K' (dvec - u1) - x1
    for (int e = tid; e < nx * m; e += kThreads) {
      const int r = e / m, l = e % m;
      T qi = T(0);
      for (int k = 0; k < g.d; ++k) {
        T term = T(0);
        for (int q = 0; q < nx; ++q) {
          term += ABK[(k * nx + q) * nx + r] * gin[(k * nx + q) * mmax + l];
        }
        qi = k == 0 ? term : qi + term;
      }
      T kt = T(0);
      for (int cc = 0; cc < nu; ++cc) {
        const int ui = cc * n_nl + base + l;
        kt += K[cc * nx + r] * (gdv[ui] - o(PU, ui));
      }
      gq[r * n + base + l] = (qi + kt) - o(PX, r * n + base + l);
    }
    __syncthreads();
  }

  // ---- S1 forward rollout from x0: u = K x + dvec, x_child = ABK_k x +
  // B_k dvec ----
  for (int r = tid; r < nx; r += kThreads) o(PX, r * n) = P.x0[lane * nx + r];
  __syncthreads();
  for (int st = 0; st < g.N - 1; ++st) {
    const int m = g.off[st + 1] - g.off[st];
    const int base = g.off[st];
    const int cb = g.off[st + 1];
    const T* K = P.K + st * nu * nx;
    const T* ABK = P.ABK + st * g.d * nx * nx;
    for (int e = tid; e < nu * m; e += kThreads) {
      const int cc = e / m, l = e % m;
      T acc = T(0);
      for (int r = 0; r < nx; ++r) acc += K[cc * nx + r] * o(PX, r * n + base + l);
      o(PU, cc * n_nl + base + l) = acc + gdv[cc * n_nl + base + l];
    }
    for (int e = tid; e < g.d * nx * m; e += kThreads) {
      const int kr = e / m, l = e % m;
      const int k = kr / nx, r = kr % nx;
      T ax = T(0);
      for (int q = 0; q < nx; ++q) {
        ax += ABK[(k * nx + r) * nx + q] * o(PX, q * n + base + l);
      }
      T bd = T(0);
      for (int cc = 0; cc < nu; ++cc) {
        bd += P.Bm[(k * nx + r) * nu + cc] * gdv[cc * n_nl + base + l];
      }
      o(PX, r * n + cb + k * m + l) = ax + bd;
    }
    __syncthreads();
  }

  // ---- ubar = prox_h*(u + sigma L (2 wbar - w)); first the prox argument
  // p = u1 / sigma with the epigraph shifts, projected at once where the
  // projection is per element ----
  const Refl<T, Cand<T, WITH_DIRECTION>> refl{o, c};
  const T inv = T(1) / sigma;
  each_dual([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int j, int idx) {
      T w = (c(BLK, idx) + sigma * L_at<BLK>(g, P.lm, r, j, refl)) * inv;
      if constexpr (BLK == DT5 || BLK == DS12) w -= T(0.5);
      if constexpr (BLK == DT6 || BLK == DS13) w += T(0.5);
      if constexpr (BLK == DY) {
        int kind = 3;
        for (int s = 0; s < P.segs.n; ++s) {
          if (r >= P.segs.lo[s] && r < P.segs.hi[s]) kind = P.segs.kind[s];
        }
        T p = w;
        if (kind == kNonneg) {
          p = w < T(0) ? T(0) : w;
        } else if (kind == kNonpos) {
          p = w > T(0) ? T(0) : w;
        } else if (kind == kZero) {
          p = T(0);
        }
        w = sigma * (w - p);
      } else if constexpr (BLK == DSBY) {
        w = sigma * (w - (w < T(0) ? T(0) : w));
      } else if constexpr (BLK == DCX || BLK == DCXN) {
        w = sigma * (w - clip(w, P.xmin[r], P.xmax[r]));
      } else if constexpr (BLK == DCU) {
        w = sigma * (w - clip(w, P.umin[r], P.umax[r]));
      }
      o(BLK, idx) = w;  // SOC blocks: the argument, projected below
    });
  });
  __syncthreads();
  // the second-order cones, one thread per column: (t6; qx, ru, t5) per
  // non-root node, (s13; qNx, s12) per leaf
  for (int j = tid; j < g.n_nr + g.n_lf; j += kThreads) {
    if (j < g.n_nr) {
      const int nr = g.n_nr;
      T acc = T(0);
      for (int r = 0; r < nx; ++r) acc += o(DQX, r * nr + j) * o(DQX, r * nr + j);
      for (int r = 0; r < nu; ++r) acc += o(DRU, r * nr + j) * o(DRU, r * nr + j);
      const T t5 = o(DT5, j);
      acc += t5 * t5;
      T t_out, xs;
      const T t6 = o(DT6, j);
      soc_pieces(t6, acc, t_out, xs);
      o(DT6, j) = sigma * (t6 - t_out);
      for (int r = 0; r < nx; ++r) {
        const T w = o(DQX, r * nr + j);
        o(DQX, r * nr + j) = sigma * (w - xs * w);
      }
      for (int r = 0; r < nu; ++r) {
        const T w = o(DRU, r * nr + j);
        o(DRU, r * nr + j) = sigma * (w - xs * w);
      }
      o(DT5, j) = sigma * (t5 - xs * t5);
    } else {
      const int l = j - g.n_nr, nl = g.n_lf;
      T acc = T(0);
      for (int r = 0; r < nx; ++r) acc += o(DQNX, r * nl + l) * o(DQNX, r * nl + l);
      const T s12 = o(DS12, l);
      acc += s12 * s12;
      T t_out, xs;
      const T s13 = o(DS13, l);
      soc_pieces(s13, acc, t_out, xs);
      o(DS13, l) = sigma * (s13 - t_out);
      for (int r = 0; r < nx; ++r) {
        const T w = o(DQNX, r * nl + l);
        o(DQNX, r * nl + l) = sigma * (w - xs * w);
      }
      o(DS12, l) = sigma * (s12 - xs * s12);
    }
  }
  if constexpr (!WITH_METRIC) return;
  __syncthreads();

  // ---- M r for r = (w - wbar, u - ubar), <r, M r>, inf-norms ----
  const Diff<T, Cand<T, WITH_DIRECTION>, Ref<T>> res{c, o};
  const Ref<T> mr{&P.mr, &g, lane};
  T dot = T(0), nz = T(0), nv = T(0);
  each_primal([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int i, int idx) {
      const T rv = res(BLK, idx);
      const T val = rv - gamma * LT_at<BLK>(g, P.lm, r, i, res);
      mr(BLK, idx) = val;
      dot += rv * val;
      nz = absmax(nz, val);
    });
  });
  each_dual([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int j, int idx) {
      const T rv = res(BLK, idx);
      const T val = rv - sigma * L_at<BLK>(g, P.lm, r, j, res);
      mr(BLK, idx) = val;
      dot += rv * val;
      nv = absmax(nv, val);
    });
  });
  dot = block_sum(dot, sh);
  nz = block_max(nz, sh);
  nv = block_max(nv, sh);
  if (tid == 0) {
    P.scal[0][lane] = dot;
    P.scal[1][lane] = nz;
    P.scal[2][lane] = nv;
  }
  if constexpr (!WITH_DIRECTION) return;

  // ---- <r, M d> and the inf-norms of M d, M d never stored ----
  const Ref<T> dref{&P.dir, &g, lane};
  T rho = T(0), ndz = T(0), ndv = T(0);
  each_primal([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int i, int idx) {
      const T val = dref(BLK, idx) - gamma * LT_at<BLK>(g, P.lm, r, i, dref);
      rho += res(BLK, idx) * val;
      ndz = absmax(ndz, val);
    });
  });
  each_dual([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int j, int idx) {
      const T val = dref(BLK, idx) - sigma * L_at<BLK>(g, P.lm, r, j, dref);
      rho += res(BLK, idx) * val;
      ndv = absmax(ndv, val);
    });
  });
  rho = block_sum(rho, sh);
  ndz = block_max(ndz, sh);
  ndv = block_max(ndv, sh);
  if (tid == 0) {
    P.scal[3][lane] = rho;
    P.scal[4][lane] = ndz;
    P.scal[5][lane] = ndv;
  }
}

// Pointer order of the host array ``ptrs`` (see sweep_kernels.py):
//   [0, 17) z, v   [17, 34) dz, dv   [34, 51) zbar, vbar   [51, 68) M r
//   [68, 74) the six [B] scalar outputs   74 x0   75 tau
//   76 sqrtQ  77 sqrtR  78 sqrtQN  79 b  80 ker_proj  81 K  82 Rtinv  83 ABK
//   84 PB  85 B  86 x_min  87 x_max  88 u_min  89 u_max
//   90 gq  91 gw  92 gdv  93 ginner
// Unused pointers (the direction without WITH_DIRECTION, ...) may be null.

// dims: nx, nu, ny, N, d, nseg, then nseg (kind, lo, hi) triples.
template <typename T>
int launch(const void* ptrs, const int* dims, double gamma, double sigma,
           int metric, int direction, int B, void* stream) {
  const int nseg = dims[5];
  if (nseg < 0 || nseg > kMaxSegments || B < 0 || (direction && !metric)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SweepParams<T> P;
  if (!make_geo(P.g, dims[0], dims[1], dims[2], dims[3], dims[4]) ||
      P.g.ny + 2 * P.g.d > kMaxKer) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* const* p = static_cast<void* const*>(ptrs);
  for (int b = 0; b < kPairBlocks; ++b) {
    P.in.p[b] = static_cast<T*>(p[b]);
    P.dir.p[b] = static_cast<T*>(p[17 + b]);
    P.out.p[b] = static_cast<T*>(p[34 + b]);
    P.mr.p[b] = static_cast<T*>(p[51 + b]);
  }
  for (int k = 0; k < 6; ++k) P.scal[k] = static_cast<T*>(p[68 + k]);
  P.x0 = static_cast<const T*>(p[74]);
  P.tau = static_cast<const T*>(p[75]);
  P.lm = LMats<T>{static_cast<const T*>(p[76]), static_cast<const T*>(p[77]),
                  static_cast<const T*>(p[78]), static_cast<const T*>(p[79])};
  P.ker = static_cast<const T*>(p[80]);
  P.K = static_cast<const T*>(p[81]);
  P.Rti = static_cast<const T*>(p[82]);
  P.ABK = static_cast<const T*>(p[83]);
  P.PB = static_cast<const T*>(p[84]);
  P.Bm = static_cast<const T*>(p[85]);
  P.xmin = static_cast<const T*>(p[86]);
  P.xmax = static_cast<const T*>(p[87]);
  P.umin = static_cast<const T*>(p[88]);
  P.umax = static_cast<const T*>(p[89]);
  P.gq = static_cast<T*>(p[90]);
  P.gw = static_cast<T*>(p[91]);
  P.gdv = static_cast<T*>(p[92]);
  P.ginner = static_cast<T*>(p[93]);
  P.segs.n = nseg;
  for (int s = 0; s < nseg; ++s) {
    P.segs.kind[s] = dims[6 + 3 * s];
    P.segs.lo[s] = dims[7 + 3 * s];
    P.segs.hi[s] = dims[8 + 3 * s];
  }
  P.gamma = static_cast<T>(gamma);
  P.sigma = static_cast<T>(sigma);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!metric) {
    cp_sweep_kernel<T, false, false><<<B, kThreads, 0, s>>>(P);
  } else if (!direction) {
    cp_sweep_kernel<T, true, false><<<B, kThreads, 0, s>>>(P);
  } else {
    cp_sweep_kernel<T, true, true><<<B, kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace spock

// C entry points, bound with ctypes.  ptrs: host array of the 94 device
// pointers in the order above; dims: host int array.  One thread block per
// lane.  Returns cudaGetLastError().
extern "C" int cp_sweep_f32(const void* ptrs, const int* dims, double gamma,
                            double sigma, int metric, int direction, int B,
                            void* stream) {
  return spock::launch<float>(ptrs, dims, gamma, sigma, metric, direction, B,
                              stream);
}

extern "C" int cp_sweep_f64(const void* ptrs, const int* dims, double gamma,
                            double sigma, int metric, int direction, int B,
                            void* stream) {
  return spock::launch<double>(ptrs, dims, gamma, sigma, metric, direction, B,
                               stream);
}
