// The element-per-thread body of one Chambolle-Pock sweep of one lane, run
// by one 512-thread block: the device function behind cp_sweep.cu's kernels
// (cp_sweep_fused, cp_sweep_metric_fused, candidate_sweep_fused) and the
// element instance of sp_step.cu's step kernels, for the problems the node
// body (step_body.cuh) does not take: those with nx, nu, ny + 2 d or polytope
// rows above 32.  The node body runs every other problem.  This file also
// holds what both bodies share: the sweep's constants, the clip and cone
// helpers and the block reductions.
//
// What sweep_lane computes for its lane, at (w, u) = (z, v) or, with
// WITH_DIRECTION, at (w, u) = (z, v) + tau (dz, dv):
//   w1    = w - gamma L' u
//   wbar  = prox_f(w1): s_root - gamma; the S1 Riccati backward sweep over the
//           N - 1 stage transitions and the forward rollout from x0; the S2
//           kernel projector of each non-leaf node (its own when the risk is
//           per node) on (y; s_children; tau_children)
//   ubar  = prox_h*(u + sigma L (2 wbar - w)): the polyhedral dual cone, the
//           half-line, the two second-order cones, the boxes and the
//           two-sided polytope rows
// With WITH_METRIC also r = (w - wbar, u - ubar), M r = (r_z - gamma L' r_v,
// r_v - sigma L r_z) (stored only when asked), <r, M r> and the inf-norms of
// both halves of M r.  With WITH_DIRECTION also <r, M d> and the inf-norms
// of both halves of M d, for d = (dz, dv), without storing M d.
//
// The tree's stages are walked in a loop inside the block, with
// __syncthreads() between dependent phases: the backward Riccati sweep
// depends stage on stage, and each stage is four dependent steps.  Inside a
// phase the threads stride over the (row, node) elements of a block of the
// lane, so neighbouring threads touch neighbouring addresses; every element
// of L or L' computes its own row dot product (L_at, LT_at of
// sweep_common.cuh), so a column of an input is read once per output row.
// The intermediates live in device memory: the z-outputs first hold w1 and
// are projected in place, the dual outputs hold the prox argument before the
// cone projections, and four scratch arrays (allocated by the wrapper) hold
// the costates and the feedforward terms.  The S2 projector's argument of a
// non-leaf node (ny + 2 d values, of any size) is staged in the costate
// scratch before the projection overwrites it in the outputs.  Per-lane reductions are block
// reductions in shared memory, in a fixed order: no atomics, so the results
// are deterministic.

#pragma once

#include "sweep_common.cuh"

namespace spock {

constexpr int kThreads = 512;
constexpr int kMaxSegments = 8;

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

// The problem's constants and the sweep's scratch: everything a sweep reads
// besides the lane's pair, its direction and x0.
template <typename T>
struct SweepConsts {
  Geo g;
  LMats<T> lm;
  const T* ker;   // [1 | n_nl, mker, mker]
  int sker;       // its node stride (0 when uniform)
  const T* K;     // [N-1, nu, nx]
  const T* Rti;   // [N-1, nu, nu]
  const T* ABK;   // [N-1, d, nx, nx]
  const T* PB;    // [N-1, d, nx, nu]
  const T* Bm;    // [d, nx, nu]
  const T* xmin;  // [nx] and the other box bounds
  const T* xmax;
  const T* umin;
  const T* umax;
  const T* plo;   // [nc] polytope bounds of the non-leaf rows (null: none)
  const T* phi;
  const T* pNlo;  // [ncL] of the leaf rows
  const T* pNhi;
  // node-minor copies [rows, cols, nodes] of per-node sqrtQ, sqrtR, sqrtQN
  // (the node body's; null when the matrix is uniform)
  const T* nmQ;
  const T* nmR;
  const T* nmQN;
  // the element body's scratch
  T* gq;      // [B, qstride]: costates [nx, n], first the S2 arguments
  int64_t qstride;  // max(nx n, (ny + 2 d) n_nl)
  T* gw;      // [B, nu, mmax] u - sum_k B_k' q_k of one stage
  T* gdv;     // [B, nu, n_nl] feedforward terms
  T* ginner;  // [B, d nx, mmax] P_k B_k dvec + q_k of one stage
  Segments segs;
  T gamma, sigma;
};

// The per-lane reductions of a sweep, the same in every thread.
template <typename T>
struct SweepRed {
  T dot, nz, nv;    // <r, M r>, |M r_z|_inf, |M r_v|_inf (WITH_METRIC)
  T rho, ndz, ndv;  // <r, M d>, |M d_z|_inf, |M d_v|_inf (WITH_DIRECTION)
};

// The number of constant pointers make_consts reads before the scratch.
constexpr int kConstPtrs = kLMatPtrs + 17;

// The values of a lane's costate scratch gq in the element body: the
// costates [nx, n], and before them the S2 arguments [ny + 2 d, n_nl].
inline int64_t elem_qvalues(const Geo& g) {
  const int64_t q = static_cast<int64_t>(g.nx) * g.n;
  const int64_t ker = static_cast<int64_t>(g.ny + 2 * g.d) * g.n_nl;
  return q > ker ? q : ker;
}

// Fills the constants from the host pointer array p (in the order sqrtQ,
// sqrtR, sqrtQN, b, Gx, Gu, GxN, ker_proj, K, Rtinv, ABK, PB, B, x_min,
// x_max, u_min, u_max, p_lo, p_hi, pN_lo, pN_hi, the node-minor sqrtQ,
// sqrtR and sqrtQN, then the element body's scratch gq, gw, gdv, ginner) and
// dims (the kDims leading entries of sweep_common.cuh, then nseg and nseg
// (kind, lo, hi) triples); returns false on sizes the kernels do not take.
template <typename T>
bool make_consts(SweepConsts<T>& S, void* const* p, const int* dims,
                 double gamma, double sigma) {
  const int nseg = dims[kDims];
  if (nseg < 0 || nseg > kMaxSegments) return false;
  if (!make_geo(S.g, dims)) return false;
  make_lmats(S.lm, p, S.g, dims);
  p += kLMatPtrs;
  const int mker = S.g.ny + 2 * S.g.d;
  S.qstride = elem_qvalues(S.g);
  S.ker = static_cast<const T*>(p[0]);
  S.sker = dims[DIM_PN_RISK] ? mker * mker : 0;
  S.K = static_cast<const T*>(p[1]);
  S.Rti = static_cast<const T*>(p[2]);
  S.ABK = static_cast<const T*>(p[3]);
  S.PB = static_cast<const T*>(p[4]);
  S.Bm = static_cast<const T*>(p[5]);
  S.xmin = static_cast<const T*>(p[6]);
  S.xmax = static_cast<const T*>(p[7]);
  S.umin = static_cast<const T*>(p[8]);
  S.umax = static_cast<const T*>(p[9]);
  S.plo = static_cast<const T*>(p[10]);
  S.phi = static_cast<const T*>(p[11]);
  S.pNlo = static_cast<const T*>(p[12]);
  S.pNhi = static_cast<const T*>(p[13]);
  S.nmQ = dims[DIM_PN_Q] ? static_cast<const T*>(p[14]) : nullptr;
  S.nmR = dims[DIM_PN_R] ? static_cast<const T*>(p[15]) : nullptr;
  S.nmQN = dims[DIM_PN_QN] ? static_cast<const T*>(p[16]) : nullptr;
  S.gq = static_cast<T*>(p[17]);
  S.gw = static_cast<T*>(p[18]);
  S.gdv = static_cast<T*>(p[19]);
  S.ginner = static_cast<T*>(p[20]);
  S.segs.n = nseg;
  for (int s = 0; s < nseg; ++s) {
    S.segs.kind[s] = dims[kDims + 1 + 3 * s];
    S.segs.lo[s] = dims[kDims + 2 + 3 * s];
    S.segs.hi[s] = dims[kDims + 3 + 3 * s];
  }
  S.gamma = static_cast<T>(gamma);
  S.sigma = static_cast<T>(sigma);
  return true;
}

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

// The cycle slots of the step kernels' phase clock (ops/spstep.py's
// PHASES): the five parts of a sweep, the step's phase 2 and its commits,
// and a block's whole run.
enum PhaseSlot {
  kSlotLprimeS2,   // w1 = w - gamma L' u, the S2 projector, s_root
  kSlotBackward,   // the S1 backward sweep
  kSlotForward,    // the S1 forward rollout
  kSlotProx,       // ubar = prox_h*(u + sigma L (2 wbar - w))
  kSlotMetric,     // M r, M d and their block reductions
  kSlotAnderson,   // phase 2: residual, Anderson rows, direction
  kSlotCommit,     // phase 4 and each retrial's commit
  kSlotTotal,      // a block's first statement to its last
  kSlots,
  kSlotNone = kSlots  // a part no slot takes (set-up)
};
// Bytes of the clock's words at the end of the dynamic shared memory of a
// step kernel's block (its plan leaves them after its own values).
constexpr int kClockBytes = 96;

// The phase clock of the step kernels: where the counter's flag is on,
// thread 0 of a block reads clock64() right after the barrier that closes
// each part of the block's work and adds the cycles since its last reading
// to that part's slot; at the block's end it adds the slots to the counter.
// The words live in the block's dynamic shared memory, touched by thread 0
// alone: no barrier, and no 64-bit value held in registers across parts.
// Timing changes no value the block computes.  Every method is a no-op in
// other threads and while the flag is off.
struct PhaseClock {
  // words: the flag, the block's first reading, the last reading, the slot
  // of the part that the next sweep's opening barrier closes, the slots
  enum { kOn, kStart, kLast, kPending, kFirst, kWords = kFirst + kSlots };
  static_assert(kWords * 8 <= kClockBytes, "phase clock words");

  static __device__ __forceinline__ unsigned long long* words() {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned bytes;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
    return reinterpret_cast<unsigned long long*>(smem_raw + bytes -
                                                 kClockBytes);
  }
  static __device__ __forceinline__ unsigned long long now() {
    return static_cast<unsigned long long>(clock64());
  }
  // At the block's first statement: reads the flag of the counter (its
  // word 2).
  static __device__ __forceinline__ void begin(
      const unsigned long long* count) {
    if (threadIdx.x != 0) return;
    unsigned long long* w = words();
    w[kOn] = count[2];
    if (!w[kOn]) return;
    for (int k = 0; k < kSlots; ++k) w[kFirst + k] = 0;
    w[kPending] = kSlotNone;
    w[kStart] = w[kLast] = now();
  }
  // The part that ends here goes to ``slot`` (none for kSlotNone).
  static __device__ __forceinline__ void lap(int slot) {
    if (threadIdx.x != 0) return;
    unsigned long long* w = words();
    if (!w[kOn]) return;
    const unsigned long long t = now();
    if (slot < kSlots) w[kFirst + slot] += t - w[kLast];
    w[kLast] = t;
  }
  // The slot of the part that the next sweep's opening barrier closes.
  static __device__ __forceinline__ void pend(int slot) {
    if (threadIdx.x == 0) words()[kPending] = slot;
  }
  static __device__ __forceinline__ void lap_pending() {
    if (threadIdx.x == 0 && words()[kOn]) {
      lap(static_cast<int>(words()[kPending]));
    }
  }
  // At the block's last statement: the block's total, then every slot
  // added to the counter's words 3, 4, ...
  static __device__ __forceinline__ void end(unsigned long long* count) {
    if (threadIdx.x != 0) return;
    unsigned long long* w = words();
    if (!w[kOn]) return;
    w[kFirst + kSlotTotal] = now() - w[kStart];
    for (int k = 0; k < kSlots; ++k) atomicAdd(count + 3 + k, w[kFirst + k]);
  }
};

// The clock of the sweeps that other kernels run: every method compiles
// to nothing.
struct NoClock {
  static __device__ __forceinline__ void lap(int) {}
  static __device__ __forceinline__ void lap_pending() {}
};

// One sweep of lane ``lane``, read through ``c``, into the output pair ``o``;
// M r goes to ``mr`` unless it is null.  ``x0`` is the lane's [nx] root
// state, ``sh`` kThreads values of shared memory.  Ends with a barrier when
// WITH_METRIC; without it the caller syncs before reading ``o``.  ``Clk``
// times its parts (PhaseClock in the step kernels).
template <typename T, bool WITH_METRIC, bool WITH_DIRECTION,
          class Clk = NoClock>
__device__ SweepRed<T> sweep_lane(const SweepConsts<T>& P, int64_t lane,
                                  const Cand<T, WITH_DIRECTION>& c,
                                  const Ref<T>& o, const Ref<T>* mr,
                                  const T* x0, T* sh) {
  SweepRed<T> red{T(0), T(0), T(0), T(0), T(0), T(0)};
  const Geo& g = P.g;
  const int tid = threadIdx.x;
  const T gamma = P.gamma;
  const T sigma = P.sigma;
  T* gq = P.gq + lane * P.qstride;
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

  // ---- S2 projector per non-leaf node, in place: the node's argument
  // (y; s_children; tau_children), staged as column i of [mker, n_nl] in gq
  // (every entry of it is the thread's own), then each row of the projector
  // against it; s_root shift; the leaf costates q = -x1 that start the
  // backward sweep ----
  const int mker = g.ny + 2 * g.d;
  for (int i = tid; i < n_nl; i += kThreads) {
    const int t = stage_of(g, i);
    const T* ker = P.ker + i * P.sker;
    // entry a of the node's argument in the outputs
    auto arg = [&](int a) -> T& {
      if (a < g.ny) return o(PY, a * n_nl + i);
      const bool s = a < g.ny + g.d;
      const int ch = child_of(g, i, t, a - g.ny - (s ? 0 : g.d));
      return s ? o(PS, ch) : o(PTAU, ch - 1);
    };
    for (int a = 0; a < mker; ++a) gq[a * n_nl + i] = arg(a);
    for (int a = 0; a < mker; ++a) {
      T acc = T(0);
      for (int b = 0; b < mker; ++b) acc += ker[a * mker + b] * gq[b * n_nl + i];
      arg(a) = acc;
    }
  }
  if (tid == 0) o(PS, 0) = o(PS, 0) - gamma;
  __syncthreads();  // the S2 arguments in gq are done with
  for (int e = tid; e < nx * g.n_lf; e += kThreads) {
    const int idx = (e / g.n_lf) * n + n_nl + e % g.n_lf;
    gq[idx] = -o(PX, idx);
  }
  __syncthreads();
  Clk::lap(kSlotLprimeS2);

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
  Clk::lap(kSlotBackward);

  // ---- S1 forward rollout from x0: u = K x + dvec, x_child = ABK_k x +
  // B_k dvec ----
  for (int r = tid; r < nx; r += kThreads) o(PX, r * n) = x0[r];
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
  Clk::lap(kSlotForward);

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
      } else if constexpr (BLK == DPNL) {
        w = sigma * (w - clip(w, P.plo[r], P.phi[r]));
      } else if constexpr (BLK == DPLF) {
        w = sigma * (w - clip(w, P.pNlo[r], P.pNhi[r]));
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
  if constexpr (!WITH_METRIC) return red;
  __syncthreads();
  Clk::lap(kSlotProx);

  // ---- M r for r = (w - wbar, u - ubar), <r, M r>, inf-norms ----
  const Diff<T, Cand<T, WITH_DIRECTION>, Ref<T>> res{c, o};
  T dot = T(0), nz = T(0), nv = T(0);
  each_primal([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int i, int idx) {
      const T rv = res(BLK, idx);
      const T val = rv - gamma * LT_at<BLK>(g, P.lm, r, i, res);
      if (mr) (*mr)(BLK, idx) = val;
      dot += rv * val;
      nz = absmax(nz, val);
    });
  });
  each_dual([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int j, int idx) {
      const T rv = res(BLK, idx);
      const T val = rv - sigma * L_at<BLK>(g, P.lm, r, j, res);
      if (mr) (*mr)(BLK, idx) = val;
      dot += rv * val;
      nv = absmax(nv, val);
    });
  });
  red.dot = block_sum(dot, sh);
  red.nz = block_max(nz, sh);
  red.nv = block_max(nv, sh);
  Clk::lap(kSlotMetric);
  if constexpr (!WITH_DIRECTION) return red;

  // ---- <r, M d> and the inf-norms of M d, M d never stored ----
  const Ref<T>& dref = c.d;
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
  red.rho = block_sum(rho, sh);
  red.ndz = block_max(ndz, sh);
  red.ndv = block_max(ndv, sh);
  Clk::lap(kSlotMetric);
  return red;
}

}  // namespace spock
