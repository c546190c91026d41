// One whole SuperMann iteration per lane in one launch, and its backtracking
// retrials, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   spock_tpu/ops/pallas_spstep.py:1340     sp_step_fused (lane-packed)
//   spock_tpu/ops/pallas_spstep_lt.py:1093  sp_step_fused (lane-tiled)
// the first at any per-lane tau, the second at tau = 1.
// Their plain PyTorch versions are sp_step_ref and sp_backtrack_ref (built
// on the one-trial sp_retrial_ref) in spock_tpu_torch/ops/spstep.py, which
// also holds the wrappers, the launch counts and the checks.
//
// It takes the JAX step kernels' problem class: uniform costs, risk data
// uniform or per node, with or without polytope rows, at any nx, nu, ny + 2 d
// and polytope rows.
//
// sp_step, one block per lane, from its scalar pack (active, valid1,
// valid2, cache, r_safe, q_pow, rnorm_c, nMrz_c, nMrv_c, tau):
//   1. (zbar, vbar): the cache pair if the lane's cache flag is set, else a
//      fresh sweep at (z, v) (step_body.cuh) with ||r||_M and the inf-norms
//      of M r, into the kept ``fresh`` pair; the choice is a pointer;
//   2. r = (z, v) - (zbar, vbar); y = r - valid1 r_prev; p = valid1 s_prev - y
//      (the caller's new Anderson row pair); the next r_prev; in the same
//      pass the nine sums of the window-3 Gram of (y, y1, y2) and of its
//      right side against r; the regularised, scaled closed-form 3x3 solve
//      for (g0, g1, g2), and d = -r - g0 p - g1 p1 - g2 p2 into the kept
//      ``d`` pair;
//   3. the candidate sweep at (z, v) + tau d into w, the next cache:
//      <r~, M r~>, <r~, M d> and the four inf-norms (M r~, M d not stored);
//   4. thread 0 makes the K1 / K2 / fallback choice; a last pass writes
//      z_new and s_new = z_new - z, then the 13 output scalars, and the
//      lane's kept scalars (||r||_M, the inf-norms of M r, g0-g2, cached).
// sp_backtrack, one block per lane, after the tau = 1 launch of the same
// iteration: a lane that launch left looping (its output scalars' loop
// flag) runs its whole geometric backtracking sequence tau = beta, beta^2,
// ... in its block, up to max_backtracks trials, and stops at the first K1
// or K2 acceptance; each trial is phases 3 and 4 only, on the zbar and d
// that the tau = 1 launch kept (z has not moved, so phases 1-2 would
// compute them again), and writes z_new and s in place into the tau = 1
// launch's outputs at that lane.  A lane that does not loop exits at once
// and copies its tau = 1 output scalars.  The output scalars are [B, 16],
// the last trial's at a looping lane, with the trials made in slot 13; the
// lanes that looped and the trials made are also added to a device
// counter.  The lane's r_safe and q_pow do not change between its trials
// (the host loop this replaces took a trial's scalars only where it
// accepted), so the result of a lane is that loop's, with no host sync.
// All reductions are fixed-order block reductions: launches are
// deterministic.
//
// Both kernels carry the phase clock (sweep_body.cuh's PhaseClock): where
// word 2 of the device counter is set (ops/spstep.py's set_phase_timing),
// thread 0 of a block adds the clock64() cycles of each part of its work
// (the five parts of every sweep it runs, phase 2, each commit, and its
// whole run) to the counter's words 3, 4, ... (spstep.PHASES).  It adds no
// barrier and changes no value; a backtrack block whose lane does not loop
// exits before it.
//
// What bounds it: memory.  A lane reads 8 pairs (z, cache, r_prev, s_prev
// and the four Anderson rows) and writes 6 (z_new, w, r, s, y, p); at the
// headline size (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32,
// 123,214 values a pair) that is 14 x 63.1 MB = 883 MB, 0.26 ms at
// 3.35 TB/s, against ~3.5 GFLOP of arithmetic (0.05 ms at 67 TFLOP/s).
// The backtrack reads z, d and zbar and writes z_new and s at each
// looping lane (the kernel passes over them once a trial), with the
// candidate sweep's arithmetic a trial; a lane that does not loop moves 16
// scalars.
//
// Design.  One 512-thread block per lane (16 warps; its sweeps need the
// whole lane).  Each kernel has two instances, one per sweep body, chosen on
// the host by the problem's class and passed in (as for cp_sweep.cu); the
// phases around the sweeps are the same code in both:
//   * the node instance, where nx, nu, ny + 2 d and the polytope rows of a
//     node are at most 32 and the shared-memory plan fits: its sweeps
//     (step_body.cuh) compute L and L' a node per thread from columns held
//     in registers and matrices staged once in shared memory, fuse the S2
//     projector and the cone projections into the passes that form their
//     arguments, compute M r and M d in one traversal, and run the Riccati
//     sweeps a node per thread group with the stage's matrices and costates
//     in shared memory (135 KB of it in float32, 221 KB in float64 at the
//     headline size);
//   * the element instance for every other problem: its sweeps are
//     sweep_body.cuh's sweep_lane, the threads striding over the (row, node)
//     elements of each block, with four wrapper-allocated scratch arrays in
//     device memory for the Riccati intermediates (and the S2 arguments);
//     its dynamic shared memory is the reduction scratch alone.
// The streaming passes of phases 2 and 4 load four
// elements a thread before they store, neighbouring threads on neighbouring
// addresses.  A backtrack runs no phase 1-2 and only for the looping
// lanes, all of an iteration's trials in one launch.  On the H100 a lane is
// bound by the latency of its own block (the waits for device memory of a
// node's thread and the Riccati stages), not by bandwidth: the backtrack of
// one lane takes most of the time of one of all 128 (chip_smoke.py times
// both).
//
// Built in four parts by four nvcc processes at once (ops/_build.py):
// SPOCK_PART 4 compiles the float instances, 8 the double ones; SPOCK_BODY 1
// the node instances and the C entries, 0 the element instances and their
// launchers.  Without them, one nvcc builds all.

// the step kernels' class has uniform costs: no per-node paths in the body
#define SPOCK_NODE_COSTS 0
#include "step_body.cuh"

#ifndef SPOCK_PART
#define SPOCK_PART 0
#endif
#ifndef SPOCK_BODY
#define SPOCK_BODY 2
#endif

namespace spock {

// The body codes of the C entries (ops/spstep.py's, sweep_kernels.py's
// BODY_CODE).
constexpr int kElementBody = 0;
constexpr int kNodeBody = 1;

// The element instances' launchers (outside the anonymous namespace: they
// link across the parts).
template <typename T>
int launch_step_element(const void* ptrs, const int* dims,
                        const double* coefs, int B, void* stream);
template <typename T>
int launch_backtrack_element(const void* ptrs, const int* dims,
                             const double* coefs, int B, int max_bt,
                             void* stream);

namespace {

// Slots of the [B, 10] scalar pack, of the [B, 16] output scalars (the JAX
// kernel's _SC_* and _OC_* numbers) and of the [B, 8] kept scalars.
constexpr int kScIn = 10;
constexpr int kScOut = 16;
constexpr int kKeep = 8;
enum { SC_ACTIVE, SC_VALID1, SC_VALID2, SC_CACHE, SC_RSAFE, SC_QPOW, SC_RNC,
       SC_NMZC, SC_NMVC, SC_TAU };
enum { OC_K1, OC_K2, OC_LOOP, OC_RN, OC_RT, OC_RSAFE, OC_XI1, OC_XI2,
       OC_NMRWZ, OC_NMRWV, OC_G0, OC_G1, OC_G2, kOcUsed };
// the backtrack's trials made, in its output scalars
constexpr int kOcTrials = kOcUsed;
enum { KP_RN, KP_NMZ, KP_NMV, KP_G0, KP_G1, KP_G2, KP_CACHED };

constexpr int kInPairs = 8;
constexpr int kOutPairs = 6;

template <typename T>
struct StepParams {
  StepConsts<T> x;
  // inputs: z, cache, r_prev, s_prev, the MR rows of age 1 and 2, the MP
  // rows of age 1 and 2
  Pair<T> z, cache, rp, sp, a1r, a2r, a1p, a2p;
  Pair<T> zn, w, r, s, y, p;  // outputs
  Pair<T> fresh, d;           // kept: the fresh sweep, the direction
  const T* x0;    // [B, nx]
  const T* scal;  // [B, kScIn]
  T* oscal;       // [B, kScOut]
  T* keep;        // [B, kKeep]
  T* gdv;         // node scratch [B, n_nl ldu]
  T* qg;          // node scratch [B, qsize] (costates outside shared memory)
  unsigned long long* count;  // the counter: [2] the phase clock's flag,
                              // [3, 3 + kSlots) its cycles (added to)
  T c1, sigma_k2, lam, lam_sp;
};

template <typename T>
struct BacktrackParams {
  StepConsts<T> x;
  Pair<T> z, cache, fresh, d;  // inputs, by lane
  Pair<T> zn, s;               // the tau = 1 launch's outputs, by lane
  Pair<T> w;                   // scratch: the candidate's sweep, by lane
  const T* x0;                 // [B, nx]
  const T* scal;               // [B, kScIn]: the tau = 1 launch's pack
  const T* keep;               // [B, kKeep]
  const T* oscal1;             // [B, kScOut]: the tau = 1 launch's scalars
  T* oscal;                    // [B, kScOut]
  T* gdv;                      // node scratch [B, n_nl ldu]
  T* qg;                       // node scratch [B, qsize]
  unsigned long long* count;   // the counter: [0, 2) lanes looped, trials
                               // made; the phase clock's as for StepParams
  T c1, sigma_k2, lam, lam_sp, beta;
  int max_bt;
};

// 16 pairs of 19 pointers and the constants: within the 4 KB of kernel
// parameters that every CUDA 12 toolkit takes.
static_assert(sizeof(StepParams<double>) <= 4096, "kernel parameters > 4 KB");
static_assert(sizeof(BacktrackParams<double>) <= 4096,
              "kernel parameters > 4 KB");

template <typename T>
__device__ __forceinline__ T nonneg(T x) {
  // max(x, 0) that keeps a NaN, as torch.clamp does
  return x < T(0) ? T(0) : x;
}

template <typename T, int K>
struct Vals {
  T v[K];
};

// Calls use(i, load(i)) for the elements i = tid, tid + kThreads, ... of a
// lane's array of ``size`` values, kStream at a time: the loads of kStream
// elements are in flight together before their stores, so a thread waits
// for device memory once per kStream elements.  The elements of a thread come
// in the same order as one at a time.
constexpr int kStream = 4;

template <class Load, class Use>
__device__ __forceinline__ void stream(int size, Load&& load, Use&& use) {
  using V = decltype(load(0));
  for (int i0 = threadIdx.x; i0 < size; i0 += kStream * kThreads) {
    V v[kStream];
#pragma unroll
    for (int k = 0; k < kStream; ++k) {
      const int i = i0 + k * kThreads;
      if (i < size) v[k] = load(i);
    }
#pragma unroll
    for (int k = 0; k < kStream; ++k) {
      const int i = i0 + k * kThreads;
      if (i < size) use(i, v[k]);
    }
  }
}

// One sweep of lane ``lane`` on the instance's body, at z (+ tau d when DIR)
// into the pair o, with <r, M r> and the inf-norms of M r (and with DIR
// <r, M d> and those of M d), M r not stored.  z, d and o are given as the
// launch's pairs (the element body's accessors) and as the lane's pointers
// (the node body's).  Starts and ends with a barrier.
template <typename T, int BODY, bool DIR, class Params>
__device__ __forceinline__ SweepRed<T> lane_sweep(
    const Params& P, int64_t lane, const Pair<T>& z, const Lane<T>& zl,
    const Pair<T>& d, const Lane<T>& dl, T tau, const Pair<T>& o,
    const Lane<T>& ol, T* sm) {
  const Geo& g = P.x.k.g;
  const T* x0 = P.x0 + lane * g.nx;
  if constexpr (BODY == kNodeBody) {
    return step_sweep<T, DIR, PhaseClock>(
        P.x, zl, dl, tau, ol, nullptr, true,
        P.gdv + lane * g.n_nl * P.x.s.ldu, P.qg + lane * P.x.s.qsize, x0,
        sm);
  } else {
    __syncthreads();
    PhaseClock::lap_pending();
    const Cand<T, DIR> c{Ref<T>{&z, &g, lane}, Ref<T>{&d, &g, lane}, tau};
    const Ref<T> out{&o, &g, lane};
    return sweep_lane<T, true, DIR, PhaseClock>(P.x.k, lane, c, out,
                                                nullptr, x0, sm);
  }
}

// What phase 4 needs besides the candidate sweep.
template <typename T>
struct CommitIn {
  T rn, nmz, nmv;  // ||r||_M and the inf-norms of M r at (z, v)
  T r_safe, q_pow, tau;
  T g0, g1, g2;
  bool act;
};

// Phase 4 of one lane: thread 0 makes the K1 / K2 / fallback choice and
// writes the output scalars to ``out``; then every thread writes its share
// of z_new and s (s = s_prev on an inactive lane; ``sp`` may be null when
// every lane is active).
template <typename T, class Params>
__device__ void commit(const Params& P, const SweepRed<T>& cand,
                       const CommitIn<T>& ci, const Lane<T>& z,
                       const Lane<T>& d, const Lane<T>& wbar,
                       const Lane<T>& zbar, const Lane<T>* sp,
                       const Lane<T>& zn, const Lane<T>& s, T* out,
                       T* choice) {
  const Geo& g = P.x.k.g;
  const int tid = threadIdx.x;
  const T tau = ci.tau;
  const bool act = ci.act;
  if (tid == 0) {
    const T gamma = P.x.k.gamma, sigma = P.x.k.sigma;
    const T rn = ci.rn;
    const T rtsq = nonneg(cand.dot);
    const T rt = root(rtsq);
    const bool k1 = act && rn <= ci.r_safe && rt <= P.c1 * rn;
    const T rho = rtsq - tau * cand.rho;
    const bool k2 = act && !k1 && rho >= P.sigma_k2 * rn * rt;
    const T coef = P.lam_sp * (rtsq > T(0) ? rho / rtsq : T(0));
    const bool looping = act && !k1 && !k2;
    choice[0] = k1 ? T(1) : T(0);
    choice[1] = k2 ? T(1) : T(0);
    choice[2] = coef;
    out[OC_K1] = choice[0];
    out[OC_K2] = choice[1];
    out[OC_LOOP] = looping ? T(1) : T(0);
    out[OC_RN] = rn;
    out[OC_RT] = rt;
    out[OC_RSAFE] = k1 ? rt + ci.q_pow : ci.r_safe;
    out[OC_XI1] = k1 ? tau * cand.ndz / gamma
                     : (k2 ? coef * cand.nz / gamma : P.lam * ci.nmz / gamma);
    out[OC_XI2] = k1 ? tau * cand.ndv / sigma
                     : (k2 ? coef * cand.nv / sigma : P.lam * ci.nmv / sigma);
    out[OC_NMRWZ] = cand.nz;
    out[OC_NMRWV] = cand.nv;
    out[OC_G0] = ci.g0;
    out[OC_G1] = ci.g1;
    out[OC_G2] = ci.g2;
    for (int k = kOcUsed; k < kScOut; ++k) out[k] = T(0);
  }
  __syncthreads();
  const bool k1 = choice[0] != T(0);
  const bool k2 = choice[1] != T(0);
  const T coef = choice[2];
  const T lam = P.lam;
  for (int b = 0; b < kPairBlocks; ++b) {
    const T* zz = z.p[b];
    const T* dd = d.p[b];
    const T* wb = wbar.p[b];
    const T* zb = zbar.p[b];
    const T* spb = act ? nullptr : sp->p[b];
    T* zo = zn.p[b];
    T* so = s.p[b];
    stream(g.lsz[b],
           [&](int i) {
             return Vals<T, 5>{
                 {zz[i], dd[i], wb[i], zb[i], spb ? spb[i] : T(0)}};
           },
           [&](int i, const Vals<T, 5>& e) {
             const T zv = e.v[0];
             const T wv = zv + tau * e.v[1];
             const T zk2 = zv - coef * (wv - e.v[2]);
             const T zfb =
                 lam == T(1) ? e.v[3] : lam * e.v[3] + (T(1) - lam) * zv;
             const T zv_new = act ? (k1 ? wv : (k2 ? zk2 : zfb)) : zv;
             zo[i] = zv_new;
             so[i] = act ? zv_new - zv : e.v[4];
           });
  }
}

template <typename T, int BODY>
__global__ void __launch_bounds__(kThreads)
sp_step_kernel(const __grid_constant__ StepParams<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PhaseClock::begin(P.count);
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ Lane<T> lz, lzb, lrp, lsp, la1r, la2r, la1p, la2p;
  __shared__ Lane<T> lzn, lw, lr, ls, ly, lp, lf, ld;
  __shared__ T choice[3];
  const Geo& g = P.x.k.g;
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const T* sc = P.scal + lane * kScIn;
  const bool act = sc[SC_ACTIVE] > T(0);
  const T hp = sc[SC_VALID1];
  const T v2 = sc[SC_VALID2];
  const bool cached = sc[SC_CACHE] > T(0);
  const T tau = sc[SC_TAU];
  make_lane(lz, P.z, lane, g);
  make_lane(lzb, cached ? P.cache : P.fresh, lane, g);
  make_lane(lrp, P.rp, lane, g);
  make_lane(lsp, P.sp, lane, g);
  make_lane(la1r, P.a1r, lane, g);
  make_lane(la2r, P.a2r, lane, g);
  make_lane(la1p, P.a1p, lane, g);
  make_lane(la2p, P.a2p, lane, g);
  make_lane(lzn, P.zn, lane, g);
  make_lane(lw, P.w, lane, g);
  make_lane(lr, P.r, lane, g);
  make_lane(ls, P.s, lane, g);
  make_lane(ly, P.y, lane, g);
  make_lane(lp, P.p, lane, g);
  make_lane(lf, P.fresh, lane, g);
  make_lane(ld, P.d, lane, g);
  if constexpr (BODY == kNodeBody) stage_consts(P.x, sm);
  __syncthreads();
  PhaseClock::lap(kSlotNone);

  // ---- phase 1: the fresh sweep, skipped by a lane with a valid cache ----
  SweepRed<T> fresh{T(0), T(0), T(0), T(0), T(0), T(0)};
  if (!cached) {
    fresh = lane_sweep<T, BODY, false>(P, lane, P.z, lz, P.z, lz, T(0),
                                       P.fresh, lf, sm);
  }

  // ---- phase 2: residual, Anderson rows, Gram sums ----
  T acc[9];
  for (int k = 0; k < 9; ++k) acc[k] = T(0);
  for (int b = 0; b < kPairBlocks; ++b) {
    const T* z = lz.p[b];
    const T* zbar = lzb.p[b];
    const T* rp = lrp.p[b];
    const T* sp = lsp.p[b];
    const T* a1 = la1r.p[b];
    const T* a2 = la2r.p[b];
    T* yo = ly.p[b];
    T* po = lp.p[b];
    T* ro = lr.p[b];
    stream(g.lsz[b],
           [&](int i) {
             return Vals<T, 6>{{z[i], zbar[i], rp[i], sp[i], a1[i], a2[i]}};
           },
           [&](int i, const Vals<T, 6>& e) {
             const T r = e.v[0] - e.v[1];
             const T rprev = e.v[2];
             const T y = r - hp * rprev;
             const T p = hp * e.v[3] - y;
             yo[i] = y;
             po[i] = p;
             ro[i] = act ? r : rprev;
             const T y1 = e.v[4], y2 = e.v[5];
             acc[0] += y * y;
             acc[1] += y * y1;
             acc[2] += y * y2;
             acc[3] += y1 * y1;
             acc[4] += y1 * y2;
             acc[5] += y2 * y2;
             acc[6] += y * r;
             acc[7] += y1 * r;
             acc[8] += y2 * r;
           });
  }
  block_reduce(acc, 9, sm + P.x.s.work);
  PhaseClock::lap(kSlotAnderson);

  // regularised closed-form 3x3 solve (anderson._solve3), rows of age 1 and
  // 2 masked by their validity; every thread computes the same gammas
  const T g00 = acc[0], g01 = acc[1] * hp, g02 = acc[2] * v2;
  const T g11 = acc[3] * hp, g12 = acc[4] * hp * v2, g22 = acc[5] * v2;
  const T c0 = acc[6], c1 = acc[7] * hp, c2 = acc[8] * v2;
  const T tr = g00 + g11 + g22;
  const T eps = T(1e-10) * (tr / T(3)) + T(1e-30);
  // scaled to entries of magnitude <= 1, as anderson._solve3 does: for the
  // small Gram of a lane near convergence the float32 determinant would
  // fall below the normal range and 1 / det overflow
  const T entries[6] = {g00 + eps, g01, g02, g11 + eps, g12, g22 + eps};
  T scale = T(0);
  for (int k = 0; k < 6; ++k) scale = absmax(scale, entries[k]);
  if (!(scale > T(0))) scale = T(1);
  const T a_ = (g00 + eps) / scale, bb = g01 / scale, cc = g02 / scale;
  const T d_ = bb, e_ = (g11 + eps) / scale, f_ = g12 / scale;
  const T g_ = cc, h_ = f_, i_ = (g22 + eps) / scale;
  const T c0s = c0 / scale, c1s = c1 / scale, c2s = c2 / scale;
  const T co00 = e_ * i_ - f_ * h_;
  const T co01 = f_ * g_ - d_ * i_;
  const T co02 = d_ * h_ - e_ * g_;
  const T det = a_ * co00 + bb * co01 + cc * co02;
  const T co10 = cc * h_ - bb * i_;
  const T co11 = a_ * i_ - cc * g_;
  const T co12 = bb * g_ - a_ * h_;
  const T co20 = bb * f_ - cc * e_;
  const T co21 = cc * d_ - a_ * f_;
  const T co22 = a_ * e_ - bb * d_;
  const T x0s = co00 * c0s + co10 * c1s + co20 * c2s;
  const T x1s = co01 * c0s + co11 * c1s + co21 * c2s;
  const T x2s = co02 * c0s + co12 * c1s + co22 * c2s;
  const T dinv = T(1) / (det != T(0) ? det : T(1));
  const T gam0 = x0s * dinv;
  const T gam1 = x1s * dinv * hp;
  const T gam2 = x2s * dinv * v2;

  // d = -r - g0 p - g1 p1 - g2 p2 (each thread reads back its own p)
  for (int b = 0; b < kPairBlocks; ++b) {
    const T* z = lz.p[b];
    const T* zbar = lzb.p[b];
    const T* po = lp.p[b];
    const T* p1 = la1p.p[b];
    const T* p2 = la2p.p[b];
    T* dd = ld.p[b];
    stream(g.lsz[b],
           [&](int i) {
             return Vals<T, 5>{{z[i], zbar[i], po[i], p1[i], p2[i]}};
           },
           [&](int i, const Vals<T, 5>& e) {
             const T r = e.v[0] - e.v[1];
             dd[i] = -r - gam0 * e.v[2] - gam1 * e.v[3] - gam2 * e.v[4];
           });
  }

  // ---- phase 3: the candidate sweep at (z, v) + tau d into w ----
  PhaseClock::pend(kSlotAnderson);
  const SweepRed<T> cand =
      lane_sweep<T, BODY, true>(P, lane, P.z, lz, P.d, ld, tau, P.w, lw, sm);

  // ---- phase 4: K1 / K2 / fallback, the commit and the kept scalars ----
  const CommitIn<T> ci{cached ? sc[SC_RNC] : root(nonneg(fresh.dot)),
                       cached ? sc[SC_NMZC] : fresh.nz,
                       cached ? sc[SC_NMVC] : fresh.nv,
                       sc[SC_RSAFE], sc[SC_QPOW], tau, gam0, gam1, gam2, act};
  commit(P, cand, ci, lz, ld, lw, lzb, &lsp, lzn, ls,
         P.oscal + lane * kScOut, choice);
  if (tid == 0) {
    T* kp = P.keep + lane * kKeep;
    kp[KP_RN] = ci.rn;
    kp[KP_NMZ] = ci.nmz;
    kp[KP_NMV] = ci.nmv;
    kp[KP_G0] = gam0;
    kp[KP_G1] = gam1;
    kp[KP_G2] = gam2;
    kp[KP_CACHED] = cached ? T(1) : T(0);
    kp[kKeep - 1] = T(0);
  }
  PhaseClock::lap(kSlotCommit);
  PhaseClock::end(P.count);
}

template <typename T, int BODY>
__global__ void __launch_bounds__(kThreads)
sp_backtrack_kernel(const __grid_constant__ BacktrackParams<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ Lane<T> lz, ld, lzb, lw, lzn, ls;
  __shared__ T choice[3];
  const Geo& g = P.x.k.g;
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const T* o1 = P.oscal1 + lane * kScOut;
  T* out = P.oscal + lane * kScOut;
  if (!(o1[OC_LOOP] > T(0)) || P.max_bt == 0) {
    if (tid < kScOut) out[tid] = o1[tid];
    return;
  }
  PhaseClock::begin(P.count);
  const T* sc = P.scal + lane * kScIn;
  const T* kp = P.keep + lane * kKeep;
  const bool cached = kp[KP_CACHED] > T(0);
  make_lane(lz, P.z, lane, g);
  make_lane(ld, P.d, lane, g);
  make_lane(lzb, cached ? P.cache : P.fresh, lane, g);
  make_lane(lw, P.w, lane, g);
  make_lane(lzn, P.zn, lane, g);
  make_lane(ls, P.s, lane, g);
  if constexpr (BODY == kNodeBody) stage_consts(P.x, sm);
  __syncthreads();
  PhaseClock::lap(kSlotNone);

  T tau = T(1);
  int trials = 0;
  while (trials < P.max_bt) {
    tau *= P.beta;
    ++trials;
    // the sweep starts and ends with a barrier: the previous trial's commit
    // has finished reading w and the choice
    const SweepRed<T> cand =
        lane_sweep<T, BODY, true>(P, lane, P.z, lz, P.d, ld, tau, P.w, lw, sm);
    const CommitIn<T> ci{kp[KP_RN], kp[KP_NMZ], kp[KP_NMV], sc[SC_RSAFE],
                         sc[SC_QPOW], tau, kp[KP_G0], kp[KP_G1], kp[KP_G2],
                         true};
    commit(P, cand, ci, lz, ld, lw, lzb,
           static_cast<const Lane<T>*>(nullptr), lzn, ls, out, choice);
    // the choice was written before commit's barrier: every thread reads
    // the same
    if (choice[0] != T(0) || choice[1] != T(0)) break;
    // the next trial's sweep opens with the end of this commit
    PhaseClock::pend(kSlotCommit);
  }
  if (tid == 0) {
    out[kOcTrials] = static_cast<T>(trials);
    atomicAdd(P.count, 1ull);
    atomicAdd(P.count + 1, static_cast<unsigned long long>(trials));
  }
  PhaseClock::lap(kSlotCommit);
  PhaseClock::end(P.count);
}

// The constants of a launch from the host pointers p (make_consts's order,
// the element body's four scratch pointers included), dims and coefs (gamma,
// sigma, c1, sigma_k2, lam, lam_sp); false on a problem outside the
// instance's class, a layout that does not fit or missing scratch.  The
// dynamic shared memory ends with the phase clock's words; before them the
// element instance's is the reduction scratch.
template <typename T, int BODY, class Params>
bool make_params(Params& P, void* const* p, const int* dims,
                 const double* coefs) {
  if (!make_consts(P.x.k, p, dims, coefs[0], coefs[1])) return false;
  const Geo& g = P.x.k.g;
  if (dims[DIM_PN_Q] || dims[DIM_PN_R] || dims[DIM_PN_QN]) return false;
  if constexpr (BODY == kNodeBody) {
    if (!node_fits(g) ||
        !plan_smem(P.x.s, g, dims, static_cast<int>(sizeof(T)),
                   kClockBytes) ||
        !P.gdv || !P.qg) {
      return false;
    }
  } else {
    const SweepConsts<T>& k = P.x.k;
    if (!k.gq || !k.gw || !k.gdv || !k.ginner) return false;
    P.x.s = StepSmem{};
    P.x.s.bytes =
        kClockBytes + kMaxRed * kThreads * static_cast<int>(sizeof(T));
  }
  P.c1 = static_cast<T>(coefs[2]);
  P.sigma_k2 = static_cast<T>(coefs[3]);
  P.lam = static_cast<T>(coefs[4]);
  P.lam_sp = static_cast<T>(coefs[5]);
  return true;
}

template <typename T>
void set_pairs(Pair<T>* const* pairs, int count, void* const* p) {
  for (int k = 0; k < count; ++k) {
    for (int b = 0; b < kPairBlocks; ++b) {
      pairs[k]->p[b] = static_cast<T*>(p[k * kPairBlocks + b]);
    }
  }
}

// Pointer order of the host array ``ptrs`` of sp_step (see ops/spstep.py),
// 19 pointers a pair in the order of sweep_common.cuh's Block (null for an
// absent polytope block):
//   [0, 152)    the 8 input pairs: z, cache, r_prev, s_prev, MR age 1,
//               MR age 2, MP age 1, MP age 2
//   [152, 266)  the 6 output pairs: z_new, w, r, s, y, p
//   [266, 304)  the 2 kept pairs: fresh sweep, direction
//   304 x0  305 scalar pack [B, 10]  306 output scalars [B, 16]
//   307 kept scalars [B, 8]  308 dvec scratch  309 costate scratch (the
//               node instance's; null for the element instance)
//   310 the counter (int64 [3 + kSlots]: its phase clock's flag read, its
//               cycles added to)
//   [311, 339)  the sweep's constants, in make_consts's order, then its four
//               scratch pointers (the element instance's; null for the node
//               instance)
constexpr int kStepPairs = kInPairs + kOutPairs + 2;

template <typename T, int BODY>
int launch_step(const void* ptrs, const int* dims, const double* coefs,
                int B, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  StepParams<T> P;
  void* const* p = static_cast<void* const*>(ptrs);
  constexpr int base = kStepPairs * kPairBlocks;
  P.gdv = static_cast<T*>(p[base + 4]);
  P.qg = static_cast<T*>(p[base + 5]);
  P.count = static_cast<unsigned long long*>(p[base + 6]);
  if (!make_params<T, BODY>(P, p + base + 7, dims, coefs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pair<T>* const pairs[] = {&P.z,  &P.cache, &P.rp, &P.sp, &P.a1r, &P.a2r,
                            &P.a1p, &P.a2p,  &P.zn, &P.w,  &P.r,   &P.s,
                            &P.y,  &P.p,     &P.fresh, &P.d};
  set_pairs(pairs, kStepPairs, p);
  P.x0 = static_cast<const T*>(p[base]);
  P.scal = static_cast<const T*>(p[base + 1]);
  P.oscal = static_cast<T*>(p[base + 2]);
  P.keep = static_cast<T*>(p[base + 3]);
  return launch_kernel(sp_step_kernel<T, BODY>, P, B, stream);
}

// Pointer order of sp_backtrack:
//   [0, 76)     the 4 input pairs: z, cache, fresh sweep, direction
//   [76, 114)   z_new and s, written at the looping lanes
//   [114, 133)  the candidate-sweep scratch pair, [B, ...]
//   133 x0  134 scalar pack [B, 10]  135 kept scalars [B, 8]
//   136 the tau = 1 launch's output scalars [B, 16]
//   137 output scalars [B, 16]  138 dvec scratch  139 costate scratch (the
//               node instance's)
//   140 the counter (int64 [3 + kSlots]: lanes looped and trials made added
//               to; the phase clock's as for sp_step)
//   [141, 169)  the sweep's constants and its scratch, as for sp_step
// coefs: as for sp_step, then beta.
constexpr int kBacktrackPairs = 7;

template <typename T, int BODY>
int launch_backtrack(const void* ptrs, const int* dims, const double* coefs,
                     int B, int max_bt, void* stream) {
  if (B < 0 || max_bt < 0) return static_cast<int>(cudaErrorInvalidValue);
  BacktrackParams<T> P;
  void* const* p = static_cast<void* const*>(ptrs);
  constexpr int base = kBacktrackPairs * kPairBlocks;
  P.gdv = static_cast<T*>(p[base + 5]);
  P.qg = static_cast<T*>(p[base + 6]);
  if (!make_params<T, BODY>(P, p + base + 8, dims, coefs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pair<T>* const pairs[] = {&P.z, &P.cache, &P.fresh, &P.d,
                            &P.zn, &P.s, &P.w};
  set_pairs(pairs, kBacktrackPairs, p);
  P.x0 = static_cast<const T*>(p[base]);
  P.scal = static_cast<const T*>(p[base + 1]);
  P.keep = static_cast<const T*>(p[base + 2]);
  P.oscal1 = static_cast<const T*>(p[base + 3]);
  P.oscal = static_cast<T*>(p[base + 4]);
  P.count = static_cast<unsigned long long*>(p[base + 7]);
  P.beta = static_cast<T>(coefs[6]);
  P.max_bt = max_bt;
  return launch_kernel(sp_backtrack_kernel<T, BODY>, P, B, stream);
}

#if SPOCK_BODY != 0
// The instance of ``body``; an error for another code.
template <typename T>
int launch_step_body(const void* ptrs, const int* dims, const double* coefs,
                     int body, int B, void* stream) {
  if (body == kNodeBody) {
    return launch_step<T, kNodeBody>(ptrs, dims, coefs, B, stream);
  }
  if (body == kElementBody) {
    return launch_step_element<T>(ptrs, dims, coefs, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_backtrack_body(const void* ptrs, const int* dims,
                          const double* coefs, int body, int B, int max_bt,
                          void* stream) {
  if (body == kNodeBody) {
    return launch_backtrack<T, kNodeBody>(ptrs, dims, coefs, B, max_bt,
                                          stream);
  }
  if (body == kElementBody) {
    return launch_backtrack_element<T>(ptrs, dims, coefs, B, max_bt, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

}  // namespace

#if SPOCK_BODY != 1
template <typename T>
int launch_step_element(const void* ptrs, const int* dims,
                        const double* coefs, int B, void* stream) {
  return launch_step<T, kElementBody>(ptrs, dims, coefs, B, stream);
}

template <typename T>
int launch_backtrack_element(const void* ptrs, const int* dims,
                             const double* coefs, int B, int max_bt,
                             void* stream) {
  return launch_backtrack<T, kElementBody>(ptrs, dims, coefs, B, max_bt,
                                           stream);
}
#if SPOCK_PART != 8
template int launch_step_element<float>(const void*, const int*,
                                        const double*, int, void*);
template int launch_backtrack_element<float>(const void*, const int*,
                                             const double*, int, int, void*);
#endif
#if SPOCK_PART != 4
template int launch_step_element<double>(const void*, const int*,
                                         const double*, int, void*);
template int launch_backtrack_element<double>(const void*, const int*,
                                              const double*, int, int,
                                              void*);
#endif
#endif
}  // namespace spock

// C entry points, bound with ctypes.  ptrs: host array of device pointers
// in the orders above; dims: host int array (sweep_common.cuh's Dim entries,
// nseg, then nseg (kind, lo, hi) triples); coefs: host double array (gamma,
// sigma, c1, sigma_k2, lam, lam_sp, and beta for the backtrack); body: 1 for
// the node instance, 0 for the element instance.  One thread block per
// lane.  Return cudaGetLastError(), or cudaErrorInvalidValue for a request
// the instance does not take.
#if SPOCK_BODY != 0 && SPOCK_PART != 8
extern "C" int sp_step_f32(const void* ptrs, const int* dims,
                           const double* coefs, int body, int B,
                           void* stream) {
  return spock::launch_step_body<float>(ptrs, dims, coefs, body, B, stream);
}

extern "C" int sp_backtrack_f32(const void* ptrs, const int* dims,
                                const double* coefs, int body, int B,
                                int max_backtracks, void* stream) {
  return spock::launch_backtrack_body<float>(ptrs, dims, coefs, body, B,
                                             max_backtracks, stream);
}

// The node instance's shared-memory plan (step_body.cuh's node_plan, with
// the phase clock's words) into out[4], for chip_smoke.py's report: dsize
// is 4 or 8.
extern "C" int sp_step_plan(const int* dims, int dsize, int* out) {
  return dsize == 8 ? spock::node_plan<double>(dims, out, spock::kClockBytes)
                    : spock::node_plan<float>(dims, out, spock::kClockBytes);
}
#endif

#if SPOCK_BODY != 0 && SPOCK_PART != 4
extern "C" int sp_step_f64(const void* ptrs, const int* dims,
                           const double* coefs, int body, int B,
                           void* stream) {
  return spock::launch_step_body<double>(ptrs, dims, coefs, body, B, stream);
}

extern "C" int sp_backtrack_f64(const void* ptrs, const int* dims,
                                const double* coefs, int body, int B,
                                int max_backtracks, void* stream) {
  return spock::launch_backtrack_body<double>(ptrs, dims, coefs, body, B,
                                              max_backtracks, stream);
}
#endif
