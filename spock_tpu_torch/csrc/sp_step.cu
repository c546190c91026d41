// One whole SuperMann iteration per lane in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   spock_tpu/ops/pallas_spstep.py:1340     sp_step_fused (lane-packed)
//   spock_tpu/ops/pallas_spstep_lt.py:1093  sp_step_fused (lane-tiled)
// the first at any per-lane tau, the second at tau = 1.
// Their plain PyTorch version is sp_step_ref in spock_tpu_torch/ops/spstep.py,
// which also holds the wrapper, the launch count and the checks.
//
// It takes the JAX step kernels' problem class: uniform costs, risk data
// uniform or per node, with or without polytope rows.
//
// What one launch computes for every lane, from its scalar pack (active,
// valid1, valid2, cache, r_safe, q_pow, rnorm_c, nMrz_c, nMrv_c, tau):
//   1. (zbar, vbar): the cache pair if the lane's cache flag is set, else a
//      fresh sweep at (z, v) (sweep_body.cuh) with ||r||_M and the inf-norms
//      of M r, into a scratch pair; the choice is a pointer, not a copy;
//   2. r = (z, v) - (zbar, vbar); y = r - valid1 r_prev; p = valid1 s_prev - y
//      (written: the caller's new Anderson row pair); the next r_prev; in
//      the same pass the nine sums of the window-3 Gram of (y, y1, y2) and of
//      its right side against r, with y1, y2 the rows of age 1 and 2; the
//      regularised closed-form 3x3 solve for (g0, g1, g2), and a second pass
//      d = -r - g0 p - g1 p1 - g2 p2 into a scratch pair;
//   3. the candidate sweep at (z, v) + tau d into w, the next cache:
//      <r~, M r~>, <r~, M d> and the four inf-norms (M r~, M d not stored);
//   4. thread 0 makes the K1 / K2 / fallback choice; a last pass writes
//      z_new and s_new = z_new - z, then the 13 output scalars.
// y, p and w are written for every lane; z_new, r and s move only for
// active lanes.  All reductions are fixed-order block reductions, so a
// launch is deterministic.
//
// What bounds it: memory.  A lane reads 8 pairs (z, cache, r_prev, s_prev
// and the four Anderson rows) and writes 6 (z_new, w, r, s, y, p); at the
// headline size (B = 128 lanes of server_heat N=10 nx=nu=20 d=2, float32,
// 123,214 values a pair) that is 14 x 63.1 MB = 883 MB, 0.26 ms at
// 3.35 TB/s, against ~3.5 GFLOP of arithmetic (0.05 ms at 67 TFLOP/s).
//
// Design (simple and right first): one thread block of 512 threads per lane,
// as in cp_sweep.cu, so the per-lane cache skip is a branch of the block and
// the Gram, the 3x3 solve and the K1/K2 choice need no second launch.  The
// passes stream each of the 19 blocks of the lane's pairs with neighbouring
// threads on neighbouring addresses; the Anderson rows are read in place
// (the caller binds them by iteration phase, so no history is ever copied);
// M r~ and M d are reduced element by element without being stored.  The
// two scratch pairs and re-reading z and the direction in phases 2-4 cost
// about 6 more pair passes than the bound counts; nothing more is done
// about the memory bound yet.

#include "sweep_body.cuh"

namespace spock {
namespace {

// Slots of the [B, 10] scalar pack and of the [B, 16] output scalars (the
// JAX kernel's _SC_* and _OC_* numbers).
constexpr int kScIn = 10;
constexpr int kScOut = 16;
enum { SC_ACTIVE, SC_VALID1, SC_VALID2, SC_CACHE, SC_RSAFE, SC_QPOW, SC_RNC,
       SC_NMZC, SC_NMVC, SC_TAU };
enum { OC_K1, OC_K2, OC_LOOP, OC_RN, OC_RT, OC_RSAFE, OC_XI1, OC_XI2,
       OC_NMRWZ, OC_NMRWV, OC_G0, OC_G1, OC_G2, kOcUsed };

constexpr int kInPairs = 8;
constexpr int kOutPairs = 6;

template <typename T>
struct StepParams {
  SweepConsts<T> k;
  // inputs: z, cache, r_prev, s_prev, the MR rows of age 1 and 2, the MP
  // rows of age 1 and 2
  Pair<T> z, cache, rp, sp, a1r, a2r, a1p, a2p;
  Pair<T> zn, w, r, s, y, p;  // outputs
  Pair<T> fresh, d;           // scratch: the fresh sweep, the direction
  const T* x0;    // [B, nx]
  const T* scal;  // [B, kScIn]
  T* oscal;       // [B, kScOut]
  T c1, sigma_k2, lam, lam_sp;
};

// 16 pairs of 19 pointers and the sweep's constants: within the 4 KB of
// kernel parameters that every CUDA 12 toolkit takes.
static_assert(sizeof(StepParams<double>) <= 4096, "kernel parameters > 4 KB");

template <typename T>
__device__ __forceinline__ T nonneg(T x) {
  // max(x, 0) that keeps a NaN, as torch.clamp does
  return x < T(0) ? T(0) : x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sp_step_kernel(const __grid_constant__ StepParams<T> P) {
  __shared__ T sh[kThreads];
  __shared__ T choice[3];  // k1, k2, coef
  const Geo& g = P.k.g;
  const int64_t lane = blockIdx.x;
  const int tid = threadIdx.x;
  const T* sc = P.scal + lane * kScIn;
  const bool act = sc[SC_ACTIVE] > T(0);
  const T hp = sc[SC_VALID1];
  const T v2 = sc[SC_VALID2];
  const bool cached = sc[SC_CACHE] > T(0);
  const T tau = sc[SC_TAU];
  const T* x0 = P.x0 + lane * g.nx;

  // ---- phase 1: the fresh sweep, skipped by a lane with a valid cache ----
  SweepRed<T> fresh{T(0), T(0), T(0), T(0), T(0), T(0)};
  if (!cached) {
    const Ref<T> z{&P.z, &g, lane};
    fresh = sweep_lane<T, true, false>(P.k, lane, Cand<T, false>{z, z, T(0)},
                                       Ref<T>{&P.fresh, &g, lane}, nullptr,
                                       x0, sh);
  }
  const Pair<T>& zb = cached ? P.cache : P.fresh;

  // ---- phase 2: residual, Anderson rows, Gram sums ----
  T acc[9];
  for (int k = 0; k < 9; ++k) acc[k] = T(0);
  for (int b = 0; b < kPairBlocks; ++b) {
    const int64_t off = lane * g.lsz[b];
    const T* z = P.z.p[b] + off;
    const T* zbar = zb.p[b] + off;
    const T* rp = P.rp.p[b] + off;
    const T* sp = P.sp.p[b] + off;
    const T* a1 = P.a1r.p[b] + off;
    const T* a2 = P.a2r.p[b] + off;
    T* yo = P.y.p[b] + off;
    T* po = P.p.p[b] + off;
    T* ro = P.r.p[b] + off;
    for (int i = tid; i < g.lsz[b]; i += kThreads) {
      const T r = z[i] - zbar[i];
      const T rprev = rp[i];
      const T y = r - hp * rprev;
      const T p = hp * sp[i] - y;
      yo[i] = y;
      po[i] = p;
      ro[i] = act ? r : rprev;
      const T y1 = a1[i], y2 = a2[i];
      acc[0] += y * y;
      acc[1] += y * y1;
      acc[2] += y * y2;
      acc[3] += y1 * y1;
      acc[4] += y1 * y2;
      acc[5] += y2 * y2;
      acc[6] += y * r;
      acc[7] += y1 * r;
      acc[8] += y2 * r;
    }
  }
  for (int k = 0; k < 9; ++k) acc[k] = block_sum(acc[k], sh);

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
    const int64_t off = lane * g.lsz[b];
    const T* z = P.z.p[b] + off;
    const T* zbar = zb.p[b] + off;
    const T* po = P.p.p[b] + off;
    const T* p1 = P.a1p.p[b] + off;
    const T* p2 = P.a2p.p[b] + off;
    T* dd = P.d.p[b] + off;
    for (int i = tid; i < g.lsz[b]; i += kThreads) {
      const T r = z[i] - zbar[i];
      dd[i] = -r - gam0 * po[i] - gam1 * p1[i] - gam2 * p2[i];
    }
  }
  __syncthreads();

  // ---- phase 3: the candidate sweep at (z, v) + tau d into w ----
  const SweepRed<T> cand = sweep_lane<T, true, true>(
      P.k, lane,
      Cand<T, true>{Ref<T>{&P.z, &g, lane}, Ref<T>{&P.d, &g, lane}, tau},
      Ref<T>{&P.w, &g, lane}, nullptr, x0, sh);

  // ---- phase 4: K1 / K2 / fallback and the commit ----
  if (tid == 0) {
    const T gamma = P.k.gamma, sigma = P.k.sigma;
    const T rn = cached ? sc[SC_RNC] : root(nonneg(fresh.dot));
    const T nmz = cached ? sc[SC_NMZC] : fresh.nz;
    const T nmv = cached ? sc[SC_NMVC] : fresh.nv;
    const T rtsq = nonneg(cand.dot);
    const T rt = root(rtsq);
    const T r_safe = sc[SC_RSAFE];
    const bool k1 = act && rn <= r_safe && rt <= P.c1 * rn;
    const T rho = rtsq - tau * cand.rho;
    const bool k2 = act && !k1 && rho >= P.sigma_k2 * rn * rt;
    const T coef = P.lam_sp * (rtsq > T(0) ? rho / rtsq : T(0));
    const bool looping = act && !k1 && !k2;
    choice[0] = k1 ? T(1) : T(0);
    choice[1] = k2 ? T(1) : T(0);
    choice[2] = coef;
    T* out = P.oscal + lane * kScOut;
    out[OC_K1] = choice[0];
    out[OC_K2] = choice[1];
    out[OC_LOOP] = looping ? T(1) : T(0);
    out[OC_RN] = rn;
    out[OC_RT] = rt;
    out[OC_RSAFE] = k1 ? rt + sc[SC_QPOW] : r_safe;
    out[OC_XI1] = k1 ? tau * cand.ndz / gamma
                     : (k2 ? coef * cand.nz / gamma : P.lam * nmz / gamma);
    out[OC_XI2] = k1 ? tau * cand.ndv / sigma
                     : (k2 ? coef * cand.nv / sigma : P.lam * nmv / sigma);
    out[OC_NMRWZ] = cand.nz;
    out[OC_NMRWV] = cand.nv;
    out[OC_G0] = gam0;
    out[OC_G1] = gam1;
    out[OC_G2] = gam2;
    for (int k = kOcUsed; k < kScOut; ++k) out[k] = T(0);
  }
  __syncthreads();
  const bool k1 = choice[0] != T(0);
  const bool k2 = choice[1] != T(0);
  const T coef = choice[2];
  const T lam = P.lam;
  for (int b = 0; b < kPairBlocks; ++b) {
    const int64_t off = lane * g.lsz[b];
    const T* z = P.z.p[b] + off;
    const T* dd = P.d.p[b] + off;
    const T* wbar = P.w.p[b] + off;
    const T* zbar = zb.p[b] + off;
    const T* sp = P.sp.p[b] + off;
    T* zo = P.zn.p[b] + off;
    T* so = P.s.p[b] + off;
    for (int i = tid; i < g.lsz[b]; i += kThreads) {
      const T zv = z[i];
      const T wv = zv + tau * dd[i];
      const T zk2 = zv - coef * (wv - wbar[i]);
      const T zfb = lam == T(1) ? zbar[i] : lam * zbar[i] + (T(1) - lam) * zv;
      const T zn = act ? (k1 ? wv : (k2 ? zk2 : zfb)) : zv;
      zo[i] = zn;
      so[i] = act ? zn - zv : sp[i];
    }
  }
}

// Pointer order of the host array ``ptrs`` (see ops/spstep.py), 19 pointers
// a pair in the order of sweep_common.cuh's Block (null for an absent
// polytope block):
//   [0, 152)    the 8 input pairs: z, cache, r_prev, s_prev, MR age 1,
//               MR age 2, MP age 1, MP age 2
//   [152, 266)  the 6 output pairs: z_new, w, r, s, y, p
//   [266, 304)  the 2 scratch pairs: fresh sweep, direction
//   304 x0  305 scalar pack [B, 10]  306 output scalars [B, 16]
//   [307, 332)  the sweep's constants and scratch, in make_consts's order
// dims: the kDims entries of sweep_common.cuh, nseg, then nseg (kind, lo,
// hi) triples.  The wrapper passes uniform costs only (the JAX step
// kernel's class); the kernel itself reads per-node costs as the sweeps do.
// coefs: gamma, sigma, c1, sigma_k2, lam, lam_sp.
template <typename T>
int launch(const void* ptrs, const int* dims, const double* coefs, int B,
           void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  StepParams<T> P;
  void* const* p = static_cast<void* const*>(ptrs);
  constexpr int kPairPtrs = (kInPairs + kOutPairs + 2) * kPairBlocks;
  if (!make_consts(P.k, p + kPairPtrs + 3, dims, coefs[0], coefs[1])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pair<T>* pairs[] = {&P.z,  &P.cache, &P.rp, &P.sp, &P.a1r, &P.a2r,
                      &P.a1p, &P.a2p,  &P.zn, &P.w,  &P.r,   &P.s,
                      &P.y,  &P.p,     &P.fresh, &P.d};
  for (int k = 0; k < kInPairs + kOutPairs + 2; ++k) {
    for (int b = 0; b < kPairBlocks; ++b) {
      pairs[k]->p[b] = static_cast<T*>(p[k * kPairBlocks + b]);
    }
  }
  P.x0 = static_cast<const T*>(p[kPairPtrs]);
  P.scal = static_cast<const T*>(p[kPairPtrs + 1]);
  P.oscal = static_cast<T*>(p[kPairPtrs + 2]);
  P.c1 = static_cast<T>(coefs[2]);
  P.sigma_k2 = static_cast<T>(coefs[3]);
  P.lam = static_cast<T>(coefs[4]);
  P.lam_sp = static_cast<T>(coefs[5]);
  if (B == 0) return 0;
  sp_step_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace spock

// C entry points, bound with ctypes.  ptrs: host array of the 332 device
// pointers in the order above; dims: host int array; coefs: host double
// array.  One thread block per lane.  Returns cudaGetLastError().
extern "C" int sp_step_f32(const void* ptrs, const int* dims,
                           const double* coefs, int B, void* stream) {
  return spock::launch<float>(ptrs, dims, coefs, B, stream);
}

extern "C" int sp_step_f64(const void* ptrs, const int* dims,
                           const double* coefs, int B, void* stream) {
  return spock::launch<double>(ptrs, dims, coefs, B, stream);
}
