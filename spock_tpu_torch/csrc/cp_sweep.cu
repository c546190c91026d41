// One whole Chambolle-Pock sweep per lane in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of spock_tpu/ops/pallas_sweep.py (the kernel
// body _make_kernel and its three entry points):
//   cp_sweep_fused         (metric off)
//   cp_sweep_metric_fused  (metric on)
//   candidate_sweep_fused  (metric on, with a direction)
// Their plain PyTorch versions are cp_sweep_ref, cp_sweep_metric_ref and
// candidate_sweep_ref in spock_tpu_torch/algorithms/common.py; the wrappers,
// the choice of body, the launch counts and the checks live in
// spock_tpu_torch/ops/sweep_kernels.py.
//
// What one launch computes for every lane, at (w, u) = (z, v) or, with a
// direction, at (w, u) = (z, v) + tau (dz, dv) with a per-lane tau:
//   w1    = w - gamma L' u
//   wbar  = prox_f(w1): s_root - gamma; the S1 Riccati backward sweep over the
//           N - 1 stage transitions and the forward rollout from x0; the S2
//           kernel projector per non-leaf node on (y; s_children; tau_children)
//   ubar  = prox_h*(u + sigma L (2 wbar - w)): the polyhedral dual cone, the
//           half-line, the two second-order cones, the boxes and the
//           two-sided polytope rows
// for the JAX kernels' whole problem class: costs and risk data uniform or
// per node, with or without polytope rows (sweep_common.cuh).
// With the metric also r = (w - wbar, u - ubar), M r = (r_z - gamma L' r_v,
// r_v - sigma L r_z) (stored), <r, M r> and the inf-norms of both halves of
// M r.  With a direction also <r, M d> and the inf-norms of both halves of
// M d, for d = (dz, dv), without storing M d.
//
// What bounds it: memory.  Every lane reads its iterate (and direction) and
// writes its outputs once; at the headline size (B = 128 lanes of
// server_heat N=10 nx=nu=20 d=2, float32, 123,214 values a pair) that is
// 126 MB for the plain sweep and 252 MB for the candidate sweep, 38-75 us at
// 3.35 TB/s, against 1.4-2.6 GFLOP of arithmetic (21-39 us at 67 TFLOP/s).
// Per-node cost matrices add 4.1 MB, which every lane reads again in each of
// its L and L' passes (from the L2: ~25 MB a lane for the candidate sweep),
// polytope rows 1.5 kB a lane of each pair.
//
// Design.  One 512-thread block per lane, on one of two bodies, chosen on
// the host by the problem's class and passed in:
//   * the node body (step_body.cuh's step_sweep, which the node instances
//     of sp_step.cu's step kernels also run), for nx, nu, ny + 2 d and
//     polytope rows of at most 32: a
//     node per thread with its columns in registers, uniform cost matrices
//     staged in shared memory and per-node ones read from node-minor copies
//     (coalesced over a warp's consecutive nodes), the S2 and cone
//     projections fused into the passes that form their arguments, M r
//     (stored by the thread that owns each entry) and M d in one traversal,
//     the Riccati sweeps a node per 4-32-thread group with the stage's
//     matrices and, where they fit, the costates in shared memory.  The
//     cp_sweep_fused and cp_sweep_metric_fused launches share one instance
//     (the metric pass is skipped at run time), so the source compiles two
//     sweeps per value type;
//   * the element body (sweep_body.cuh's sweep_lane, which the element
//     instances of sp_step.cu also run) for wider problems, of any size: the
//     threads stride over the (row, node) elements of each block, every
//     element of L and L' computes its own row dot product, and four
//     wrapper-allocated scratch arrays hold the Riccati intermediates and
//     the S2 projector's arguments.
// Per-lane reductions are fixed-order block reductions (deterministic, no
// atomics).  At B = 128 a launch fills 128 of the 132 SMs with one block
// each.
//
// Built in four parts by four nvcc processes at once (ops/_build.py):
// SPOCK_PART 4 compiles the float entries, 8 the double ones; SPOCK_DIRECTION
// 1 compiles only the node kernel with a direction (the longest to compile)
// and its launcher, 0 everything else.  Without them, one nvcc builds all.

#include "step_body.cuh"

#ifndef SPOCK_PART
#define SPOCK_PART 0
#endif
#ifndef SPOCK_DIRECTION
#define SPOCK_DIRECTION 2
#endif

namespace spock {

// The node kernels' parameters (outside the anonymous namespace: the
// launcher of the kernel with a direction links across the parts).
template <typename T>
struct NodeParams {
  StepConsts<T> x;
  Pair<T> in, dir, out, mr;
  T* scal[6];    // [B] each: <r,Mr>, |Mr_z|, |Mr_v|, <r,Md>, |Md_z|, |Md_v|
  const T* x0;   // [B, nx]
  const T* tau;  // [B]
  T* gdv;        // scratch [B, n_nl ldu]
  T* qg;         // scratch [B, qsize]; null when the costates fit in smem
  int metric;
};

static_assert(sizeof(NodeParams<double>) <= 4096, "kernel parameters > 4 KB");

// Launches the node kernel with a direction on B blocks.
template <typename T>
int launch_node_direction(const NodeParams<T>& P, int B, void* stream);

namespace {

// The body codes of the C entries (sweep_kernels.py's BODY_CODE).
constexpr int kElementBody = 0;
constexpr int kNodeBody = 1;

template <typename T>
struct SweepParams {
  SweepConsts<T> k;
  Pair<T> in, dir, out, mr;
  T* scal[6];  // [B] each: <r,Mr>, |Mr_z|, |Mr_v|, <r,Md>, |Md_z|, |Md_v|
  const T* x0;   // [B, nx]
  const T* tau;  // [B]
};

template <typename T, bool WITH_METRIC, bool WITH_DIRECTION>
__global__ void __launch_bounds__(kThreads)
cp_sweep_kernel(const __grid_constant__ SweepParams<T> P) {
  __shared__ T sh[kThreads];
  const Geo& g = P.k.g;
  const int64_t lane = blockIdx.x;
  const T tau = WITH_DIRECTION ? P.tau[lane] : T(0);
  const Cand<T, WITH_DIRECTION> c{Ref<T>{&P.in, &g, lane},
                                  Ref<T>{&P.dir, &g, lane}, tau};
  const Ref<T> o{&P.out, &g, lane};
  const Ref<T> mr{&P.mr, &g, lane};
  const SweepRed<T> red = sweep_lane<T, WITH_METRIC, WITH_DIRECTION>(
      P.k, lane, c, o, &mr, P.x0 + lane * g.nx, sh);
  if (threadIdx.x != 0 || !WITH_METRIC) return;
  P.scal[0][lane] = red.dot;
  P.scal[1][lane] = red.nz;
  P.scal[2][lane] = red.nv;
  if (!WITH_DIRECTION) return;
  P.scal[3][lane] = red.rho;
  P.scal[4][lane] = red.ndz;
  P.scal[5][lane] = red.ndv;
}

template <typename T, bool DIR>
__global__ void __launch_bounds__(kThreads)
cp_node_kernel(const __grid_constant__ NodeParams<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ Lane<T> lz, ld, lo, lmr;
  const Geo& g = P.x.k.g;
  const int64_t lane = blockIdx.x;
  const T tau = DIR ? P.tau[lane] : T(0);
  make_lane(lz, P.in, lane, g);
  make_lane(ld, P.dir, lane, g);
  make_lane(lo, P.out, lane, g);
  make_lane(lmr, P.mr, lane, g);
  stage_consts(P.x, sm);
  __syncthreads();
  const SweepRed<T> red = step_sweep<T, DIR>(
      P.x, lz, ld, tau, lo, P.metric ? &lmr : nullptr, P.metric != 0,
      P.gdv + lane * g.n_nl * P.x.s.ldu,
      P.qg ? P.qg + lane * P.x.s.qsize : nullptr, P.x0 + lane * g.nx, sm);
  if (threadIdx.x != 0 || !P.metric) return;
  P.scal[0][lane] = red.dot;
  P.scal[1][lane] = red.nz;
  P.scal[2][lane] = red.nv;
  if (!DIR) return;
  P.scal[3][lane] = red.rho;
  P.scal[4][lane] = red.ndz;
  P.scal[5][lane] = red.ndv;
}

}  // namespace

#if SPOCK_DIRECTION != 0
template <typename T>
int launch_node_direction(const NodeParams<T>& P, int B, void* stream) {
  return launch_kernel(cp_node_kernel<T, true>, P, B, stream);
}
#if SPOCK_DIRECTION == 1 && SPOCK_PART != 8
template int launch_node_direction<float>(const NodeParams<float>&, int,
                                          void*);
#endif
#if SPOCK_DIRECTION == 1 && SPOCK_PART != 4
template int launch_node_direction<double>(const NodeParams<double>&, int,
                                           void*);
#endif
#endif

#if SPOCK_DIRECTION != 1
namespace {

// Pointer order of the host array ``ptrs`` (see sweep_kernels.py), 19 a
// pair in the order of sweep_common.cuh's Block:
//   [0, 19) z, v   [19, 38) dz, dv   [38, 57) zbar, vbar   [57, 76) M r
//   [76, 82) the six [B] scalar outputs   82 x0   83 tau
//   [84, 108) the constants, in make_consts's order
//   [108, 112) scratch: the element body's gq, gw, gdv, ginner; the node
//              body's gdv [B, n_nl ldu], the costates [B, qsize] (null when
//              they fit in shared memory), two unused
// Unused pointers (the direction without one, absent polytope blocks and
// constants, ...) may be null.
constexpr int kPtrDir = kPairBlocks;
constexpr int kPtrOut = 2 * kPairBlocks;
constexpr int kPtrMr = 3 * kPairBlocks;
constexpr int kPtrScal = 4 * kPairBlocks;
constexpr int kPtrX0 = kPtrScal + 6;
constexpr int kPtrTau = kPtrX0 + 1;
constexpr int kPtrConsts = kPtrTau + 1;
constexpr int kPtrScratch = kPtrConsts + kConstPtrs;

template <typename T, class Params>
void set_io(Params& P, void* const* p) {
  for (int b = 0; b < kPairBlocks; ++b) {
    P.in.p[b] = static_cast<T*>(p[b]);
    P.dir.p[b] = static_cast<T*>(p[kPtrDir + b]);
    P.out.p[b] = static_cast<T*>(p[kPtrOut + b]);
    P.mr.p[b] = static_cast<T*>(p[kPtrMr + b]);
  }
  for (int k = 0; k < 6; ++k) P.scal[k] = static_cast<T*>(p[kPtrScal + k]);
  P.x0 = static_cast<const T*>(p[kPtrX0]);
  P.tau = static_cast<const T*>(p[kPtrTau]);
}

template <typename T>
int launch_element(void* const* p, const int* dims, double gamma,
                   double sigma, int metric, int direction, int B,
                   cudaStream_t s) {
  SweepParams<T> P;
  if (!make_consts(P.k, p + kPtrConsts, dims, gamma, sigma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  set_io<T>(P, p);
  if (B == 0) return 0;
  if (!metric) {
    cp_sweep_kernel<T, false, false><<<B, kThreads, 0, s>>>(P);
  } else if (!direction) {
    cp_sweep_kernel<T, true, false><<<B, kThreads, 0, s>>>(P);
  } else {
    cp_sweep_kernel<T, true, true><<<B, kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

// An error for a problem outside the node body's class, a layout that does
// not fit, or a per-node matrix without its node-minor copy.
template <typename T>
int launch_node(void* const* p, const int* dims, double gamma, double sigma,
                int metric, int direction, int B, void* stream) {
  NodeParams<T> P;
  SweepConsts<T>& k = P.x.k;
  if (!make_consts(k, p + kPtrConsts, dims, gamma, sigma) ||
      !node_fits(k.g) ||
      !plan_smem(P.x.s, k.g, dims, static_cast<int>(sizeof(T)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.gdv = static_cast<T*>(p[kPtrScratch]);
  P.qg = P.x.s.q_shared ? nullptr : static_cast<T*>(p[kPtrScratch + 1]);
  if ((k.lm.sq && !k.nmQ) || (k.lm.sr && !k.nmR) || (k.lm.sqn && !k.nmQN) ||
      !P.gdv || (!P.x.s.q_shared && !P.qg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  set_io<T>(P, p);
  P.metric = metric;
  return direction ? launch_node_direction<T>(P, B, stream)
                   : launch_kernel(cp_node_kernel<T, false>, P, B, stream);
}

// dims: the kDims entries of sweep_common.cuh, nseg, then nseg (kind, lo,
// hi) triples.
template <typename T>
int launch(const void* ptrs, const int* dims, double gamma, double sigma,
           int metric, int direction, int body, int B, void* stream) {
  if (B < 0 || (direction && !metric) ||
      (body != kElementBody && body != kNodeBody)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* const* p = static_cast<void* const*>(ptrs);
  if (body == kNodeBody) {
    return launch_node<T>(p, dims, gamma, sigma, metric, direction, B,
                          stream);
  }
  return launch_element<T>(p, dims, gamma, sigma, metric, direction, B,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace
#endif
}  // namespace spock

// C entry points, bound with ctypes.  ptrs: host array of the 112 device
// pointers in the order above; dims: host int array; body: 1 for the node
// body, 0 for the element body.  One thread block per lane.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a request the body does
// not take.
#if SPOCK_DIRECTION != 1 && SPOCK_PART != 8
extern "C" int cp_sweep_f32(const void* ptrs, const int* dims, double gamma,
                            double sigma, int metric, int direction, int body,
                            int B, void* stream) {
  return spock::launch<float>(ptrs, dims, gamma, sigma, metric, direction,
                              body, B, stream);
}

// The node body's shared-memory plan (step_body.cuh's node_plan) into
// out[4]: dsize is 4 or 8.
extern "C" int cp_sweep_plan(const int* dims, int dsize, int* out) {
  return dsize == 8 ? spock::node_plan<double>(dims, out)
                    : spock::node_plan<float>(dims, out);
}
#endif

#if SPOCK_DIRECTION != 1 && SPOCK_PART != 4
extern "C" int cp_sweep_f64(const void* ptrs, const int* dims, double gamma,
                            double sigma, int metric, int direction, int body,
                            int B, void* stream) {
  return spock::launch<double>(ptrs, dims, gamma, sigma, metric, direction,
                               body, B, stream);
}
#endif
