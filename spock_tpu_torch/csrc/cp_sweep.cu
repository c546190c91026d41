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
//           half-line, the two second-order cones, the boxes and the
//           two-sided polytope rows
// for the JAX kernels' whole problem class: costs and risk data uniform or
// per node, with or without polytope rows (sweep_common.cuh).
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
// Per-node cost matrices add 4.1 MB read by every lane (from L2), polytope
// rows 1.5 kB a lane of each pair.
//
// Design (simple and right first): one thread block of 512 threads per lane,
// running sweep_lane of sweep_body.cuh, which sp_step.cu shares; the stages
// are walked inside the block, the intermediates live in the outputs and in
// four wrapper-allocated scratch arrays, and the per-lane reductions are
// fixed-order block reductions (deterministic, no atomics).  At B = 128 the
// launch fills 128 of the 132 SMs with one block each; nothing more is done
// about the memory bound yet.

#include "sweep_body.cuh"

namespace spock {
namespace {

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

// Pointer order of the host array ``ptrs`` (see sweep_kernels.py), 19 a
// pair in the order of sweep_common.cuh's Block:
//   [0, 19) z, v   [19, 38) dz, dv   [38, 57) zbar, vbar   [57, 76) M r
//   [76, 82) the six [B] scalar outputs   82 x0   83 tau
//   [84, 109) the constants and scratch, in make_consts's order
// Unused pointers (the direction without WITH_DIRECTION, absent polytope
// blocks and constants, ...) may be null.
constexpr int kPtrDir = kPairBlocks;
constexpr int kPtrOut = 2 * kPairBlocks;
constexpr int kPtrMr = 3 * kPairBlocks;
constexpr int kPtrScal = 4 * kPairBlocks;
constexpr int kPtrX0 = kPtrScal + 6;
constexpr int kPtrTau = kPtrX0 + 1;
constexpr int kPtrConsts = kPtrTau + 1;

// dims: the kDims entries of sweep_common.cuh, nseg, then nseg (kind, lo,
// hi) triples.
template <typename T>
int launch(const void* ptrs, const int* dims, double gamma, double sigma,
           int metric, int direction, int B, void* stream) {
  if (B < 0 || (direction && !metric)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SweepParams<T> P;
  void* const* p = static_cast<void* const*>(ptrs);
  if (!make_consts(P.k, p + kPtrConsts, dims, gamma, sigma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < kPairBlocks; ++b) {
    P.in.p[b] = static_cast<T*>(p[b]);
    P.dir.p[b] = static_cast<T*>(p[kPtrDir + b]);
    P.out.p[b] = static_cast<T*>(p[kPtrOut + b]);
    P.mr.p[b] = static_cast<T*>(p[kPtrMr + b]);
  }
  for (int k = 0; k < 6; ++k) P.scal[k] = static_cast<T*>(p[kPtrScal + k]);
  P.x0 = static_cast<const T*>(p[kPtrX0]);
  P.tau = static_cast<const T*>(p[kPtrTau]);
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

// C entry points, bound with ctypes.  ptrs: host array of the 109 device
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
