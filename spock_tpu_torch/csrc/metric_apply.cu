// The SuperMann metric M (z, v) = (z - gamma L' v, v - sigma L z) of every
// lane in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spock_tpu/ops/pallas_sweep.py ::
// metric_apply_fused (kernel body _make_metric_kernel), for its whole
// problem class: costs and risk data uniform or per node, with or without
// polytope rows.  Its plain PyTorch version is spock_tpu_torch/ops/linop.py
// :: metric_apply; the wrapper, the choice of body, the launch counts and the
// checks live in spock_tpu_torch/ops/sweep_kernels.py.  SuperMann's Broyden
// direction applies it to the secant step s once per iteration.
//
// What bounds it: memory.  It reads the lane's pair (nz + nv values) once and
// writes the image once: at the headline size (B = 128 lanes of server_heat
// N=10 nx=nu=20 d=2, float32) 126 MB, 38 us at 3.35 TB/s, against 0.56 GFLOP
// of the L and L' blocks (8 us at 67 TFLOP/s).  Per-node cost matrices
// (4.1 MB at that size) are read twice by every lane, once in L and once in
// L': 8.2 MB a lane from the L2.
//
// Design.  M is a map with no barrier, so a lane is not tied to a block.
// Two bodies, chosen on the host by the problem's class and passed in:
//   * the node body, for nx, nu, ny + 2 d and polytope rows of at most 32
//     (step_body.cuh's node_fits, the rule of the sweep kernels):
//     step_body.cuh's metric_node, the pass that the sweep kernels run for
//     M r, with a residual that reads nothing.  A thread owns one node of
//     one lane and writes every entry of M x that the node owns, its input
//     columns in registers.  A warp takes 32 consecutive nodes of one lane,
//     so its loads of node-major rows and of the node-minor cost rows
//     coalesce; a block takes the same node tile for kMetricLanes lanes,
//     one warp each.  The grid covers (node tiles x lane groups): 32 x 32
//     blocks at the headline with B = 128, 32 x 1 at B = 4.  Shared memory
//     holds the uniform cost matrices and their transposes only
//     (metric_plan: 9,600 bytes in float32 at the headline), so several
//     blocks share an SM.  Row loads are batched kMetricBatch at a time,
//     and the launch bound asks for kMetricMinBlocks blocks an SM, which
//     caps a thread at 128 registers: the pass then spills a little, but
//     runs with twice the warps an SM and faster at B = 128 than with the
//     196 registers it takes uncapped.  The constants were chosen against
//     their neighbours on the card (kernel_variants.py, PERF.md).  The
//     warps of a block do not share per-node cost rows through the L1 in
//     practice, and staging a tile's rows in shared memory ran slower;
//   * the element body for every other problem: one block per lane whose
//     threads stride over the (row, node) elements of each output block,
//     each element computing its own row of L or L' from the lane's input
//     in device memory (sweep_common.cuh's L_at and LT_at).

#include "step_body.cuh"

namespace spock {
namespace {

// The body codes of the C entries (sweep_kernels.py's BODY_CODE).
constexpr int kElementBody = 0;
constexpr int kNodeBody = 1;
// The node body: nodes a block's warps take, lanes (warps) a block, the
// blocks an SM its launch bound asks for, and the rows of a node whose loads
// are in flight together.
constexpr int kNodeTile = 32;
constexpr int kMetricLanes = 4;
constexpr int kMetricThreads = kMetricLanes * 32;
constexpr int kMetricMinBlocks = 4;
constexpr int kMetricBatch = 4;

template <typename T>
struct MetricParams {
  Geo g;
  Pair<T> in, out;
  LMats<T> lm;
  T gamma, sigma;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
metric_apply_kernel(const __grid_constant__ MetricParams<T> P) {
  const Geo& g = P.g;
  const int64_t lane = blockIdx.x;
  const Ref<T> a{&P.in, &g, lane};
  const Ref<T> o{&P.out, &g, lane};
  each_primal([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int i, int idx) {
      o(BLK, idx) = a(BLK, idx) - P.gamma * LT_at<BLK>(g, P.lm, r, i, a);
    });
  });
  each_dual([&](auto blk) {
    constexpr int BLK = decltype(blk)::value;
    for_elems<BLK>(g, [&](int r, int j, int idx) {
      o(BLK, idx) = a(BLK, idx) - P.sigma * L_at<BLK>(g, P.lm, r, j, a);
    });
  });
}

template <typename T>
struct MetricNodeParams {
  StepConsts<T> x;  // the geometry, L's matrices, the node-minor copies
  Pair<T> in, out;
  int B;            // lanes in all
};

template <typename T>
__global__ void __launch_bounds__(kMetricThreads, kMetricMinBlocks)
metric_node_kernel(const __grid_constant__ MetricNodeParams<T> P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ Lane<T> lin[kMetricLanes], lout[kMetricLanes];
  const Geo& g = P.x.k.g;
  const int warp = threadIdx.x / 32, tl = threadIdx.x % 32;
  const int64_t lane =
      static_cast<int64_t>(blockIdx.y) * kMetricLanes + warp;
  const bool live = lane < P.B;
  if (live && tl < kPairBlocks) {
    lin[warp].p[tl] = P.in.p[tl] ? P.in.p[tl] + lane * g.lsz[tl] : nullptr;
    lout[warp].p[tl] = P.out.p[tl] ? P.out.p[tl] + lane * g.lsz[tl] : nullptr;
  }
  stage_cost_mats(P.x, sm, threadIdx.x, kMetricThreads);
  __syncthreads();
  const int nd = blockIdx.x * kNodeTile + tl;
  if (!live || nd >= g.n) return;
  T sum = T(0), mz = T(0), mv = T(0);
  metric_node<T, LaneAt<T>, NoResidual<T>, kMetricBatch>(
      P.x, sm, nd, LaneAt<T>{&lin[warp]}, NoResidual<T>{}, &lout[warp], sum,
      mz, mv);
}

// Pointer order of the host array ``ptrs`` (see sweep_kernels.py):
//   [0, 19) z, v   [19, 38) M z, M v
//   [38, 45) sqrtQ, sqrtR, sqrtQN, b, Gx, Gu, GxN (make_lmats's order)
//   [45, 48) the node-minor copies of sqrtQ, sqrtR, sqrtQN (the node body's;
//            null when uniform)
// Absent polytope blocks and rows are null.
constexpr int kPtrOut = kPairBlocks;
constexpr int kPtrLMats = 2 * kPairBlocks;
constexpr int kPtrNodeMinor = kPtrLMats + kLMatPtrs;

template <typename T>
void set_pairs(Pair<T>& in, Pair<T>& out, void* const* p) {
  for (int b = 0; b < kPairBlocks; ++b) {
    in.p[b] = static_cast<T*>(p[b]);
    out.p[b] = static_cast<T*>(p[kPtrOut + b]);
  }
}

template <typename T>
int launch_element(void* const* p, const int* dims, double gamma,
                   double sigma, int B, cudaStream_t stream) {
  MetricParams<T> P;
  if (!make_geo(P.g, dims)) return static_cast<int>(cudaErrorInvalidValue);
  set_pairs(P.in, P.out, p);
  make_lmats(P.lm, p + kPtrLMats, P.g, dims);
  P.gamma = static_cast<T>(gamma);
  P.sigma = static_cast<T>(sigma);
  if (B == 0) return 0;
  metric_apply_kernel<T><<<B, kThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// An error for a problem outside the node body's class, or a per-node
// matrix without its node-minor copy.
template <typename T>
int launch_node(void* const* p, const int* dims, double gamma, double sigma,
                int B, cudaStream_t stream) {
  MetricNodeParams<T> P{};
  SweepConsts<T>& k = P.x.k;
  if (!make_geo(k.g, dims) ||
      !metric_plan(P.x.s, k.g, dims, static_cast<int>(sizeof(T)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  make_lmats(k.lm, p + kPtrLMats, k.g, dims);
  k.nmQ = dims[DIM_PN_Q] ? static_cast<const T*>(p[kPtrNodeMinor]) : nullptr;
  k.nmR = dims[DIM_PN_R] ? static_cast<const T*>(p[kPtrNodeMinor + 1])
                         : nullptr;
  k.nmQN = dims[DIM_PN_QN] ? static_cast<const T*>(p[kPtrNodeMinor + 2])
                           : nullptr;
  if ((k.lm.sq && !k.nmQ) || (k.lm.sr && !k.nmR) || (k.lm.sqn && !k.nmQN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  k.gamma = static_cast<T>(gamma);
  k.sigma = static_cast<T>(sigma);
  set_pairs(P.in, P.out, p);
  P.B = B;
  const int groups = (B + kMetricLanes - 1) / kMetricLanes;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (P.x.s.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        metric_node_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P.x.s.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((k.g.n + kNodeTile - 1) / kNodeTile, groups);
  metric_node_kernel<T><<<grid, kMetricThreads, P.x.s.bytes, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// dims: the kDims entries of sweep_common.cuh.
template <typename T>
int launch(const void* ptrs, const int* dims, double gamma, double sigma,
           int body, int B, void* stream) {
  if (B < 0 || (body != kElementBody && body != kNodeBody)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* const* p = static_cast<void* const*>(ptrs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return body == kNodeBody
             ? launch_node<T>(p, dims, gamma, sigma, B, s)
             : launch_element<T>(p, dims, gamma, sigma, B, s);
}

// The node body's shared-memory bytes for dims and values of T (-1 and an
// error outside its class).
template <typename T>
int plan(const int* dims, int* bytes) {
  Geo g;
  StepSmem s;
  if (!make_geo(g, dims) ||
      !metric_plan(s, g, dims, static_cast<int>(sizeof(T)))) {
    *bytes = -1;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *bytes = s.bytes;
  return 0;
}

}  // namespace
}  // namespace spock

// C entry points, bound with ctypes.  ptrs: host array of the 48 device
// pointers in the order above; dims: host int array; body: 1 for the node
// body, 0 for the element body.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a request the
// body does not take.
extern "C" int metric_apply_f32(const void* ptrs, const int* dims,
                                double gamma, double sigma, int body, int B,
                                void* stream) {
  return spock::launch<float>(ptrs, dims, gamma, sigma, body, B, stream);
}

extern "C" int metric_apply_f64(const void* ptrs, const int* dims,
                                double gamma, double sigma, int body, int B,
                                void* stream) {
  return spock::launch<double>(ptrs, dims, gamma, sigma, body, B, stream);
}

// The node body's shared-memory plan (step_body.cuh's metric_plan) into
// *bytes: dsize is 4 or 8.
extern "C" int metric_apply_plan(const int* dims, int dsize, int* bytes) {
  return dsize == 8 ? spock::plan<double>(dims, bytes)
                    : spock::plan<float>(dims, bytes);
}
