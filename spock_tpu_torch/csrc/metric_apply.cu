// The SuperMann metric M (z, v) = (z - gamma L' v, v - sigma L z) per lane in
// one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spock_tpu/ops/pallas_sweep.py ::
// metric_apply_fused (kernel body _make_metric_kernel), for its whole
// problem class: costs and risk data uniform or per node, with or without
// polytope rows.  Its plain PyTorch
// version is spock_tpu_torch/ops/linop.py :: metric_apply; the wrapper, the
// launch count and the checks live in spock_tpu_torch/ops/sweep_kernels.py.
// SuperMann's Broyden direction applies it to the secant step s once per
// iteration.
//
// What bounds it: memory.  It reads the lane's pair (nz + nv values) once and
// writes the image once: at the headline size (B = 128 lanes of server_heat
// N=10 nx=nu=20 d=2, float32) 126 MB, 38 us at 3.35 TB/s, against 0.56 GFLOP
// of the L and L' blocks (8 us at 67 TFLOP/s).
//
// Design: the layout of cp_sweep.cu, one thread block per lane whose threads
// stride over the (row, node) elements of each output block, computing each
// element from the lane's input in device memory (sweep_common.cuh).  The
// element needs no other output, so the launch has no barrier.  A node's
// parent and children columns are read again by its neighbours, from L1/L2;
// nothing more is done about the memory bound yet.

#include "sweep_common.cuh"

namespace spock {
namespace {

constexpr int kThreads = 512;

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

// Pointer order of the host array ``ptrs`` (see sweep_kernels.py):
//   [0, 19) z, v   [19, 38) M z, M v
//   [38, 45) sqrtQ, sqrtR, sqrtQN, b, Gx, Gu, GxN (make_lmats's order)
// Absent polytope blocks and rows are null.
// dims: the kDims entries of sweep_common.cuh.
template <typename T>
int launch(const void* ptrs, const int* dims, double gamma, double sigma,
           int B, void* stream) {
  MetricParams<T> P;
  if (B < 0 || !make_geo(P.g, dims)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* const* p = static_cast<void* const*>(ptrs);
  for (int b = 0; b < kPairBlocks; ++b) {
    P.in.p[b] = static_cast<T*>(p[b]);
    P.out.p[b] = static_cast<T*>(p[kPairBlocks + b]);
  }
  make_lmats(P.lm, p + 2 * kPairBlocks, P.g, dims);
  P.gamma = static_cast<T>(gamma);
  P.sigma = static_cast<T>(sigma);
  if (B == 0) return 0;
  metric_apply_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace spock

// C entry points, bound with ctypes.  One thread block per lane.  Returns
// cudaGetLastError().
extern "C" int metric_apply_f32(const void* ptrs, const int* dims,
                                double gamma, double sigma, int B,
                                void* stream) {
  return spock::launch<float>(ptrs, dims, gamma, sigma, B, stream);
}

extern "C" int metric_apply_f64(const void* ptrs, const int* dims,
                                double gamma, double sigma, int B,
                                void* stream) {
  return spock::launch<double>(ptrs, dims, gamma, sigma, B, stream);
}
