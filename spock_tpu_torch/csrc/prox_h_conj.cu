// Moreau prox of sigma * h* for one dual iterate, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spock_tpu/ops/pallas_kernels.py ::
// prox_h_conj_fused (kernel body _prox_h_kernel).  Its plain PyTorch version
// is spock_tpu_torch/ops/prox.py :: prox_h_conj; the wrapper, the launch count
// and the dispatch live in spock_tpu_torch/ops/cuda_kernels.py.
//
// What it computes, with w = v / sigma and the epigraph shifts
// (t5 - 1/2, t6 + 1/2, s12 - 1/2, s13 + 1/2):
//   out = sigma * (w - P(w)), where P projects
//   y          onto the polyhedral dual cone K* (row segments of kind
//              zero / nonneg / nonpos / reals),
//   sby        onto [0, inf),
//   (t6; qx, ru, t5)   onto the second-order cone, per non-root node,
//   (s13; qNx, s12)    onto the second-order cone, per leaf node,
//   cx, cxN    onto the state box, cu onto the input box.
//
// What bounds it: memory.  It reads the nv values of the dual iterate of each
// lane once and writes nv once, with a handful of operations per value.  At
// the headline size (B = 128 lanes, server_heat N=10 nx=nu=20 d=2,
// nv = 87,934, float32) that is 2 x 87,934 x 4 B x 128 = 90 MB per launch,
// about 27 us at the H100's 3.35 TB/s.
//
// Design (simple and right first): one thread owns one node column of one
// lane, and the grid is (column tiles x lanes).  The columns of a lane are
// laid end to end in three ranges:
//   [0, n_nr)                    non-root SOC on (t6; qx, ru, t5)
//   [n_nr, n_nr + n_nl)          non-leaf: y (dual cone), sby, boxes on cx, cu
//   [n_nr + n_nl, ... + n_lf)    leaf SOC on (s13; qNx, s12), box on cxN
// The arrays are feature-major with the node axis last, so neighbouring
// threads read neighbouring addresses and every load and store coalesces.
// The SOC norm walks the feature rows of the column and the scale pass reads
// them a second time; that second read hits L1/L2.  The design does nothing
// more about the memory bound yet.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSegments = 8;

// Kind codes of the dual-cone row segments (same codes as cuda_kernels.py).
constexpr int kZero = 0;
constexpr int kNonneg = 1;
constexpr int kNonpos = 2;
// kReals = 3: identity projection, the default for uncovered rows.

struct Segments {
  int n;
  int kind[kMaxSegments];
  int lo[kMaxSegments];
  int hi[kMaxSegments];
};

// The 12 dual blocks, in the order of spock_tpu_torch.zv.DUAL_BLOCKS.
template <typename T, typename P>
struct Blocks {
  P y, sby, qx, ru, t5, t6, cx, cu, qNx, s12, s13, cxN;
};

struct Dims {
  int nx, nu, ny;
  int n_nr, n_nl, n_lf;  // non-root, non-leaf and leaf node counts
};

template <typename T>
__device__ __forceinline__ T clip(T w, T lo, T hi) {
  // min(max(w, lo), hi), NaN passes through as in torch.clamp
  T c = w < lo ? lo : w;
  return c > hi ? hi : c;
}

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// SOC projection factors from t and ||x||^2: t_out, and the scale that maps
// every x component onto its projection.
template <typename T>
__device__ __forceinline__ void soc_pieces(T t, T xn_sq, T& t_out,
                                           T& x_scale) {
  const T xn = root(xn_sq);
  const bool inside = xn <= t;
  const bool polar = xn <= -t;
  const T safe = xn > T(0) ? xn : T(1);
  const T t_new = (t + xn) / T(2);
  const T scale = t_new / safe;
  t_out = inside ? t : (polar ? T(0) : t_new);
  x_scale = inside ? T(1) : (polar ? T(0) : scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prox_h_conj_kernel(Blocks<T, const T*> in, Blocks<T, T*> out,
                   const T* __restrict__ xmin, const T* __restrict__ xmax,
                   const T* __restrict__ umin, const T* __restrict__ umax,
                   Segments segs, Dims dm, T sigma, T inv) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t b = blockIdx.y;

  if (col < dm.n_nr) {
    // ---- non-root SOC: t = t6/sigma + 1/2; x = (qx, ru, t5/sigma - 1/2)
    const int64_t n = dm.n_nr;
    const int64_t s1 = b * n + col;
    const int64_t qo = b * dm.nx * n + col;
    const int64_t ro = b * dm.nu * n + col;
    const T wt6 = in.t6[s1] * inv + T(0.5);
    const T wt5 = in.t5[s1] * inv - T(0.5);
    T acc = T(0);
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.qx[qo + r * n] * inv;
      acc += w * w;
    }
    for (int r = 0; r < dm.nu; ++r) {
      const T w = in.ru[ro + r * n] * inv;
      acc += w * w;
    }
    acc += wt5 * wt5;
    T t_out, xs;
    soc_pieces(wt6, acc, t_out, xs);
    out.t6[s1] = sigma * (wt6 - t_out);
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.qx[qo + r * n] * inv;
      out.qx[qo + r * n] = sigma * (w - xs * w);
    }
    for (int r = 0; r < dm.nu; ++r) {
      const T w = in.ru[ro + r * n] * inv;
      out.ru[ro + r * n] = sigma * (w - xs * w);
    }
    out.t5[s1] = sigma * (wt5 - xs * wt5);
    return;
  }

  if (col < dm.n_nr + dm.n_nl) {
    // ---- non-leaf node: y on K*, sby on [0, inf), boxes on cx and cu
    const int64_t n = dm.n_nl;
    const int64_t j = col - dm.n_nr;
    const int64_t yo = b * dm.ny * n + j;
    for (int r = 0; r < dm.ny; ++r) {
      int kind = 3;
      for (int s = 0; s < segs.n; ++s) {
        if (r >= segs.lo[s] && r < segs.hi[s]) kind = segs.kind[s];
      }
      const T w = in.y[yo + r * n] * inv;
      T p = w;
      if (kind == kNonneg) {
        p = w < T(0) ? T(0) : w;
      } else if (kind == kNonpos) {
        p = w > T(0) ? T(0) : w;
      } else if (kind == kZero) {
        p = T(0);
      }
      out.y[yo + r * n] = sigma * (w - p);
    }
    const T ws = in.sby[b * n + j] * inv;
    out.sby[b * n + j] = sigma * (ws - (ws < T(0) ? T(0) : ws));
    const int64_t xo = b * dm.nx * n + j;
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.cx[xo + r * n] * inv;
      out.cx[xo + r * n] = sigma * (w - clip(w, xmin[r], xmax[r]));
    }
    const int64_t uo = b * dm.nu * n + j;
    for (int r = 0; r < dm.nu; ++r) {
      const T w = in.cu[uo + r * n] * inv;
      out.cu[uo + r * n] = sigma * (w - clip(w, umin[r], umax[r]));
    }
    return;
  }

  if (col < dm.n_nr + dm.n_nl + dm.n_lf) {
    // ---- leaf SOC: t = s13/sigma + 1/2; x = (qNx, s12/sigma - 1/2); box
    const int64_t n = dm.n_lf;
    const int64_t j = col - dm.n_nr - dm.n_nl;
    const int64_t s1 = b * n + j;
    const int64_t qo = b * dm.nx * n + j;
    const T ws13 = in.s13[s1] * inv + T(0.5);
    const T ws12 = in.s12[s1] * inv - T(0.5);
    T acc = T(0);
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.qNx[qo + r * n] * inv;
      acc += w * w;
    }
    acc += ws12 * ws12;
    T t_out, xs;
    soc_pieces(ws13, acc, t_out, xs);
    out.s13[s1] = sigma * (ws13 - t_out);
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.qNx[qo + r * n] * inv;
      out.qNx[qo + r * n] = sigma * (w - xs * w);
    }
    out.s12[s1] = sigma * (ws12 - xs * ws12);
    for (int r = 0; r < dm.nx; ++r) {
      const T w = in.cxN[qo + r * n] * inv;
      out.cxN[qo + r * n] = sigma * (w - clip(w, xmin[r], xmax[r]));
    }
  }
}

template <typename T>
int launch(const void* in_ptrs, const void* out_ptrs, const void* bound_ptrs,
           const void* seg_triples, int nseg, double sigma, double inv, int B,
           int nx, int nu, int ny, int n_nl, int n_lf, void* stream) {
  if (nseg < 0 || nseg > kMaxSegments || B < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const* ip = static_cast<const void* const*>(in_ptrs);
  void* const* op = static_cast<void* const*>(out_ptrs);
  const void* const* bp = static_cast<const void* const*>(bound_ptrs);
  const int* st = static_cast<const int*>(seg_triples);

  Blocks<T, const T*> in;
  Blocks<T, T*> out;
  const T** inf[12] = {&in.y, &in.sby, &in.qx, &in.ru, &in.t5, &in.t6,
                       &in.cx, &in.cu, &in.qNx, &in.s12, &in.s13, &in.cxN};
  T** outf[12] = {&out.y, &out.sby, &out.qx, &out.ru, &out.t5, &out.t6,
                  &out.cx, &out.cu, &out.qNx, &out.s12, &out.s13, &out.cxN};
  for (int i = 0; i < 12; ++i) {
    *inf[i] = static_cast<const T*>(ip[i]);
    *outf[i] = static_cast<T*>(op[i]);
  }
  Segments segs;
  segs.n = nseg;
  for (int s = 0; s < nseg; ++s) {
    segs.kind[s] = st[3 * s];
    segs.lo[s] = st[3 * s + 1];
    segs.hi[s] = st[3 * s + 2];
  }
  Dims dm{nx, nu, ny, n_nl + n_lf - 1, n_nl, n_lf};
  const int cols = dm.n_nr + dm.n_nl + dm.n_lf;
  if (B == 0 || cols == 0) return 0;
  const dim3 grid((cols + kThreads - 1) / kThreads, B);
  prox_h_conj_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<const T*>(bp[0]), static_cast<const T*>(bp[1]),
      static_cast<const T*>(bp[2]), static_cast<const T*>(bp[3]), segs, dm,
      static_cast<T>(sigma), static_cast<T>(inv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.  in_ptrs / out_ptrs: host arrays of 12
// device pointers (the dual blocks, in DUAL_BLOCKS order); bound_ptrs: host
// array of 4 device pointers (x_min, x_max, u_min, u_max); seg_triples: host
// array of nseg (kind, lo, hi) int triples.  Returns cudaGetLastError().
extern "C" int prox_h_conj_f32(const void* in_ptrs, const void* out_ptrs,
                               const void* bound_ptrs, const void* seg_triples,
                               int nseg, double sigma, double inv, int B,
                               int nx, int nu, int ny, int n_nl, int n_lf,
                               void* stream) {
  return launch<float>(in_ptrs, out_ptrs, bound_ptrs, seg_triples, nseg, sigma,
                       inv, B, nx, nu, ny, n_nl, n_lf, stream);
}

extern "C" int prox_h_conj_f64(const void* in_ptrs, const void* out_ptrs,
                               const void* bound_ptrs, const void* seg_triples,
                               int nseg, double sigma, double inv, int B,
                               int nx, int nu, int ny, int n_nl, int n_lf,
                               void* stream) {
  return launch<double>(in_ptrs, out_ptrs, bound_ptrs, seg_triples, nseg,
                        sigma, inv, B, nx, nu, ny, n_nl, n_lf, stream);
}
