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
// Design: a stream in two passes of one launch, each thread of a pass doing
// the same work.
//   * The SOC pass: one thread per cone, over every lane's non-root nodes
//     (t6; qx, ru, t5) and leaves (s13; qNx, s12).  The thread reads its
//     column once for the norm and again to scale it, both in loops of
//     run-time length, so every width takes the same path.  Holding the
//     column in registers between the two (read once, up to 32 rows) ran
//     no faster on the card: the second read comes from the L1
//     (PERF.md, kernel_variants.py).
//   * The elementwise pass: y, sby, cx, cu and cxN, 38% of a lane's values,
//     need no column: each is a clip, y's by its cone segment (zero: [0, 0],
//     nonneg: [0, inf), nonpos: (-inf, 0], reals: no bound).  The pass runs
//     over each block as one flat array across the lanes, four 16-byte
//     vectors a thread, all loaded before the first is used (each a vector
//     load and store where the block is 16-byte aligned), with one division
//     per vector for its row and 32-bit indices where they fit.
// The arrays are feature-major with the node axis last, so neighbouring
// threads read neighbouring addresses in both passes.  One launch runs both
// passes.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // 16-byte vectors an elementwise thread owns
constexpr int kMaxSegments = 8;

// Kind codes of the dual-cone row segments (same codes as cuda_kernels.py).
constexpr int kZero = 0;
constexpr int kNonneg = 1;
constexpr int kNonpos = 2;
// kReals = 3: identity projection, the default for uncovered rows.

// The elementwise blocks, in the order of the pass.
enum ElemBlock { EY, ESBY, ECX, ECU, ECXN, kElemBlocks };

struct Segments {
  int n;
  int kind[kMaxSegments];
  int lo[kMaxSegments];
  int hi[kMaxSegments];
};

// The 12 dual blocks, in the order of spock_tpu_torch.zv.DUAL_BLOCKS.
template <typename P>
struct Blocks {
  P y, sby, qx, ru, t5, t6, cx, cu, qNx, s12, s13, cxN;
};

template <typename T>
struct ProxParams {
  Blocks<const T*> in;
  Blocks<T*> out;
  const T* xmin;
  const T* xmax;
  const T* umin;
  const T* umax;
  Segments segs;
  int nx, nu, ny;
  int n_nr, n_nl, n_lf;  // non-root, non-leaf and leaf node counts
  int64_t soc_nr;        // SOC threads of the non-root cones, B n_nr
  int64_t soc;           // SOC threads in all, B (n_nr + n_lf)
  int soc_blocks;        // blocks of the SOC pass
  // the elementwise pass: each block's pointers, values, rows and columns
  // per lane, 16-byte alignment, and first thread block; idx32: every
  // index fits 32 bits
  const T* ein[kElemBlocks];
  T* eout[kElemBlocks];
  int64_t elen[kElemBlocks];
  int erows[kElemBlocks], ecols[kElemBlocks];
  int ealigned[kElemBlocks];
  int64_t estart[kElemBlocks + 1];
  int idx32;
  T sigma, inv;
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

// The SOC (t; a rows of pa, b rows of pb, e) of one column, rows ld apart:
// sigma (w - P(w)) into qa, qb and the two scalars.  The rows are read once
// for the norm and again to scale them.
template <typename T>
__device__ __forceinline__ void soc_column(const ProxParams<T>& P,
                                           const T* __restrict__ pa, int a,
                                           const T* __restrict__ pb, int b,
                                           int64_t ld, T wt, T we, T* qa,
                                           T* qb, T* ot, T* oe) {
  const T inv = P.inv, sigma = P.sigma;
  T acc = T(0);
  for (int r = 0; r < a; ++r) {
    const T w = pa[r * ld] * inv;
    acc += w * w;
  }
  for (int r = 0; r < b; ++r) {
    const T w = pb[r * ld] * inv;
    acc += w * w;
  }
  acc += we * we;
  T t_out, xs;
  soc_pieces(wt, acc, t_out, xs);
  *ot = sigma * (wt - t_out);
  for (int r = 0; r < a; ++r) {
    const T w = pa[r * ld] * inv;
    qa[r * ld] = sigma * (w - xs * w);
  }
  for (int r = 0; r < b; ++r) {
    const T w = pb[r * ld] * inv;
    qb[r * ld] = sigma * (w - xs * w);
  }
  *oe = sigma * (we - xs * we);
}

// The SOC of SOC thread i: a non-root cone (t6; qx, ru, t5) for i < soc_nr,
// a leaf cone (s13; qNx, s12) after.
template <typename T>
__device__ __forceinline__ void soc_thread(const ProxParams<T>& P,
                                           int64_t i) {
  const T inv = P.inv;
  if (i < P.soc_nr) {
    const int64_t b = i / P.n_nr, col = i % P.n_nr;
    const int64_t n = P.n_nr, s1 = b * n + col;
    const int64_t qo = b * P.nx * n + col, ro = b * P.nu * n + col;
    const T wt6 = P.in.t6[s1] * inv + T(0.5);
    const T wt5 = P.in.t5[s1] * inv - T(0.5);
    soc_column(P, P.in.qx + qo, P.nx, P.in.ru + ro, P.nu, n, wt6,
                       wt5, P.out.qx + qo, P.out.ru + ro, P.out.t6 + s1,
                       P.out.t5 + s1);
  } else {
    const int64_t k = i - P.soc_nr;
    const int64_t b = k / P.n_lf, col = k % P.n_lf;
    const int64_t n = P.n_lf, s1 = b * n + col;
    const int64_t qo = b * P.nx * n + col;
    const T ws13 = P.in.s13[s1] * inv + T(0.5);
    const T ws12 = P.in.s12[s1] * inv - T(0.5);
    soc_column(P, P.in.qNx + qo, P.nx, P.in.qNx, 0, n, ws13, ws12,
                       P.out.qNx + qo, P.out.qNx, P.out.s13 + s1,
                       P.out.s12 + s1);
  }
}

// sigma (w - clip(w, lo, hi)), w = v / sigma, for a value of row r of
// elementwise block k.
template <typename T>
__device__ __forceinline__ T elem(const ProxParams<T>& P, int k, int r,
                                  T v) {
  const T inf = static_cast<T>(INFINITY);
  T lo = -inf, hi = inf;
  if (k == EY) {
    int kind = 3;
    for (int s = 0; s < P.segs.n; ++s) {
      if (r >= P.segs.lo[s] && r < P.segs.hi[s]) kind = P.segs.kind[s];
    }
    if (kind == kNonneg || kind == kZero) lo = T(0);
    if (kind == kNonpos || kind == kZero) hi = T(0);
  } else if (k == ESBY) {
    lo = T(0);
  } else if (k == ECU) {
    lo = P.umin[r];
    hi = P.umax[r];
  } else {
    lo = P.xmin[r];
    hi = P.xmax[r];
  }
  const T w = v * P.inv;
  return P.sigma * (w - clip(w, lo, hi));
}

// The 16 bytes of values of one vector of an elementwise thread.
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// The kUnroll vectors of an elementwise thread in block k, from vector v0
// kThreads apart (so that each load of a warp is one coalesced stretch),
// all loaded before any is used; a vector is one 16-byte load and store
// where the block is aligned and holds it whole.  Indices of type I.
template <typename T, typename I>
__device__ __forceinline__ void elem_thread(const ProxParams<T>& P, int k,
                                            I v0) {
  constexpr int kV = 16 / sizeof(T);
  const T* in = P.ein[k];
  T* out = P.eout[k];
  const I len = static_cast<I>(P.elen[k]);
  const I cols = static_cast<I>(P.ecols[k]);
  const I rows = static_cast<I>(P.erows[k]);
  const bool vec = P.ealigned[k];
  Pack<T> p[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const I e0 = (v0 + static_cast<I>(j * kThreads)) * kV;
    if (vec && e0 + kV <= len) {
      p[j] = *reinterpret_cast<const Pack<T>*>(in + e0);
    } else {
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        p[j].v[u] = e0 + u < len ? in[e0 + u] : T(0);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const I e0 = (v0 + static_cast<I>(j * kThreads)) * kV;
    if (e0 >= len) break;
    // the row of the vector's first value, then of each next one
    const I q = e0 / cols;
    I c = e0 - q * cols;
    int r = static_cast<int>(q % rows);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      if (c == cols) {
        c = 0;
        r = r + 1 == static_cast<int>(rows) ? 0 : r + 1;
      }
      p[j].v[u] = elem(P, k, r, p[j].v[u]);
      ++c;
    }
    if (vec && e0 + kV <= len) {
      *reinterpret_cast<Pack<T>*>(out + e0) = p[j];
    } else {
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        if (e0 + u < len) out[e0 + u] = p[j].v[u];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
prox_h_conj_kernel(const __grid_constant__ ProxParams<T> P) {
  const int64_t blk = blockIdx.x;
  if (blk < P.soc_blocks) {
    const int64_t i = blk * kThreads + threadIdx.x;
    if (i >= P.soc) return;
    soc_thread(P, i);
    return;
  }
  // the elementwise block k that this thread block works in
  const int64_t eb = blk - P.soc_blocks;
  int k = 0;
  while (k + 1 < kElemBlocks && eb >= P.estart[k + 1]) ++k;
  const int64_t v0 = (eb - P.estart[k]) * kThreads * kUnroll + threadIdx.x;
  if (P.idx32) {
    elem_thread<T, uint32_t>(P, k, static_cast<uint32_t>(v0));
  } else {
    elem_thread<T, int64_t>(P, k, v0);
  }
}

template <typename T>
int launch(const void* in_ptrs, const void* out_ptrs, const void* bound_ptrs,
           const void* seg_triples, int nseg, double sigma, double inv, int B,
           int nx, int nu, int ny, int n_nl, int n_lf, void* stream) {
  if (nseg < 0 || nseg > kMaxSegments || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const* ip = static_cast<const void* const*>(in_ptrs);
  void* const* op = static_cast<void* const*>(out_ptrs);
  const void* const* bp = static_cast<const void* const*>(bound_ptrs);
  const int* st = static_cast<const int*>(seg_triples);

  ProxParams<T> P{};
  const T** inf[12] = {&P.in.y, &P.in.sby, &P.in.qx, &P.in.ru,
                       &P.in.t5, &P.in.t6, &P.in.cx, &P.in.cu,
                       &P.in.qNx, &P.in.s12, &P.in.s13, &P.in.cxN};
  T** outf[12] = {&P.out.y, &P.out.sby, &P.out.qx, &P.out.ru,
                  &P.out.t5, &P.out.t6, &P.out.cx, &P.out.cu,
                  &P.out.qNx, &P.out.s12, &P.out.s13, &P.out.cxN};
  for (int i = 0; i < 12; ++i) {
    *inf[i] = static_cast<const T*>(ip[i]);
    *outf[i] = static_cast<T*>(op[i]);
  }
  P.xmin = static_cast<const T*>(bp[0]);
  P.xmax = static_cast<const T*>(bp[1]);
  P.umin = static_cast<const T*>(bp[2]);
  P.umax = static_cast<const T*>(bp[3]);
  P.segs.n = nseg;
  for (int s = 0; s < nseg; ++s) {
    P.segs.kind[s] = st[3 * s];
    P.segs.lo[s] = st[3 * s + 1];
    P.segs.hi[s] = st[3 * s + 2];
  }
  P.nx = nx;
  P.nu = nu;
  P.ny = ny;
  P.n_nr = n_nl + n_lf - 1;
  P.n_nl = n_nl;
  P.n_lf = n_lf;
  P.sigma = static_cast<T>(sigma);
  P.inv = static_cast<T>(inv);
  P.soc_nr = static_cast<int64_t>(B) * P.n_nr;
  P.soc = P.soc_nr + static_cast<int64_t>(B) * n_lf;
  const int64_t soc_blocks = (P.soc + kThreads - 1) / kThreads;
  const T* ein[kElemBlocks] = {P.in.y, P.in.sby, P.in.cx, P.in.cu, P.in.cxN};
  T* eout[kElemBlocks] = {P.out.y, P.out.sby, P.out.cx, P.out.cu, P.out.cxN};
  const int erows[kElemBlocks] = {ny, 1, nx, nu, nx};
  const int ecols[kElemBlocks] = {n_nl, n_nl, n_nl, n_nl, n_lf};
  // values an elementwise thread block owns, and the index bound that
  // 32-bit indices must cover
  constexpr int64_t kBlockValues = 16 / sizeof(T) * kThreads * kUnroll;
  int64_t reach = 0;
  P.estart[0] = 0;
  for (int k = 0; k < kElemBlocks; ++k) {
    P.ein[k] = ein[k];
    P.eout[k] = eout[k];
    P.erows[k] = erows[k];
    P.ecols[k] = ecols[k];
    P.elen[k] = static_cast<int64_t>(B) * erows[k] * ecols[k];
    P.ealigned[k] = ((reinterpret_cast<uintptr_t>(ein[k]) |
                      reinterpret_cast<uintptr_t>(eout[k])) % 16) == 0;
    const int64_t nblk = (P.elen[k] + kBlockValues - 1) / kBlockValues;
    P.estart[k + 1] = P.estart[k] + nblk;
    reach = reach > nblk * kBlockValues ? reach : nblk * kBlockValues;
  }
  P.idx32 = reach < (int64_t(1) << 32);
  const int64_t elem_blocks = P.estart[kElemBlocks];
  const int64_t blocks = soc_blocks + elem_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  P.soc_blocks = static_cast<int>(soc_blocks);
  if (blocks == 0) return 0;
  prox_h_conj_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(P);
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
