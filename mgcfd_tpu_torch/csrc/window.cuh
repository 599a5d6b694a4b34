// A block's window of completed node states in shared memory, shared by
// the two tiled RK-stage kernels (fused_stage.cu, shift_fused_stage.cu).
//
// A window holds W consecutive nodes, each completed once (complete8: the
// five conserved channels plus p, speed + speed of sound and 1/rho), as
// eight rows of W compute-type values: value r of window position p is
// s[r * W + p], so that neighbouring threads read neighbouring words.
// Nodes outside [0, n) are quiescent gas (rho = 1, momentum 0, E = 1), as
// node_or_quiescent (shift_common.cuh) has them.
//
// The state rows are read with vector loads where they are aligned: 16
// bytes a thread at float32 (4 nodes) and float64 (2 nodes), one
// __nv_bfloat162 pair at bfloat16 (2 nodes). The caller says whether they
// are (every row c * n + j of a group starts on a vector boundary); else
// each thread loads one node's five channels with scalar loads.
#pragma once

#include <atomic>

#include "shift_common.cuh"

namespace mgcfd {

// blocks of kThreads per SM that __launch_bounds__ makes the register
// allocator fit, chosen on the H100 from sweeps of 1-6: without a cap the
// tiled kernels took up to 94 registers at float32 and fitted 2 blocks
// per SM; fp64 lost time under any cap on the span stage (spills). The
// CSR stage fits as many as its shared memory allows: 5 at bfloat16, 4
// at float32 and float64.
template <typename S>
struct ShiftMinBlocks {
  static constexpr int value = 5;
};
template <>
struct ShiftMinBlocks<double> {
  static constexpr int value = 1;
};
template <typename S>
struct FusedMinBlocks {
  static constexpr int value = 4;
};
template <>
struct FusedMinBlocks<__nv_bfloat16> {
  static constexpr int value = 5;
};

template <typename S>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static constexpr int width = 2;
};

__device__ __forceinline__ void unpack(const float4& v, float o[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double o[2]) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void unpack(const __nv_bfloat162& v, float o[2]) {
  o[0] = __low2float(v);
  o[1] = __high2float(v);
}

// true when every vector group of the state rows is aligned: n a multiple
// of the width and q on a 16-byte boundary (the callers' group starts are
// multiples of the width)
template <typename S>
inline bool rows_take_vectors(const void* q, int64_t n) {
  return n % Vec<S>::width == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
__device__ __forceinline__ void put8(T* __restrict__ s, int W, int p,
                                     const State8<T>& q) {
  s[p] = q.rho;
  s[W + p] = q.mx;
  s[2 * W + p] = q.my;
  s[3 * W + p] = q.mz;
  s[4 * W + p] = q.E;
  s[5 * W + p] = q.p;
  s[6 * W + p] = q.s;
  s[7 * W + p] = q.inv;
}

template <typename T>
__device__ __forceinline__ State8<T> get8(const T* __restrict__ s, int W,
                                          int p) {
  State8<T> q;
  q.rho = s[p];
  q.mx = s[W + p];
  q.my = s[2 * W + p];
  q.mz = s[3 * W + p];
  q.E = s[4 * W + p];
  q.p = s[5 * W + p];
  q.s = s[6 * W + p];
  q.inv = s[7 * W + p];
  return q;
}

// compute-type vectors of the widths of Vec<S>, for stores to the window
template <typename C, int V>
struct CVec;
template <>
struct CVec<float, 4> {
  using type = float4;
  __device__ static type make(const float v[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct CVec<float, 2> {
  using type = float2;
  __device__ static type make(const float v[2]) {
    return make_float2(v[0], v[1]);
  }
};
template <>
struct CVec<double, 2> {
  using type = double2;
  __device__ static type make(const double v[2]) {
    return make_double2(v[0], v[1]);
  }
};

// complete the nodes [lo, lo + count) of the stored (5, n) state q into
// window positions [p0, p0 + count) of s; the block's threads share the
// work. With vec, lo, count, p0 and W are multiples of Vec<S>::width, and
// a thread's V nodes go to the window as one vector store a row.
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ void complete_window(const S* __restrict__ q,
                                                int64_t n, int64_t lo,
                                                int count, C* __restrict__ s,
                                                int W, int p0, bool vec) {
  constexpr int V = Vec<S>::width;
  using VT = typename Vec<S>::type;
  using CV = CVec<C, V>;
  if (vec) {
    for (int g = threadIdx.x; g < count / V; g += kThreads) {
      const int64_t j = lo + static_cast<int64_t>(g) * V;
      const int p = p0 + g * V;
      State8<C> z[V];
      if (j >= 0 && j + V <= n) {
        C v[5][V];
        for (int c = 0; c < 5; ++c)
          unpack(*reinterpret_cast<const VT*>(q + c * n + j), v[c]);
        for (int e = 0; e < V; ++e)
          z[e] = complete8<C>(v[0][e], v[1][e], v[2][e], v[3][e], v[4][e]);
      } else {
        for (int e = 0; e < V; ++e) z[e] = node_or_quiescent(q, n, j + e);
      }
      C r[8][V];
      for (int e = 0; e < V; ++e) {
        r[0][e] = z[e].rho;
        r[1][e] = z[e].mx;
        r[2][e] = z[e].my;
        r[3][e] = z[e].mz;
        r[4][e] = z[e].E;
        r[5][e] = z[e].p;
        r[6][e] = z[e].s;
        r[7][e] = z[e].inv;
      }
      for (int k = 0; k < 8; ++k)
        *reinterpret_cast<typename CV::type*>(s + k * W + p) =
            CV::make(r[k]);
    }
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads)
      put8(s, W, p0 + e, node_or_quiescent(q, n, lo + e));
  }
}

// copy one element from device to shared memory: asynchronously
// (cp.async, waited for by async_wait_all) where the element is 4 or 8
// bytes, else with a plain load
template <typename T>
__device__ __forceinline__ void async_copy(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4 || sizeof(T) == 8) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(T)));
    return;
  }
#endif
  *dst = *src;
}
__device__ __forceinline__ void async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// node i's update from its internal flux acc: out = old + fac * ((acc +
// boundary/wall) [+ spill]), in the compute type, rounded once on store;
// returns the invalid count of the five new values. With RES (the last RK
// stage's epilogue) it also stores the residual res = out - old, from the
// stored value: to_storage(to_compute(out) - to_compute(old)), the
// rounding of the eager q - old. A template flag, not a test of res, so
// that the other stages run the update as it was before the epilogue.
// nc, old, fac and spill are read at column ii of rows of stride nn (the
// device arrays: nn = n, ii = i; a staged copy: its own stride and column)
template <typename S, bool RES, typename C = compute_t<S>>
__device__ __forceinline__ int update_node(
    const State8<C>& qi, const C acc[5], const S* __restrict__ nc,
    const S* __restrict__ old, const S* __restrict__ fac,
    const S* __restrict__ spill, int64_t nn, int64_t ii,
    S* __restrict__ out, S* __restrict__ res, int64_t n, int64_t i) {
  C bw[5];
  bw_flux(qi, nc, nn, ii, bw);
  const C f = to_compute(fac[ii]);
  int bad = 0;
  for (int c = 0; c < 5; ++c) {
    C a = acc[c] + bw[c];
    if (spill != nullptr) a = a + to_compute(spill[c * nn + ii]);
    const C qn = to_compute(old[c * nn + ii]) + f * a;
    out[c * n + i] = to_storage<S>(qn);
    if constexpr (RES)
      res[c * n + i] = to_storage<S>(sub_rn(
          to_compute(to_storage<S>(qn)), to_compute(old[c * nn + ii])));
    bad += invalid_value(c, qn);
  }
  return bad;
}

// dynamic shared memory above the 48 KiB a launch gets without asking.
// The attribute belongs to the current device, so a kernel keeps one
// SharedGrant, the devices (by ordinal, up to 64) on which it has been
// raised to the most the kernel ever asks for: set once per device, not
// at every launch.
struct SharedGrant {
  std::atomic<uint64_t> devices{0};
};

template <typename Kernel>
inline int allow_shared(Kernel kernel, size_t most, SharedGrant& grant) {
  if (most <= 48 * 1024) return 0;
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit != 0 && (grant.devices.load() & bit) != 0) return 0;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(most)));
  if (rc == 0) grant.devices.fetch_or(bit);
  return rc;
}

}  // namespace mgcfd
