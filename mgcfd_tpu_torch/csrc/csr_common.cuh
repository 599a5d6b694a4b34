// Device math shared by the kernels: the per-half-edge Euler flux over an
// owner-sorted CSR, the dense boundary + wall flux and the invalid-state
// count, written from what the Pallas kernels of mgcfd_tpu/pallas/
// (flux_window.py: _complete8 :150, _flux_math :169, _bw_flux_ch :335;
// flux_shift.py: _stage_channels :60, _edge_val_ch :80, _bw_flux :357)
// compute, with the same operation order.
// State arrays are variable-major (5, n): channel c of node j is x[c*n + j].
//
// Every kernel is a template on its storage type S (float, double or
// __nv_bfloat16) and computes in compute_t<S>: S itself for float and
// double, float for bfloat16. bfloat16 is a storage format, as in the
// Pallas kernels' bf16 branches: each value is widened exactly on load
// (__bfloat162float) and each result rounded once, to nearest even, on
// store (__float2bfloat16_rn, what astype(bfloat16) does). Rows are
// 2-byte aligned at bfloat16: the kernels take vector loads only where
// they check the alignment (window.cuh, edge_csr.cu's chunked loads).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mgcfd {

// storage type -> compute type
template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using compute_t = typename Compute<S>::type;

__device__ __forceinline__ float to_compute(float v) { return v; }
__device__ __forceinline__ double to_compute(double v) { return v; }
__device__ __forceinline__ float to_compute(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S to_storage(compute_t<S> v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_storage<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the dtype code of the C entry points (kernels/build.py DTYPE_CODES):
// calls launch(S{}) with the storage type's value-initialised tag, or
// returns cudaErrorInvalidValue for an unknown code
enum DType : int64_t { kFloat32 = 0, kFloat64 = 1, kBFloat16 = 2 };

template <typename Launch>
inline int dispatch_dtype(int64_t dtype, Launch&& launch) {
  switch (dtype) {
    case kFloat32:
      return launch(float{});
    case kFloat64:
      return launch(double{});
    case kBFloat16:
      return launch(__nv_bfloat16{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr double kGamma = 1.4;
// the reference's smoothing coefficient, 0.2f widened to double
constexpr double kSmoothing = 0.20000000298023223876953125;
constexpr int kThreads = 256;
// the kernels that give each of the five channels a thread of its own
// (shift_flux.cu's split rw, edge_csr.cu's wsum) take kChannelLanes rows
// or nodes a block, channel-major: threads [c * kChannelLanes,
// (c + 1) * kChannelLanes) are channel c, two whole warps, so a warp
// reads one channel of 32 neighbouring rows and the block's five channels
// of a row share the row's indices and weights through L1
constexpr int kChannelLanes = 64;
constexpr int kChannelThreads = 5 * kChannelLanes;
// levels below kThinBelow nodes (or rows) leave the card short of
// threads: there the per-channel kernels give each (node or row, channel)
// a thread. At fp64, levels of kFullLevel nodes (or rows) or more fill the
// card without more loads in flight per thread: there the unrolled span
// loop and the batched loads cost more in registers than they hide.
// Both chosen on the H100 from sweeps of the box flagship's levels
// (bench/kernel_ab.py --shapes).
constexpr int64_t kThinBelow = 16384;
constexpr int64_t kFullLevel = 131072;

// conserved channels plus the primitives the flux needs
template <typename T>
struct State8 {
  T rho, mx, my, mz, E, p, s, inv;  // s = speed + speed of sound
};

// complete one node's conserved channels with its primitives
template <typename T>
__device__ __forceinline__ State8<T> complete8(T rho, T mx, T my, T mz,
                                               T E) {
  State8<T> q;
  q.rho = rho;
  q.mx = mx;
  q.my = my;
  q.mz = mz;
  q.E = E;
  q.inv = T(1) / q.rho;
  const T vx = q.mx * q.inv, vy = q.my * q.inv, vz = q.mz * q.inv;
  const T speed_sqd = vx * vx + vy * vy + vz * vz;
  q.p = T(kGamma - 1.0) * (q.E - T(0.5) * q.rho * speed_sqd);
  q.s = sqrt(speed_sqd) + sqrt(T(kGamma) * q.p * q.inv);
  return q;
}

// node j of a stored (5, n) state, completed in the compute type
template <typename S>
__device__ __forceinline__ State8<compute_t<S>> complete8(
    const S* __restrict__ x, int64_t n, int64_t j) {
  return complete8<compute_t<S>>(
      to_compute(x[j]), to_compute(x[n + j]), to_compute(x[2 * n + j]),
      to_compute(x[3 * n + j]), to_compute(x[4 * n + j]));
}

// flux value into the owner o of one half-edge to n with signed normal
// (w0, w1, w2) and |w| = wt
template <typename T>
__device__ __forceinline__ void flux_math(const State8<T>& o,
                                          const State8<T>& n, T w0, T w1,
                                          T w2, T wt, T v[5]) {
  const T factor = wt * T(-0.5 * kSmoothing) * (o.s + n.s);
  const T wmo = w0 * o.mx + w1 * o.my + w2 * o.mz;
  const T wmn = w0 * n.mx + w1 * n.my + w2 * n.mz;
  const T wvo = wmo * o.inv;
  const T wvn = wmn * n.inv;
  const T psum = o.p + n.p;
  v[0] = factor * (o.rho - n.rho) - T(0.5) * (wmo + wmn);
  v[1] = factor * (o.mx - n.mx) -
         T(0.5) * (wvo * o.mx + wvn * n.mx + w0 * psum);
  v[2] = factor * (o.my - n.my) -
         T(0.5) * (wvo * o.my + wvn * n.my + w1 * psum);
  v[3] = factor * (o.mz - n.mz) -
         T(0.5) * (wvo * o.mz + wvn * n.mz + w2 * psum);
  v[4] = factor * (o.E - n.E) -
         T(0.5) * (wvo * (o.E + o.p) + wvn * (n.E + n.p));
}

// acc = sum over row i's half-edges of flux_math, in the compute type
// C; w is (4, n_half)
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ void flux_row(const int* __restrict__ row_ptr,
                                         const int* __restrict__ col,
                                         const S* __restrict__ w,
                                         int64_t n_half,
                                         const S* __restrict__ x, int64_t n,
                                         int64_t i, const State8<C>& qo,
                                         C acc[5]) {
  for (int c = 0; c < 5; ++c) acc[c] = C(0);
  const int end = row_ptr[i + 1];
  for (int h = row_ptr[i]; h < end; ++h) {
    const State8<C> qn = complete8(x, n, static_cast<int64_t>(col[h]));
    C v[5];
    flux_math(qo, qn, to_compute(w[h]), to_compute(w[n_half + h]),
              to_compute(w[2 * n_half + h]), to_compute(w[3 * n_half + h]),
              v);
    for (int c = 0; c < 5; ++c) acc[c] += v[c];
  }
}

// dense boundary + wall flux of node i from its completed state and the
// per-node aggregated normals nc (11, n): rows 0:3 the summed boundary
// normals, 3:6 the summed wall normals, 6:11 the far-field wall constant
// (flux_window.py::_bw_flux_ch :335, flux_shift.py::_bw_flux :357)
template <typename S, typename T = compute_t<S>>
__device__ __forceinline__ void bw_flux(const State8<T>& o,
                                        const S* __restrict__ nc, int64_t n,
                                        int64_t i, T r[5]) {
  T k[11];
  for (int r0 = 0; r0 < 11; ++r0) k[r0] = to_compute(nc[r0 * n + i]);
  const T vx = o.mx * o.inv, vy = o.my * o.inv, vz = o.mz * o.inv;
  const T bx = k[0], by = k[1], bz = k[2];
  const T hx = T(0.5) * k[3], hy = T(0.5) * k[4], hz = T(0.5) * k[5];
  const T de_p = o.E + o.p;
  r[0] = hx * o.mx + hy * o.my + hz * o.mz + k[6];
  r[1] = bx * o.p + hx * (vx * o.mx + o.p) + hy * (vx * o.my) +
         hz * (vx * o.mz) + k[7];
  r[2] = by * o.p + hx * (vy * o.mx) + hy * (vy * o.my + o.p) +
         hz * (vy * o.mz) + k[8];
  r[3] = bz * o.p + hx * (vz * o.mx) + hy * (vz * o.my) +
         hz * (vz * o.mz + o.p) + k[9];
  r[4] = hx * (vx * de_p) + hy * (vy * de_p) + hz * (vz * de_p) + k[10];
}

// validity of one updated value, in the compute type (before a bfloat16
// store rounds it, as the TPU kernel counts): NaN or Inf anywhere, and a
// negative density (channel 0) or energy (channel 4), count
// (validation.cpp:107-138)
template <typename T>
__device__ __forceinline__ int invalid_value(int c, T v) {
  return (isfinite(v) ? 0 : 1) + ((c == 0 || c == 4) && v < T(0) ? 1 : 0);
}

// add each thread's count to *total, an int64 the caller keeps across
// launches (the cycle's invalid count): a warp-shuffle and shared-memory
// sum per block, then one integer atomicAdd per block, so the total does
// not depend on the order of the blocks. Every thread of the block calls
// it.
__device__ __forceinline__ void add_block_count(
    int bad, long long* __restrict__ total) {
  for (int off = 16; off > 0; off >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  __shared__ int warp_bad[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_bad[threadIdx.x >> 5] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int k = 0; k < kThreads / 32; ++k) sum += warp_bad[k];
    if (sum)
      atomicAdd(reinterpret_cast<unsigned long long*>(total),
                static_cast<unsigned long long>(sum));
  }
}

// a - b and a + b rounded once to nearest even, never contracted with a
// neighbouring multiply into an FMA: the epilogues (window.cuh's
// update_node, edge_csr.cu's wsum stores) give the bits of the eager
// PyTorch ops they replace, which round each operation
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

inline unsigned blocks_for(int64_t rows, int per_block = kThreads) {
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

}  // namespace mgcfd
