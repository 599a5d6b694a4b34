// Device math shared by the kernels: the per-half-edge Euler flux over an
// owner-sorted CSR, the dense boundary + wall flux and the invalid-state
// count, written from what the Pallas kernels of mgcfd_tpu/pallas/
// (flux_window.py: _complete8 :150, _flux_math :169, _bw_flux_ch :335;
// flux_shift.py: _stage_channels :60, _edge_val_ch :80, _bw_flux :357)
// compute, with the same operation order.
// State arrays are variable-major (5, n): channel c of node j is x[c*n + j].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mgcfd {

constexpr double kGamma = 1.4;
// the reference's smoothing coefficient, 0.2f widened to double
constexpr double kSmoothing = 0.20000000298023223876953125;
constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ State8<T> complete8(const T* __restrict__ x,
                                               int64_t n, int64_t j) {
  return complete8(x[j], x[n + j], x[2 * n + j], x[3 * n + j],
                   x[4 * n + j]);
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

// acc = sum over row i's half-edges of flux_math; w is (4, n_half)
template <typename T>
__device__ __forceinline__ void flux_row(const int* __restrict__ row_ptr,
                                         const int* __restrict__ col,
                                         const T* __restrict__ w,
                                         int64_t n_half,
                                         const T* __restrict__ x, int64_t n,
                                         int64_t i, const State8<T>& qo,
                                         T acc[5]) {
  for (int c = 0; c < 5; ++c) acc[c] = T(0);
  const int end = row_ptr[i + 1];
  for (int h = row_ptr[i]; h < end; ++h) {
    const State8<T> qn = complete8(x, n, static_cast<int64_t>(col[h]));
    T v[5];
    flux_math(qo, qn, w[h], w[n_half + h], w[2 * n_half + h],
              w[3 * n_half + h], v);
    for (int c = 0; c < 5; ++c) acc[c] += v[c];
  }
}

// dense boundary + wall flux of node i from its completed state and the
// per-node aggregated normals nc (11, n): rows 0:3 the summed boundary
// normals, 3:6 the summed wall normals, 6:11 the far-field wall constant
// (flux_window.py::_bw_flux_ch :335, flux_shift.py::_bw_flux :357)
template <typename T>
__device__ __forceinline__ void bw_flux(const State8<T>& o,
                                        const T* __restrict__ nc, int64_t n,
                                        int64_t i, T r[5]) {
  const T vx = o.mx * o.inv, vy = o.my * o.inv, vz = o.mz * o.inv;
  const T bx = nc[i], by = nc[n + i], bz = nc[2 * n + i];
  const T hx = T(0.5) * nc[3 * n + i], hy = T(0.5) * nc[4 * n + i],
          hz = T(0.5) * nc[5 * n + i];
  const T de_p = o.E + o.p;
  r[0] = hx * o.mx + hy * o.my + hz * o.mz + nc[6 * n + i];
  r[1] = bx * o.p + hx * (vx * o.mx + o.p) + hy * (vx * o.my) +
         hz * (vx * o.mz) + nc[7 * n + i];
  r[2] = by * o.p + hx * (vy * o.mx) + hy * (vy * o.my + o.p) +
         hz * (vy * o.mz) + nc[8 * n + i];
  r[3] = bz * o.p + hx * (vz * o.mx) + hy * (vz * o.my) +
         hz * (vz * o.mz + o.p) + nc[9 * n + i];
  r[4] = hx * (vx * de_p) + hy * (vy * de_p) + hz * (vz * de_p) +
         nc[10 * n + i];
}

// validity of one updated value: NaN or Inf anywhere, and a negative
// density (channel 0) or energy (channel 4), count (validation.cpp:107-138)
template <typename T>
__device__ __forceinline__ int invalid_value(int c, T v) {
  return (isfinite(v) ? 0 : 1) + ((c == 0 || c == 4) && v < T(0) ? 1 : 0);
}

// add each thread's count to *invalid: a warp-shuffle and shared-memory
// sum per block, then one integer atomicAdd per block, so the total does
// not depend on the order of the blocks. Every thread of the block calls it.
__device__ __forceinline__ void add_block_count(int bad,
                                                int* __restrict__ invalid) {
  for (int off = 16; off > 0; off >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  __shared__ int warp_bad[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_bad[threadIdx.x >> 5] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += warp_bad[k];
    if (total) atomicAdd(invalid, total);
  }
}

inline unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

}  // namespace mgcfd
