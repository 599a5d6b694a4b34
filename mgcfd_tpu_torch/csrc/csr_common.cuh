// Device math shared by edge_csr.cu and fused_stage.cu: the per-half-edge
// Euler flux over an owner-sorted CSR, written from what the Pallas window
// kernels of mgcfd_tpu/pallas/flux_window.py compute (_complete8 :150,
// _flux_math :169, _bw_flux_ch :335), with the same operation order.
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

template <typename T>
__device__ __forceinline__ State8<T> complete8(const T* __restrict__ x,
                                               int64_t n, int64_t j) {
  State8<T> q;
  q.rho = x[j];
  q.mx = x[n + j];
  q.my = x[2 * n + j];
  q.mz = x[3 * n + j];
  q.E = x[4 * n + j];
  q.inv = T(1) / q.rho;
  const T vx = q.mx * q.inv, vy = q.my * q.inv, vz = q.mz * q.inv;
  const T speed_sqd = vx * vx + vy * vy + vz * vz;
  q.p = T(kGamma - 1.0) * (q.E - T(0.5) * q.rho * speed_sqd);
  q.s = sqrt(speed_sqd) + sqrt(T(kGamma) * q.p * q.inv);
  return q;
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

inline unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

}  // namespace mgcfd
