// shift_fused_stage<T>: one whole RK stage on a box-class mesh, one thread
// per node.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_shift.py::_fused_kernel
// (:380, launched at :484): per node the span-decomposed internal flux
// (shift_common.cuh), plus the dense boundary + wall flux from the
// aggregated normals nc (11, n) (_bw_flux :357), plus the caller's spill
// flux when there is one, then out = old + fac * flux, and the count of
// NaN, Inf, rho < 0 and E < 0 into one int32. The sums keep the TPU
// kernel's order: span by span (acc + val_a) - val_b, then + boundary/wall,
// then + spill. The count is reduced per block and added with one integer
// atomicAdd per block (csr_common.cuh), so it is deterministic. The TPU
// kernel also counts its pad lanes, which hold far-field gas and count 0;
// here there are none.
//
// Bound on the H100 (3.35 TB/s): bytes. Level 0 of the box flagship at
// fp32 moves shift_flux's ~27 MB plus old (6.1 MB), fac (1.2 MB) and nc
// (13.4 MB): about 48 MB, about 14 us. chip_smoke.py recomputes it.
// What the design does about it: one pass replaces the flux, boundary,
// time-step and validity passes (three extra state round trips); the
// state reads at i +- d are coalesced and hit the 50 MB L2.
#include "shift_common.cuh"

namespace mgcfd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shift_fused_stage_kernel(Spans sp, const T* __restrict__ w,
                             const T* __restrict__ q,
                             const T* __restrict__ old,
                             const T* __restrict__ fac,
                             const T* __restrict__ nc,
                             const T* __restrict__ spill,
                             T* __restrict__ out, int* __restrict__ invalid,
                             int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int bad = 0;
  if (i < n) {
    const State8<T> qi = complete8(q, n, i);
    T acc[5], bw[5];
    span_sum<T, false>(sp, w, q, n, i, qi, acc);
    bw_flux(qi, nc, n, i, bw);
    const T f = fac[i];
    for (int c = 0; c < 5; ++c) {
      T a = acc[c] + bw[c];
      if (spill != nullptr) a = a + spill[c * n + i];
      const T qn = old[c * n + i] + f * a;
      out[c * n + i] = qn;
      bad += invalid_value(c, qn);
    }
  }
  add_block_count(bad, invalid);
}

template <typename T>
int launch_shift_fused(const Spans& sp, const void* w, const void* q,
                       const void* old, const void* fac, const void* nc,
                       const void* spill, void* out, void* invalid,
                       int64_t n, cudaStream_t stream) {
  shift_fused_stage_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      sp, static_cast<const T*>(w), static_cast<const T*>(q),
      static_cast<const T*>(old), static_cast<const T*>(fac),
      static_cast<const T*>(nc), static_cast<const T*>(spill),
      static_cast<T*>(out), static_cast<int*>(invalid), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success). deltas is a host
// array of num_deltas (<= 16) spans; device pointers: w (num_deltas, 4,
// n), q, old, out (5, n), fac (n), nc (11, n), spill (5, n) or null, and
// invalid: one int32, zeroed by the caller, to which the kernel adds.
extern "C" int mgcfd_shift_fused_stage(int64_t is_double,
                                       const int64_t* deltas,
                                       int64_t num_deltas, const void* w,
                                       const void* q, const void* old,
                                       const void* fac, const void* nc,
                                       const void* spill, void* out,
                                       void* invalid, int64_t n,
                                       void* stream) {
  mgcfd::Spans sp;
  if (mgcfd::make_spans(deltas, num_deltas, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? mgcfd::launch_shift_fused<double>(sp, w, q, old, fac, nc,
                                                 spill, out, invalid, n, s)
             : mgcfd::launch_shift_fused<float>(sp, w, q, old, fac, nc,
                                                spill, out, invalid, n, s);
}
