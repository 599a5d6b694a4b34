// shift_fused_stage<S>: one whole RK stage on a box-class mesh, one thread
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
// At bfloat16 (the bf16 branch, :397-431) every operand halves (about
// 24 MB); old + fac * flux is formed in float32 from the widened old, fac,
// nc and spill, rounded once on store, and counted before rounding.
#include "shift_common.cuh"

namespace mgcfd {

template <typename S>
__global__ void __launch_bounds__(kThreads)
    shift_fused_stage_kernel(Spans sp, const S* __restrict__ w,
                             const S* __restrict__ q,
                             const S* __restrict__ old,
                             const S* __restrict__ fac,
                             const S* __restrict__ nc,
                             const S* __restrict__ spill,
                             S* __restrict__ out, int* __restrict__ invalid,
                             int64_t n) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int bad = 0;
  if (i < n) {
    const State8<C> qi = complete8(q, n, i);
    C acc[5], bw[5];
    span_sum<S, false>(sp, w, q, n, i, qi, acc);
    bw_flux(qi, nc, n, i, bw);
    const C f = to_compute(fac[i]);
    for (int c = 0; c < 5; ++c) {
      C a = acc[c] + bw[c];
      if (spill != nullptr) a = a + to_compute(spill[c * n + i]);
      const C qn = to_compute(old[c * n + i]) + f * a;
      out[c * n + i] = to_storage<S>(qn);
      bad += invalid_value(c, qn);
    }
  }
  add_block_count(bad, invalid);
}

template <typename S>
int launch_shift_fused(const Spans& sp, const void* w, const void* q,
                       const void* old, const void* fac, const void* nc,
                       const void* spill, void* out, void* invalid,
                       int64_t n, cudaStream_t stream) {
  shift_fused_stage_kernel<S><<<blocks_for(n), kThreads, 0, stream>>>(
      sp, static_cast<const S*>(w), static_cast<const S*>(q),
      static_cast<const S*>(old), static_cast<const S*>(fac),
      static_cast<const S*>(nc), static_cast<const S*>(spill),
      static_cast<S*>(out), static_cast<int*>(invalid), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code or too many spans.
// dtype: 0 float32, 1 float64, 2 bfloat16 (the storage type of every
// float operand). deltas is a host array of num_deltas (<= 16) spans;
// device pointers: w (num_deltas, 4, n), q, old, out (5, n), fac (n), nc
// (11, n), spill (5, n) or null, and invalid: one int32, zeroed by the
// caller, to which the kernel adds.
extern "C" int mgcfd_shift_fused_stage(int64_t dtype, const int64_t* deltas,
                                       int64_t num_deltas, const void* w,
                                       const void* q, const void* old,
                                       const void* fac, const void* nc,
                                       const void* spill, void* out,
                                       void* invalid, int64_t n,
                                       void* stream) {
  mgcfd::Spans sp;
  if (mgcfd::make_spans(deltas, num_deltas, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    return mgcfd::launch_shift_fused<S>(sp, w, q, old, fac, nc, spill, out,
                                        invalid, n, s);
  });
}
