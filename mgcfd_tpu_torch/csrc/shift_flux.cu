// shift_flux<S, RW>: the span-decomposed internal-edge flux of box-class
// meshes (or its indirect_rw twin), one thread per node.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_shift.py::_kernel
// (:152, launched at :232) in both of its modes:
//   flux  out[i] = sum over spans d of val_d(i) - val_d(i - d)
//   rw    the same accumulation of (q_a + q_b) + (wx + wy + wz), the
//         data-movement twin (_edge_val_rw :108)
// The TPU kernel's halo'd three-block windows, lane rolls and clamped
// index maps exist for Mosaic's aligned-lane rules; here each thread reads
// its own node and its two neighbours per span (shift_common.cuh).
//
// Bound on the H100 (3.35 TB/s, fp32 peak 67 TFLOP/s): bytes. Level 0 of
// the box flagship at fp32 (304,640 nodes, spans 1, 70 and 4480) reads the
// state (6.1 MB) and the (3, 4, n) weights (14.6 MB) and writes 6.1 MB:
// about 27 MB, about 8 us. chip_smoke.py recomputes it from each run.
// What the design does about it: a warp reads 32 consecutive nodes of each
// channel at i, i + d and i - d, so every state read is coalesced, and the
// 6 MB state stays in the 50 MB L2 across the three reads; weights stream
// once each from both endpoints' threads. Each edge value is computed
// twice (about 2 x 80 operations per edge), far below the card's rate.
// At bfloat16 (the bf16 branch, :163-201) the state and weights halve
// (about 13 MB); the span sums stay in float32 until the one rounded
// store.
#include "shift_common.cuh"

namespace mgcfd {

template <typename S, bool RW>
__global__ void __launch_bounds__(kThreads)
    shift_flux_kernel(Spans sp, const S* __restrict__ w,
                      const S* __restrict__ q, S* __restrict__ out,
                      int64_t n) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  C acc[5];
  span_sum<S, RW>(sp, w, q, n, i, complete8(q, n, i), acc);
  for (int c = 0; c < 5; ++c) out[c * n + i] = to_storage<S>(acc[c]);
}

template <typename S>
int launch_shift(int64_t rw, const Spans& sp, const void* w, const void* q,
                 void* out, int64_t n, cudaStream_t stream) {
  const auto* wt = static_cast<const S*>(w);
  const auto* x = static_cast<const S*>(q);
  auto* o = static_cast<S*>(out);
  if (rw)
    shift_flux_kernel<S, true><<<blocks_for(n), kThreads, 0, stream>>>(
        sp, wt, x, o, n);
  else
    shift_flux_kernel<S, false><<<blocks_for(n), kThreads, 0, stream>>>(
        sp, wt, x, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code or too many spans.
// dtype: 0 float32, 1 float64, 2 bfloat16 (the storage type of w, q and
// out). deltas is a host array of num_deltas (<= 16) spans; w (num_deltas,
// 4, n), q and out (5, n) are device pointers.
extern "C" int mgcfd_shift_flux(int64_t dtype, int64_t rw,
                                const int64_t* deltas, int64_t num_deltas,
                                const void* w, const void* q, void* out,
                                int64_t n, void* stream) {
  mgcfd::Spans sp;
  if (mgcfd::make_spans(deltas, num_deltas, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    return mgcfd::launch_shift<S>(rw, sp, w, q, out, n, s);
  });
}
