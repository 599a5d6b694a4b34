// shift_flux<T, RW>: the span-decomposed internal-edge flux of box-class
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
#include "shift_common.cuh"

namespace mgcfd {

template <typename T, bool RW>
__global__ void __launch_bounds__(kThreads)
    shift_flux_kernel(Spans sp, const T* __restrict__ w,
                      const T* __restrict__ q, T* __restrict__ out,
                      int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  T acc[5];
  span_sum<T, RW>(sp, w, q, n, i, complete8(q, n, i), acc);
  for (int c = 0; c < 5; ++c) out[c * n + i] = acc[c];
}

template <typename T>
int launch_shift(int64_t rw, const Spans& sp, const void* w, const void* q,
                 void* out, int64_t n, cudaStream_t stream) {
  const auto* wt = static_cast<const T*>(w);
  const auto* x = static_cast<const T*>(q);
  auto* o = static_cast<T*>(out);
  if (rw)
    shift_flux_kernel<T, true><<<blocks_for(n), kThreads, 0, stream>>>(
        sp, wt, x, o, n);
  else
    shift_flux_kernel<T, false><<<blocks_for(n), kThreads, 0, stream>>>(
        sp, wt, x, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success). deltas is a host
// array of num_deltas (<= 16) spans; w (num_deltas, 4, n), q and out
// (5, n) are device pointers.
extern "C" int mgcfd_shift_flux(int64_t is_double, int64_t rw,
                                const int64_t* deltas, int64_t num_deltas,
                                const void* w, const void* q, void* out,
                                int64_t n, void* stream) {
  mgcfd::Spans sp;
  if (mgcfd::make_spans(deltas, num_deltas, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? mgcfd::launch_shift<double>(rw, sp, w, q, out, n, s)
                   : mgcfd::launch_shift<float>(rw, sp, w, q, out, n, s);
}
