// shift_flux<S, RW, K>: the span-decomposed internal-edge flux of
// box-class meshes (or its indirect_rw twin), one node a thread, or in rw
// mode on thin levels one (node, channel) a thread.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_shift.py::_kernel
// (:152, launched at :232) in both of its modes:
//   flux  out[i] = sum over spans d of val_d(i) - val_d(i - d)
//   rw    the same accumulation of (q_a + q_b) + ((wx + wy) + wz), the
//         data-movement twin (_edge_val_rw :108)
// The TPU kernel's halo'd three-block windows, lane rolls and clamped
// index maps exist for Mosaic's aligned-lane rules; here each thread reads
// its own node and its two neighbours per span (shift_common.cuh).
//
// Bound on the H100 (3.35 TB/s, fp32 peak 67 TFLOP/s): bytes. Level 0 of
// the box flagship (304,640 nodes, spans 1, 4480 and 70) reads the state
// once, the (3, 4, n) weights once (3 rows a span in rw mode) and writes
// the output once: at fp32 23.2 MB in rw mode, 6.9 us, and 26.8 MB in
// flux mode, 8.0 us; half that at bfloat16. chip_smoke.py recomputes it
// from each run's tensors.
//
// What held the first port back (one thread per node, a runtime span
// loop): each thread issued its own state's 5 loads, then per span the
// 16 loads of two neighbours and two weight rows, and waited on each span
// before the next. The time followed the loads a thread had in flight,
// not the bytes: 8.8 us at bf16 against 9.1 at fp32. What this design does:
//   - The span loop is unrolled for plans of at most kMaxUnrolled spans
//     (every level of the flagship has 3), so that a thread issues the
//     loads of all its spans before it needs the first. At fp64 in rw mode
//     on full levels the unrolled loop's registers cost more blocks per SM
//     than its loads in flight gain, and the loop stays a loop.
//   - In rw mode the five channels do not depend on each other: a thin
//     level (kThinBelow nodes) gives each (node, channel) a thread, five
//     times the threads, each with a fifth of the state loads; the weights
//     are read by the five threads of a node, which sit in one block, so
//     L1 serves the repeats. On full levels the repeated weight loads cost
//     more than the threads gain.
//   - Tried and not kept (bench/kernel_ab.py --shapes on the H100; PERF.md
//     section 6): 4-, 8- and 16-byte vector loads of 2-8 consecutive
//     nodes a thread, the windows i +- d of a span that is no multiple of
//     the width shifted out of two aligned vectors in registers. Each
//     realigned window loads twice the bytes and the wider threads hold
//     more registers: slower at every width, dtype and level.
// The C entry point chooses the shape from the dtype, the mode, n and the
// span count (choose_shape below; kernels/shift.py launch_shape mirrors
// it). For each node the sums are the first port's, span by span in plan
// order: acc = (acc + val_d(i)) - val_d(i - d), each value rounded once on
// store. In rw mode every shape gives the same bits (additions only); in
// flux mode the unrolled loop lets nvcc contract other multiply-adds into
// FMAs than the loop did, a difference at the last bits (within
// chip_smoke.py's fp64 tolerance of 1e-12 against the plain version).
// At bfloat16 (the bf16 branch, flux_shift.py:163-201) the state and
// weights are widened exactly on load and the sums stay in float32 until
// the one rounded store.
#include "shift_common.cuh"

namespace mgcfd {

// thread i owns node i, all five channels
template <typename S, bool RW, int K>
__global__ void __launch_bounds__(kThreads)
    shift_flux_kernel(Spans sp, const S* __restrict__ w,
                      const S* __restrict__ q, S* __restrict__ out,
                      int64_t n) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  C acc[5];
  span_sum<S, RW, K>(sp, w, q, n, i, complete8(q, n, i), acc);
  for (int c = 0; c < 5; ++c) out[c * n + i] = to_storage<S>(acc[c]);
}

// channel c of node j, or of quiescent gas (rho = 1, momentum 0, E = 1)
// outside [0, n)
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ C channel_or_quiet(const S* __restrict__ qc,
                                              int c, int64_t n, int64_t j) {
  if (j >= 0 && j < n) return to_compute(qc[j]);
  return (c == 0 || c == 4) ? C(1) : C(0);
}

// (wx + wy) + wz of row j of span block wk, zero for j < 0
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ C rw_weight(const S* __restrict__ wk, int64_t n,
                                       int64_t j) {
  if (j < 0) return C(0);
  return (to_compute(wk[j]) + to_compute(wk[n + j])) +
         to_compute(wk[2 * n + j]);
}

// rw mode, one channel a thread: thread (c, r) of a block owns channel c
// of node r (the block layout of kChannelLanes, csr_common.cuh); per span
// val_d(i) = (q_i + q_{i+d}) + e_d(i) added, val_d(i - d) subtracted
template <typename S, int K>
__global__ void __launch_bounds__(kChannelThreads)
    shift_rw_split_kernel(Spans sp, const S* __restrict__ w,
                          const S* __restrict__ q, S* __restrict__ out,
                          int64_t n) {
  using C = compute_t<S>;
  const int c = threadIdx.x / kChannelLanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kChannelLanes +
                    threadIdx.x % kChannelLanes;
  if (i >= n) return;
  const S* qc = q + c * n;
  const C qi = to_compute(qc[i]);
  C acc = C(0);
  for_spans<K>(sp, [&](int64_t k) {
    const int64_t d = sp.d[k];
    const S* wk = w + k * 4 * n;
    acc += (qi + channel_or_quiet(qc, c, n, i + d)) + rw_weight(wk, n, i);
    acc -= (channel_or_quiet(qc, c, n, i - d) + qi) + rw_weight(wk, n, i - d);
  });
  out[c * n + i] = to_storage<S>(acc);
}

// the launch shape: in rw mode one channel a thread (split), and the span
// loop unrolled for plans of at most kMaxUnrolled spans (unroll)
struct Shape {
  int64_t split;
  int64_t unroll;
};

constexpr int kMaxUnrolled = 4;

// rw mode splits the channels on thin levels; the span loop is unrolled
// for short plans, but not for rw mode at fp64 on full levels
// (kThinBelow, kFullLevel: csr_common.cuh)
template <typename S>
inline Shape choose_shape(int64_t rw, int64_t n, int64_t spans) {
  const bool full64 = sizeof(S) == 8 && n >= kFullLevel;
  return Shape{rw != 0 && n < kThinBelow,
               spans <= kMaxUnrolled && !(rw != 0 && full64)};
}

template <typename S, int K>
void launch_k(int64_t rw, int64_t split, const Spans& sp, const S* w,
              const S* q, S* out, int64_t n, cudaStream_t stream) {
  if (split)
    shift_rw_split_kernel<S, K>
        <<<blocks_for(n, kChannelLanes), kChannelThreads, 0, stream>>>(
            sp, w, q, out, n);
  else if (rw)
    shift_flux_kernel<S, true, K>
        <<<blocks_for(n), kThreads, 0, stream>>>(sp, w, q, out, n);
  else
    shift_flux_kernel<S, false, K>
        <<<blocks_for(n), kThreads, 0, stream>>>(sp, w, q, out, n);
}

template <typename S>
int launch_shape(int64_t rw, Shape s, const Spans& sp, const void* w,
                 const void* q, void* out, int64_t n, cudaStream_t stream) {
  if (s.split && !rw) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wt = static_cast<const S*>(w);
  const auto* x = static_cast<const S*>(q);
  auto* o = static_cast<S*>(out);
  switch (s.unroll && sp.count <= kMaxUnrolled ? sp.count : 0) {
    case 1:
      launch_k<S, 1>(rw, s.split, sp, wt, x, o, n, stream);
      break;
    case 2:
      launch_k<S, 2>(rw, s.split, sp, wt, x, o, n, stream);
      break;
    case 3:
      launch_k<S, 3>(rw, s.split, sp, wt, x, o, n, stream);
      break;
    case 4:
      launch_k<S, 4>(rw, s.split, sp, wt, x, o, n, stream);
      break;
    default:
      launch_k<S, 0>(rw, s.split, sp, wt, x, o, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// The entry points return the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code, too many spans or a
// shape the mode does not take; they check the dtype code before they read
// any pointer. dtype: 0 float32, 1 float64, 2 bfloat16 (the storage type
// of w, q and out). deltas is a host array of num_deltas (<= 16) spans;
// w (num_deltas, 4, n), q and out (5, n) are device pointers.

namespace mgcfd {

// the kernel at shape s, or at the shape choose_shape picks when s is null
template <typename S>
int launch_entry(int64_t rw, const Shape* s, const int64_t* deltas,
                 int64_t num_deltas, const void* w, const void* q,
                 void* out, int64_t n, void* stream) {
  Spans sp;
  if (make_spans(deltas, num_deltas, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return launch_shape<S>(rw, s ? *s : choose_shape<S>(rw, n, sp.count), sp,
                         w, q, out, n, static_cast<cudaStream_t>(stream));
}

}  // namespace mgcfd

// the kernel at the shape choose_shape picks
extern "C" int mgcfd_shift_flux(int64_t dtype, int64_t rw,
                                const int64_t* deltas, int64_t num_deltas,
                                const void* w, const void* q, void* out,
                                int64_t n, void* stream) {
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    return mgcfd::launch_entry<decltype(tag)>(rw, nullptr, deltas,
                                              num_deltas, w, q, out, n,
                                              stream);
  });
}

// the kernel at a given shape (split: one channel a thread, rw mode only;
// unroll: the span loop unrolled). Only bench/kernel_ab.py --shapes calls
// it: the sweep that set choose_shape's thresholds times every shape of
// the library the solver loads, so it times the code the path runs, with
// no second build in a chip call.
extern "C" int mgcfd_shift_flux_at(int64_t dtype, int64_t rw, int64_t split,
                                   int64_t unroll, const int64_t* deltas,
                                   int64_t num_deltas, const void* w,
                                   const void* q, void* out, int64_t n,
                                   void* stream) {
  const mgcfd::Shape s{split, unroll};
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    return mgcfd::launch_entry<decltype(tag)>(rw, &s, deltas, num_deltas, w,
                                              q, out, n, stream);
  });
}

// the shape mgcfd_shift_flux launches at for n nodes and num_deltas spans,
// into shape[0] (split) and shape[1] (unroll); launches nothing
extern "C" int mgcfd_shift_flux_shape(int64_t dtype, int64_t rw, int64_t n,
                                      int64_t num_deltas, int64_t* shape) {
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    const mgcfd::Shape s =
        mgcfd::choose_shape<decltype(tag)>(rw, n, num_deltas);
    shape[0] = s.split;
    shape[1] = s.unroll;
    return 0;
  });
}
