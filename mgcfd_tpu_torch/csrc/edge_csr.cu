// edge_csr<S, Mode>: owner-sorted half-edge sums, one thread per owner row.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_window.py::_window_kernel
// (:222) in its three modes:
//   flux  acc[i] += flux(q_i, q_j, +-w, |w|)             (_flux_math :169)
//   rw    acc[i] += q_i + q_j + w0 + w1 + w2, per channel (_rw_math :193),
//         the indirect_rw data-movement twin
//   wsum  acc[i] += w0 * x[j], owner and neighbour spaces differ
//         (restriction: coarse <- fine; composed prolongation: fine <-
//         coarse)                                        (_wsum_math :202)
// The TPU kernel packs half-edges into (8, 128) tiles so that two
// single-vreg gathers can fetch neighbours; on the card a thread simply
// walks its row's CSR entries, so there is no packing, no spill list and
// no atomics: every sum is taken in one fixed order (deterministic).
//
// Bound on the H100 (3.35 TB/s, no matrix product): bytes. Level 0 of the
// box flagship at fp32 (304,640 rows, 1,800,656 half-edges) reads about
// 1.2 MB of row_ptr, 7.2 MB of col, 21.6-28.8 MB of weights and 6.1 MB of
// state and writes 6.1 MB: about 49 MB in flux mode, about 15 us.
// chip_smoke.py recomputes the bound from each run's tensors.
// What the design does about it: the 6 MB state stays in the 50 MB L2, so
// the neighbour gathers hit the cache; weights and indices are streamed
// once. Making it fast (a warp per row, vector loads) is later work.
// At bfloat16 (the bf16 branch, :254-296) the state and weights halve and
// row_ptr and col do not: about 29 MB in flux mode. Each row's sum stays
// in float32 until its one rounded store.
#include "csr_common.cuh"

namespace mgcfd {

enum Mode : int64_t { kFlux = 0, kRw = 1, kWsum = 2 };

template <typename S, int64_t MODE>
__global__ void __launch_bounds__(kThreads)
    edge_csr_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const S* __restrict__ w,
                    int64_t n_half, const S* __restrict__ x_own,
                    const S* __restrict__ x_nbr, int64_t n_nbr,
                    S* __restrict__ out, int64_t n_rows) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  C acc[5];
  if constexpr (MODE == kFlux) {
    const State8<C> qo = complete8(x_own, n_rows, i);
    flux_row(row_ptr, col, w, n_half, x_nbr, n_nbr, i, qo, acc);
  } else {
    C co[5];
    for (int c = 0; c < 5; ++c) {
      acc[c] = C(0);
      if constexpr (MODE == kRw) co[c] = to_compute(x_own[c * n_rows + i]);
    }
    const int end = row_ptr[i + 1];
    for (int h = row_ptr[i]; h < end; ++h) {
      const int64_t j = col[h];
      if constexpr (MODE == kRw) {
        const C w0 = to_compute(w[h]), w1 = to_compute(w[n_half + h]),
                w2 = to_compute(w[2 * n_half + h]);
        for (int c = 0; c < 5; ++c)
          acc[c] += co[c] + to_compute(x_nbr[c * n_nbr + j]) + w0 + w1 + w2;
      } else {
        const C wt = to_compute(w[h]);
        for (int c = 0; c < 5; ++c)
          acc[c] += wt * to_compute(x_nbr[c * n_nbr + j]);
      }
    }
  }
  for (int c = 0; c < 5; ++c) out[c * n_rows + i] = to_storage<S>(acc[c]);
}

template <typename S>
int launch(int64_t mode, const void* row_ptr, const void* col,
           const void* w, int64_t n_half, const void* x_own,
           const void* x_nbr, int64_t n_nbr, void* out, int64_t n_rows,
           cudaStream_t stream) {
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cl = static_cast<const int*>(col);
  const auto* wt = static_cast<const S*>(w);
  const auto* xo = static_cast<const S*>(x_own);
  const auto* xn = static_cast<const S*>(x_nbr);
  auto* o = static_cast<S*>(out);
  const unsigned blocks = blocks_for(n_rows);
  switch (mode) {
    case kFlux:
      edge_csr_kernel<S, kFlux><<<blocks, kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    case kRw:
      edge_csr_kernel<S, kRw><<<blocks, kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    case kWsum:
      edge_csr_kernel<S, kWsum><<<blocks, kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code or mode. dtype: 0
// float32, 1 float64, 2 bfloat16 (the storage type of w, x and out).
// Pointers are device pointers: row_ptr (n_rows + 1) int32, col (n_half)
// int32, w (K, n_half), x_own (5, n_rows) (unused in wsum mode), x_nbr
// (5, n_nbr), out (5, n_rows).
extern "C" int mgcfd_edge_csr(int64_t dtype, int64_t mode,
                              const void* row_ptr, const void* col,
                              const void* w, int64_t n_half,
                              const void* x_own, const void* x_nbr,
                              int64_t n_nbr, void* out, int64_t n_rows,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    return mgcfd::launch<S>(mode, row_ptr, col, w, n_half, x_own, x_nbr,
                            n_nbr, out, n_rows, s);
  });
}
