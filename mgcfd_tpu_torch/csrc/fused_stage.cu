// fused_stage<S>: one whole RK stage, one thread per node.
//
// Replaces the Pallas kernel
// mgcfd_tpu/pallas/flux_window.py::_window_fused_kernel (:359): per owner
// node it sums the internal-edge flux over its CSR row (edge_csr's flux
// mode), adds the dense boundary + wall flux from the per-node aggregated
// normals nc (11, n: rows 0:3 boundary, 3:6 wall, 6:11 the far-field wall
// constant; _bw_flux_ch :335), writes out = old + fac * flux and counts
// NaN, Inf, rho < 0 and E < 0 into one int32. The count is reduced per
// block (warp shuffles, then shared memory) and added with one integer
// atomicAdd per block, so it is deterministic. There is no spill operand:
// the CSR holds every half-edge.
//
// Bound on the H100 (3.35 TB/s): bytes. Level 0 of the box flagship at
// fp32 moves the flux mode's ~49 MB plus old (6.1 MB), fac (1.2 MB) and nc
// (13.4 MB): about 70 MB, about 21 us. chip_smoke.py recomputes it.
// What the design does about it: one pass replaces the flux, boundary,
// time-step and validity passes (three extra state round trips); the state
// gathers hit the 50 MB L2.
// At bfloat16 (the bf16 branch, :382-413) every operand but row_ptr and
// col halves (about 39 MB); old + fac * flux is formed in float32 from the
// widened operands, rounded once on store, and counted before rounding.
#include "csr_common.cuh"

namespace mgcfd {

template <typename S>
__global__ void __launch_bounds__(kThreads)
    fused_stage_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col, const S* __restrict__ w,
                       int64_t n_half, const S* __restrict__ q,
                       const S* __restrict__ old, const S* __restrict__ fac,
                       const S* __restrict__ nc, S* __restrict__ out,
                       int* __restrict__ invalid, int64_t n) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int bad = 0;
  if (i < n) {
    const State8<C> qo = complete8(q, n, i);
    C acc[5], bw[5];
    flux_row(row_ptr, col, w, n_half, q, n, i, qo, acc);
    bw_flux(qo, nc, n, i, bw);
    const C f = to_compute(fac[i]);
    for (int c = 0; c < 5; ++c) {
      const C a = acc[c] + bw[c];
      const C qn = to_compute(old[c * n + i]) + f * a;
      out[c * n + i] = to_storage<S>(qn);
      bad += invalid_value(c, qn);
    }
  }
  add_block_count(bad, invalid);
}

template <typename S>
int launch_fused(const void* row_ptr, const void* col, const void* w,
                 int64_t n_half, const void* q, const void* old,
                 const void* fac, const void* nc, void* out, void* invalid,
                 int64_t n, cudaStream_t stream) {
  fused_stage_kernel<S><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const S*>(w), n_half, static_cast<const S*>(q),
      static_cast<const S*>(old), static_cast<const S*>(fac),
      static_cast<const S*>(nc), static_cast<S*>(out),
      static_cast<int*>(invalid), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code. dtype: 0 float32, 1
// float64, 2 bfloat16 (the storage type of w, q, old, fac, nc and out).
// q, old, out (5, n); fac (n); nc (11, n); w (4, n_half); invalid: one
// int32, zeroed by the caller, to which the kernel adds.
extern "C" int mgcfd_fused_stage(int64_t dtype, const void* row_ptr,
                                 const void* col, const void* w,
                                 int64_t n_half, const void* q,
                                 const void* old, const void* fac,
                                 const void* nc, void* out, void* invalid,
                                 int64_t n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    return mgcfd::launch_fused<S>(row_ptr, col, w, n_half, q, old, fac, nc,
                                  out, invalid, n, s);
  });
}
