// fused_stage<T>: one whole RK stage, one thread per node.
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
#include "csr_common.cuh"

namespace mgcfd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_stage_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col, const T* __restrict__ w,
                       int64_t n_half, const T* __restrict__ q,
                       const T* __restrict__ old, const T* __restrict__ fac,
                       const T* __restrict__ nc, T* __restrict__ out,
                       int* __restrict__ invalid, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int bad = 0;
  if (i < n) {
    const State8<T> qo = complete8(q, n, i);
    T acc[5], bw[5];
    flux_row(row_ptr, col, w, n_half, q, n, i, qo, acc);
    bw_flux(qo, nc, n, i, bw);
    const T f = fac[i];
    for (int c = 0; c < 5; ++c) {
      const T a = acc[c] + bw[c];
      const T qn = old[c * n + i] + f * a;
      out[c * n + i] = qn;
      bad += invalid_value(c, qn);
    }
  }
  add_block_count(bad, invalid);
}

template <typename T>
int launch_fused(const void* row_ptr, const void* col, const void* w,
                 int64_t n_half, const void* q, const void* old,
                 const void* fac, const void* nc, void* out, void* invalid,
                 int64_t n, cudaStream_t stream) {
  fused_stage_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const T*>(w), n_half, static_cast<const T*>(q),
      static_cast<const T*>(old), static_cast<const T*>(fac),
      static_cast<const T*>(nc), static_cast<T*>(out),
      static_cast<int*>(invalid), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success). q, old, out (5, n);
// fac (n); nc (11, n); w (4, n_half); invalid: one int32, zeroed by the
// caller, to which the kernel adds.
extern "C" int mgcfd_fused_stage(int64_t is_double, const void* row_ptr,
                                 const void* col, const void* w,
                                 int64_t n_half, const void* q,
                                 const void* old, const void* fac,
                                 const void* nc, void* out, void* invalid,
                                 int64_t n, void* stream) {
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? mgcfd::launch_fused<double>(row_ptr, col, w, n_half, q, old,
                                           fac, nc, out, invalid, n, s)
             : mgcfd::launch_fused<float>(row_ptr, col, w, n_half, q, old,
                                          fac, nc, out, invalid, n, s);
}
