// fused_stage<S>: one whole RK stage over an owner-sorted CSR, row tiles
// with shared node primitives and entry-parallel flux.
//
// Replaces the Pallas kernel
// mgcfd_tpu/pallas/flux_window.py::_window_fused_kernel (:359): per owner
// node it sums the internal-edge flux over its CSR row (edge_csr's flux
// mode), adds the dense boundary + wall flux from the per-node aggregated
// normals nc (11, n: rows 0:3 boundary, 3:6 wall, 6:11 the far-field wall
// constant; _bw_flux_ch :335), writes out = old + fac * flux and counts
// NaN, Inf, rho < 0 and E < 0 into total, an int64 the caller keeps
// across the visit's launches (the cycle's invalid count). The count is
// reduced per block (warp shuffles, then shared memory) and added with
// one integer atomicAdd per block, so it is deterministic. There is no
// spill operand: the CSR holds every half-edge.
// The epilogue: res, where it is not null, the residual out - old from
// the stored values, which the last RK stage writes in place of the
// solver's eager q - old.
//
// Bound on the H100 (3.35 TB/s): bytes. Level 0 of the box flagship at
// fp32 moves row_ptr and col (8.4 MB), the weights (4 x 1,800,656 half-
// edges, 28.8 MB), the state, old and out (18.3 MB), fac (1.2 MB) and nc
// (13.4 MB): about 70 MB, about 21 us; at bfloat16 about 39 MB, 12 us.
// chip_smoke.py recomputes it. One thread per row, as the kernel was first
// ported, completed the neighbour of every half-edge (5.9 completions per
// node at level 0, one division and two square roots each), and a warp's
// threads walked rows of different lengths, so each warp-wide load of col
// and w touched about six times the sectors it used.
//
// The design:
//   - Row tiles. A block of kThreads = 256 threads owns B = kTileRows =
//     128 consecutive rows [r0, r0 + B), one row each for the first B
//     threads. Their entries are the contiguous slice [row_ptr[r0],
//     row_ptr[r0 + B]) of col and w. Tiles of 128 rows rather than 256
//     double the blocks on the coarse levels, whose tiles do not fill the
//     card: on the H100 that took the box flagship's 'window' cycle from
//     267-269 to 220 us of this kernel at fp32 and from 203-204 to 170 at
//     bf16 (level 0: 44.9 against 47.3-47.6 us at fp32, 32.6 against
//     31.5-31.9 at bf16); tiles of 64 were slower.
//   - Shared node primitives. The block completes its own nodes [r0,
//     r0 + B) once into shared memory, with vector loads (window.cuh), and
//     a neighbour inside the tile is read from there; any other is
//     completed from device memory. On the box flagship's level 0 that
//     holds the neighbours at +-1 and most of those at +-70, and none at
//     +-4480. The window reaches no further than the tile (H = 0): wider
//     windows, which hold more neighbours, were measured no faster on the
//     H100 while this kernel was designed.
//   - Entry-parallel flux. The slice is walked in chunks of E entries
//     (E = 1024 at fp32 and bf16, 512 at fp64). Each chunk's col and w
//     are staged in shared memory by cp.async copies (the first chunk's
//     while the window is completed; bf16 weights as 4-byte pairs), and
//     every row's thread marks its entries with its row; then the block's
//     threads evaluate the flux values entry by entry, entry c0 + x by
//     thread x mod kThreads, into shared memory; then each row's thread
//     adds its entries in CSR order (the order of csr_common.cuh's
//     flux_row). This walk is csr_tile.cuh's tile_flux_sums, which
//     edge_csr.cu's flux tile runs too.
//     Fixed B with a loop over chunks, rather than tiles cut to an entry
//     cap on the host: no per-plan table to build, upload and keep in step
//     with the CSR, and a row of any length runs; a box tile's ~750
//     entries take one chunk at fp32 and bf16, two at fp64.
//   - Then each row's thread adds the boundary/wall flux, updates the
//     state and counts invalid values.
// What holds it back (bench/stage_ab.py on the H100, level 0, warm L2):
// it is slower than the one-thread-per-row kernel it replaced, and more
// on the coarse levels, whose few tiles leave most of the card idle while
// each block runs its phases (PERF.md). The completions it saves were
// cheap; each block runs its window, its chunks' staging, flux and sums
// as phases between barriers, so its memory latencies add up per block
// instead of overlapping across rows, and 4 blocks per SM (5 at bf16) do
// not hide them.
//
// Shared memory per block: the window, 8 B compute-type values, the
// chunk's flux values, 5 E, its weights, 4 (E + 2) stored values, its
// neighbours, E ints, and its entries' rows, E bytes: 46,112 bytes at
// fp32, 37,904 at bf16 and 47,680 at fp64, within the 48 KiB a launch
// gets without asking.
// Registers: __launch_bounds__ fits 4 blocks per SM at fp32 and fp64, 5
// at bf16 (window.cuh).
// At bfloat16 (the bf16 branch, :382-413) every operand but row_ptr and
// col is stored as bf16 and widened on load; the window, flux values, sums
// and old + fac * flux are float32, rounded once on store and counted
// before rounding.
#include "csr_tile.cuh"

namespace mgcfd {

template <typename S, bool RES>
__global__ void __launch_bounds__(kThreads, FusedMinBlocks<S>::value)
    fused_stage_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col, const S* __restrict__ w,
                       int64_t n_half, const S* __restrict__ q,
                       const S* __restrict__ old, const S* __restrict__ fac,
                       const S* __restrict__ nc, S* __restrict__ out,
                       S* __restrict__ res, long long* __restrict__ total,
                       int64_t n, bool vec) {
  using C = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t i = r0 + t;
  C acc[5];
  tile_flux_sums<S>(row_ptr, col, w, n_half, q, n, q, n, r0, vec, smem, acc);
  int bad = 0;
  if (t < kTileRows && i < n)
    bad = update_node<S, RES>(get8(reinterpret_cast<C*>(smem), kTileRows, t),
                              acc, nc, old, fac,
                              static_cast<const S*>(nullptr), n, i, out,
                              res, n, i);
  add_block_count(bad, total);
}

template <typename S>
int launch_fused(const void* row_ptr, const void* col, const void* w,
                 int64_t n_half, const void* q, const void* old,
                 const void* fac, const void* nc, void* out, void* res,
                 void* total, int64_t n, cudaStream_t stream) {
  constexpr size_t smem = tile_shared_bytes<S, kTileRows>();
  static_assert(smem <= 48 * 1024, "more shared memory than a launch gets");
  const int64_t blocks = (n + kTileRows - 1) / kTileRows;
  auto* kernel = res != nullptr ? fused_stage_kernel<S, true>
                                : fused_stage_kernel<S, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const S*>(w), n_half, static_cast<const S*>(q),
      static_cast<const S*>(old), static_cast<const S*>(fac),
      static_cast<const S*>(nc), static_cast<S*>(out), static_cast<S*>(res),
      static_cast<long long*>(total), n, rows_take_vectors<S>(q, n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code. dtype: 0 float32, 1
// float64, 2 bfloat16 (the storage type of w, q, old, fac, nc and out).
// q, old, out (5, n); fac (n); nc (11, n); w (4, n_half); res (5, n) or
// null; total: one int64 to which the kernel adds the count.
extern "C" int mgcfd_fused_stage(int64_t dtype, const void* row_ptr,
                                 const void* col, const void* w,
                                 int64_t n_half, const void* q,
                                 const void* old, const void* fac,
                                 const void* nc, void* out, void* res,
                                 void* total, int64_t n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    return mgcfd::launch_fused<S>(row_ptr, col, w, n_half, q, old, fac, nc,
                                  out, res, total, n, s);
  });
}
