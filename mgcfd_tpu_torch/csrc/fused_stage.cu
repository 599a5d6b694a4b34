// fused_stage<S>: one whole RK stage over an owner-sorted CSR, row tiles
// with shared node primitives and entry-parallel flux.
//
// Replaces the Pallas kernel
// mgcfd_tpu/pallas/flux_window.py::_window_fused_kernel (:359): per owner
// node it sums the internal-edge flux over its CSR row (edge_csr's flux
// mode), adds the boundary + wall flux from the per-node aggregated
// normals (rows 0:3 boundary, 3:6 wall, 6:11 the far-field wall constant;
// _bw_flux_ch :335), writes out = old + fac * flux and counts
// NaN, Inf, rho < 0 and E < 0 into total, an int64 the caller keeps
// across the visit's launches (the cycle's invalid count). The count is
// reduced per block (warp shuffles, then shared memory) and added with
// one integer atomicAdd per block, so it is deterministic. There is no
// spill operand: the CSR holds every half-edge.
// The epilogue: res, where it is not null, the residual out - old from
// the stored values, which the last RK stage writes in place of the
// solver's eager q - old.
// The aggregated normals come compacted (csr_common.cuh BoundaryRows):
// only the nodes with a boundary or wall face, 8.7 % of level 0 of the
// M6 configurations and 10.5-13.2 % of their coarser levels, store their
// 11 values; every other node reads one bit of a mask word that 32 nodes
// share and takes zeros. The dense (11, n) operand, zeros nearly all of
// it, was a fifth of the kernel's bytes.
//
// Bound on the H100 (3.35 TB/s): bytes. Level 0 of the box flagship at
// fp32 moves row_ptr and col (8.4 MB), the weights (4 x 1,800,656 half-
// edges, 28.8 MB), the state, old and out (18.3 MB), fac (1.2 MB) and the
// boundary operand (26,384 stored rows, 1.16 MB, and the mask and ranks,
// 0.08 MB): about 58 MB, about 17 us; at bfloat16 about 33 MB, 10 us.
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
//   - Stored primitives. A node's completion (csr_common.cuh complete8)
//     is a divide (1/rho) and two square roots (|v| and the speed of
//     sound) around about 14 multiplies and adds, and it was repeated at
//     every entry that names the node from outside its tile: 5.9 times a
//     stage at the M6 configurations' level 0 (0.35 % of their entries
//     tile-local), about 11 on the tet's. Where the caller gives
//     prims_in, (2, n) rows of each node's 1/rho and speed + speed of
//     sound in the compute type, stored by the launch that wrote q (the
//     step factor's first pass, or the stage before; the solver's two
//     buffers a level alternate), the window and every neighbour load
//     those two values and rebuild the pressure from 1/rho with
//     multiplies and adds only. The stored values are complete8 of the
//     same stored channels, so the outputs keep their bits. Where it
//     gives prims_out, each row's thread stores its new state's, complete8
//     of the value it stored (the epilogue of the first two stages). The
//     operand is 8 B a node at fp32 and bf16, 16 at fp64, in each
//     direction: two more scattered 4-byte loads per entry (2 x 4 x
//     1,800,656 = 14.4 MB at level 0 of the box flagship, mostly from the
//     L2) and 2.4 MB stored. Those loads cost more than the completion
//     where a warp's neighbours scatter over many sectors, so the solver
//     gives the operand only to levels whose loads touch few, by a limit
//     for each dtype, or that are small (kernels/fused_stage.py
//     gathers_primitives: on the H100 M6's RCM levels 0 and 1 ran a
//     visit 5-8 % faster at fp32, its levels 2 and 3 2-8 % slower, the
//     tet's levels of 4,896 and 648 nodes 3-10 % faster). Given neither, the kernel completes every node as
//     before, and so do edge_csr.cu's flux tile and
//     shift_fused_stage.cu's windows, which are never given one.
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
// At bfloat16 (the bf16 branch, :382-413) every operand but the indices
// (row_ptr, col, mask and ranks) is stored as bf16 and widened on load;
// the window, flux values, sums and old + fac * flux are float32, rounded
// once on store and counted before rounding.
#include "csr_tile.cuh"

namespace mgcfd {

template <typename S, bool RES, bool GATHER, bool STORE>
__global__ void __launch_bounds__(kThreads, FusedMinBlocks<S>::value)
    fused_stage_kernel(const int* __restrict__ row_ptr,
                       const int* __restrict__ col, const S* __restrict__ w,
                       int64_t n_half, const S* __restrict__ q,
                       const S* __restrict__ old, const S* __restrict__ fac,
                       BoundaryRows<S> bnd, S* __restrict__ out,
                       S* __restrict__ res, long long* __restrict__ total,
                       const compute_t<S>* __restrict__ prims_in,
                       compute_t<S>* __restrict__ prims_out, int64_t n,
                       bool vec) {
  using C = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t i = r0 + t;
  const bool own = t < kTileRows && i < n;
  const BoundaryWord word = own ? boundary_word(bnd, i) : BoundaryWord{};
  C acc[5];
  tile_flux_sums<S, GATHER>(row_ptr, col, w, n_half, q, n, q, n, r0, vec,
                            smem, acc, prims_in);
  int bad = 0;
  if (own)
    bad = update_node<S, RES, STORE>(
        get8(reinterpret_cast<C*>(smem), kTileRows, t), acc, bnd, word, old,
        fac, static_cast<const S*>(nullptr), out, res, n, i, prims_out);
  add_block_count(bad, total);
}

// the kernel for the operands given: RES where res is, GATHER where
// prims_in is, STORE where prims_out is
template <typename S, bool RES, bool GATHER>
inline auto stage_kernel(const void* prims_out) {
  return prims_out != nullptr ? fused_stage_kernel<S, RES, GATHER, true>
                              : fused_stage_kernel<S, RES, GATHER, false>;
}

template <typename S, bool RES>
inline auto stage_kernel(const void* prims_in, const void* prims_out) {
  return prims_in != nullptr ? stage_kernel<S, RES, true>(prims_out)
                             : stage_kernel<S, RES, false>(prims_out);
}

template <typename S>
int launch_fused(const void* row_ptr, const void* col, const void* w,
                 int64_t n_half, const void* q, const void* old,
                 const void* fac, const BoundaryRows<S>& bnd, void* out,
                 void* res, void* total, const void* prims_in,
                 void* prims_out, int64_t n, cudaStream_t stream) {
  using C = compute_t<S>;
  constexpr size_t smem = tile_shared_bytes<S, kTileRows>();
  static_assert(smem <= 48 * 1024, "more shared memory than a launch gets");
  const int64_t blocks = (n + kTileRows - 1) / kTileRows;
  auto* kernel = res != nullptr ? stage_kernel<S, true>(prims_in, prims_out)
                                : stage_kernel<S, false>(prims_in, prims_out);
  // the window's vector loads take the primitives' rows too
  const bool vec = rows_take_vectors<S>(q, n) &&
                   reinterpret_cast<uintptr_t>(prims_in) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const S*>(w), n_half, static_cast<const S*>(q),
      static_cast<const S*>(old), static_cast<const S*>(fac), bnd,
      static_cast<S*>(out), static_cast<S*>(res),
      static_cast<long long*>(total), static_cast<const C*>(prims_in),
      static_cast<C*>(prims_out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code. dtype: 0 float32, 1
// float64, 2 bfloat16 (the storage type of w, q, old, fac, vals and out).
// q, old, out (5, n); fac (n); the boundary/wall operand (csr_common.cuh
// BoundaryRows): mask and rank (ceil(n / 32)) uint32 and int32, vals (11,
// stored); w (4, n_half); res (5, n) or null; total: one int64 to which
// the kernel adds the count; prims_in, prims_out (2, n) of the compute
// type (float32 at bfloat16), or null: q's stored primitives, gathered in
// place of completing each node, and out's, stored (csr_common.cuh).
extern "C" int mgcfd_fused_stage(int64_t dtype, const void* row_ptr,
                                 const void* col, const void* w,
                                 int64_t n_half, const void* q,
                                 const void* old, const void* fac,
                                 const void* mask, const void* rank,
                                 const void* vals, int64_t stored,
                                 void* out, void* res, void* total,
                                 const void* prims_in, void* prims_out,
                                 int64_t n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    const mgcfd::BoundaryRows<S> bnd{static_cast<const unsigned*>(mask),
                                     static_cast<const int*>(rank),
                                     static_cast<const S*>(vals), stored};
    return mgcfd::launch_fused<S>(row_ptr, col, w, n_half, q, old, fac, bnd,
                                  out, res, total, prims_in, prims_out, n,
                                  s);
  });
}
