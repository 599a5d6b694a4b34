// A row tile's walk of an owner-sorted CSR, staged in shared memory: the
// flux sums of the tiled CSR kernels that evaluate the flux entry by entry
// (fused_stage.cu's stage, edge_csr.cu's flux tile).
//
// A block owns consecutive rows and their contiguous entries, and walks
// the entries in chunks of E: each chunk's col and four weight rows are
// copied into shared memory by cp.async (window.cuh async_copy), col as E
// ints and the weights as (4, E + 2) stored values, bfloat16 weights as
// 4-byte pairs where every weight row starts on a 4-byte boundary.
#pragma once

#include "window.cuh"

namespace mgcfd {

// rows a tile: a block's first kTileRows threads own a row each
// (fused_stage.cu says why 128)
constexpr int kTileRows = 128;

// entries per chunk: 20,480 bytes of flux values. Half as many, with a
// block more per SM, made level 0 of the box flagship faster at fp32 on
// the H100 but its coarse levels, with fewer blocks than the card has
// room for, slower by more.
template <typename C>
__host__ __device__ constexpr int chunk_entries() {
  return 4096 / static_cast<int>(sizeof(C));
}

// weights of entry h of the chunk from c0 sit at sw[k * (E + 2) + h - c0 +
// wshift(c0)]: bfloat16 weights are copied as 4-byte pairs from the even
// entry at or below c0
template <typename S>
__device__ __forceinline__ int wshift(int c0) {
  return sizeof(S) == 2 ? (c0 & 1) : 0;
}

// the chunk [c0, c1) of col and w into shared memory, asynchronously
template <typename S>
__device__ __forceinline__ void stage_chunk(int* __restrict__ scol,
                                            S* __restrict__ sw,
                                            const int* __restrict__ col,
                                            const S* __restrict__ w,
                                            int64_t n_half, int E, int c0,
                                            int c1) {
  const int t = threadIdx.x;
  for (int h = c0 + t; h < c1; h += kThreads)
    async_copy(scol + h - c0, col + h);
  // bfloat16 pairs only where every weight row starts on a 4-byte boundary
  // (w aligned and n_half even, as an owner CSR of both half-edges makes
  // it): then no pair runs past the end of w either. Otherwise (a shard's
  // CSR may hold an odd count) entry by entry, with plain loads, to the
  // same places in shared memory.
  if constexpr (sizeof(S) == 2) {
    if (n_half % 2 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) {
      using P = __nv_bfloat162;
      const int p0 = c0 >> 1, p1 = (c1 + 1) >> 1;
      for (int p = p0 + t; p < p1; p += kThreads)
        for (int k = 0; k < 4; ++k)
          async_copy(reinterpret_cast<P*>(sw + k * (E + 2)) + p - p0,
                     reinterpret_cast<const P*>(w + k * n_half) + p);
    } else {
      const int s = wshift<S>(c0) - c0;
      for (int h = c0 + t; h < c1; h += kThreads)
        for (int k = 0; k < 4; ++k)
          async_copy(sw + k * (E + 2) + h + s, w + k * n_half + h);
    }
  } else {
    for (int h = c0 + t; h < c1; h += kThreads)
      for (int k = 0; k < 4; ++k)
        async_copy(sw + k * (E + 2) + h - c0, w + k * n_half + h);
  }
}

// node j of the neighbour space, completed, or with PRIM from its stored
// primitives
template <bool PRIM, typename S, typename C = compute_t<S>>
__device__ __forceinline__ State8<C> neighbour(const S* __restrict__ x,
                                               int64_t n, int64_t j,
                                               const C* __restrict__ prims) {
  if constexpr (PRIM)
    return complete8(x, n, j, prims);
  else
    return complete8(x, n, j);
}

// The flux sums of the tile of kTileRows rows from r0 of an owner-sorted
// CSR of n_rows rows, each row's entries added from zero in CSR order
// into its thread's acc (zero for a thread that owns no row). The block
// completes its own rows once into a shared window from x_own (n_rows
// columns) and walks their contiguous entries [row_ptr[r0], row_ptr[r1])
// in chunks of E: each chunk's col and weights staged by cp.async (the
// first chunk's while the window is completed), each row's entries marked
// with its row by its thread; then the block's threads evaluate the
// chunk's entries, entry c0 + x by thread x mod kThreads, into a shared
// (5, E) buffer, a neighbour among the tile's rows read from the window
// and any other completed from x_nbr (n_nbr columns); then each row's
// thread adds its entries, carrying its sums from chunk to chunk. A
// neighbour column at or past n_rows (the sharded solver's separator pool
// in flux mode) is never a tile row, so it is completed from x_nbr even
// where the last tile is short. On return the window, smem's first 8 B
// compute-type values, is written and visible to the whole block.
// With PRIM (the fused stage, where the neighbour space is the owners'
// own: x_own == x_nbr) every node's 1/rho and speed + speed of sound are
// gathered from its stored primitives prims (2, n_nbr; csr_common.cuh)
// instead of computed: the window's and each neighbour's, two more
// scattered loads per entry in place of a divide and two square roots.
template <typename S, bool PRIM = false>
__device__ __forceinline__ void tile_flux_sums(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const S* __restrict__ w, int64_t n_half, const S* __restrict__ x_own,
    int64_t n_rows, const S* __restrict__ x_nbr, int64_t n_nbr, int64_t r0,
    bool vec, unsigned char* smem, compute_t<S> acc[5],
    const compute_t<S>* __restrict__ prims = nullptr) {
  using C = compute_t<S>;
  constexpr int B = kTileRows;
  constexpr int E = chunk_entries<C>();
  C* sq = reinterpret_cast<C*>(smem);   // (8, B) window: the tile's rows
  C* sf = sq + 8 * B;                   // (5, E) flux values
  S* sw = reinterpret_cast<S*>(sf + 5 * E);        // (4, E + 2) weights
  int* scol = reinterpret_cast<int*>(sw + 4 * (E + 2));  // (E) neighbours
  unsigned char* srow = reinterpret_cast<unsigned char*>(scol + E);
  const int t = threadIdx.x;
  const int64_t i = r0 + t;
  const bool own = t < B && i < n_rows;
  const int64_t r1 = r0 + B < n_rows ? r0 + B : n_rows;
  const int64_t rows = r1 - r0;
  const int e0 = row_ptr[r0], e1 = row_ptr[r1];
  const int h0 = own ? row_ptr[i] : e1, h1 = own ? row_ptr[i + 1] : e1;
  stage_chunk(scol, sw, col, w, n_half, E, e0, e0 + E < e1 ? e0 + E : e1);
  complete_window<S, PRIM>(x_own, n_rows, r0, B, sq, B, 0, vec, prims);
  for (int c = 0; c < 5; ++c) acc[c] = C(0);
  for (int c0 = e0; c0 < e1; c0 += E) {
    const int c1 = c0 + E < e1 ? c0 + E : e1;
    if (c0 > e0) stage_chunk(scol, sw, col, w, n_half, E, c0, c1);
    const int a0 = h0 > c0 ? h0 : c0, a1 = h1 < c1 ? h1 : c1;
    for (int h = a0; h < a1; ++h)
      srow[h - c0] = static_cast<unsigned char>(t);
    async_wait_all();
    __syncthreads();  // the window, the chunk and its rows are written
    for (int x = t; x < c1 - c0; x += kThreads) {
      const int64_t j = scol[x];
      const int64_t pj = j - r0;
      const State8<C> qn =
          pj >= 0 && pj < rows ? get8(sq, B, static_cast<int>(pj))
                               : neighbour<PRIM>(x_nbr, n_nbr, j, prims);
      C v[5];
      const S* wx = sw + x + wshift<S>(c0);
      flux_math(get8(sq, B, srow[x]), qn, to_compute(wx[0]),
                to_compute(wx[E + 2]), to_compute(wx[2 * (E + 2)]),
                to_compute(wx[3 * (E + 2)]), v);
      for (int c = 0; c < 5; ++c) sf[c * E + x] = v[c];
    }
    __syncthreads();  // the chunk's values are written
    for (int h = a0; h < a1; ++h)
      for (int c = 0; c < 5; ++c) acc[c] += sf[c * E + h - c0];
    __syncthreads();  // the chunk's values, neighbours and rows are read
  }
  if (e0 == e1) __syncthreads();  // the window is written
}

// shared memory of a tile of B rows: the window, 8 B compute-type values;
// the chunk's flux values, 5 E; its weights, 4 (E + 2) stored values; its
// neighbours, E ints; its entries' rows, E bytes
template <typename S, int B>
__host__ __device__ constexpr size_t tile_shared_bytes() {
  using C = compute_t<S>;
  constexpr int E = chunk_entries<C>();
  return sizeof(C) * (8 * B + 5 * E) + sizeof(S) * 4 * (E + 2) +
         sizeof(int) * E + E;
}

}  // namespace mgcfd
