// edge_csr<S, Mode>: owner-sorted half-edge sums over a CSR.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_window.py::_window_kernel
// (:222, launched at :915) in its three modes:
//   flux  acc[i] += flux(q_i, q_j, +-w, |w|)             (_flux_math :169)
//   rw    acc[i] += q_i + q_j + w0 + w1 + w2, per channel (_rw_math :193),
//         the indirect_rw data-movement twin
//   wsum  acc[i] += w0 * x[j], owner and neighbour spaces differ
//         (restriction: coarse <- fine; composed prolongation: fine <-
//         coarse)                                        (_wsum_math :202)
// The TPU kernel packs half-edges into (8, 128) tiles so that two
// single-vreg gathers can fetch neighbours; on the card a thread simply
// walks its row's CSR entries, so there is no packing, no spill list and
// no atomics: every sum is taken in one fixed order, CSR order
// (deterministic).
//
// Bound on the H100 (3.35 TB/s, no matrix product): bytes. Level 0 of the
// box flagship at fp32 (304,640 rows, 1,800,656 half-edges) reads about
// 1.2 MB of row_ptr, 7.2 MB of col, 21.6-28.8 MB of weights and 6.1 MB of
// state and writes 6.1 MB: about 49 MB in flux mode, about 15 us. The
// wsum transfers move less: the restriction (38,080 coarse rows of 8
// fine children) 9.3 MB at fp32, 2.8 us, the composed prolongation
// (304,640 rows, 748,008 entries) 14.1 MB, 4.2 us. chip_smoke.py
// recomputes the bounds from each run's tensors.
// What the design does about it:
//   - flux mode: one thread per owner row (the row kernel); the 6 MB
//     state stays in the 50 MB L2, so the neighbour gathers hit the
//     cache; weights and indices are streamed once. It reaches 0.52-0.57
//     of its byte bound at level 0 of the box (6 entries a row, warm L2)
//     and 0.7 on its spill edges, and keeps the short rows. On the
//     tet flagship's level 0 (15 entries a row, RCM; 104.6 MB at fp32,
//     31.2 us) it took 273-286 us, for rw mode's reason below. The C
//     entry point now chooses a shape per CSR (choose_flux;
//     kernels/edge_csr.py flux_shape mirrors it, chip_smoke.py holds the
//     mirror to mgcfd_flux_shape): long rows take the tile
//     (flux_tile_kernel), fused_stage.cu's walk without its epilogue,
//     79 us there at fp32 (share 0.40; NVIDIA H100 80GB HBM3 at 700 W),
//     but the row kernel where it was as fast (levels of 16,384 to
//     65,535 rows at fp32 and bf16).
//   - rw mode: that row kernel too on the box's short rows (6 entries),
//     at 0.7 of its byte bound at fp32. On the tet flagship's level 0 (15
//     entries a row, RCM order; 86 MB at fp32, 25.8 us) it took 189-199
//     us: a warp's loads of col and w at step h touch 32 rows ~15 entries
//     apart, and the same rows cut to their first 6 entries take half the
//     time per entry (bench/kernel_ab.py's .first6 rows). The C entry
//     point now chooses a shape per CSR (choose_rw; kernels/edge_csr.py
//     rw_shape mirrors it, chip_smoke.py holds the mirror to
//     mgcfd_rw_shape): full levels of long rows take the tile
//     (rw_tile_kernel), 59 us there at fp32 (share 0.44); thin levels take
//     lane groups (rw_group_kernel), a warp's lanes on a row's consecutive
//     entries, which also beat the row kernel on the box's thin levels.
//     The tet's gathers stay uncoalesced in every shape (at 6 entries a
//     row the row kernel takes twice the box's time per entry), so the
//     tile stays at about half the byte bound's pace.
//   - wsum mode (wsum_row_kernel, wsum_split_kernel): a thread per row,
//     as first ported, waited on each entry's col, then its gathers, on
//     149 blocks for the level-0 restriction. The C entry point now
//     chooses a shape per CSR (choose_wsum below; kernels/edge_csr.py
//     wsum_shape mirrors it, and chip_smoke.py holds the mirror to
//     mgcfd_wsum_shape): rows of kChunk entries or more on average (the
//     restrictions, 8 fine children a row; the tet's prolongations) take a
//     thread per (row, channel), five times the threads, each reading its
//     row's col and w kChunk at a time as one int4 and one vector from the
//     row's first entry on a kChunk boundary (single loads before it and
//     after the last whole chunk), the five threads of a row sharing them
//     through L1 (kChannelLanes, csr_common.cuh); shorter rows (the box's
//     prolongations, at most 4) take batched loads, a chunk's col, w and
//     gathers all in flight before its sums, and a thread per (row,
//     channel) only on thin levels, where a thread per row leaves the
//     card idle. At fp64 on full levels the batch costs more registers
//     than it hides, and those rows keep the first port's loop. Chosen
//     from sweeps of every shape on the box flagship's and a 64^3 tet's
//     levels (bench/kernel_ab.py --shapes; PERF.md section 6).
//   - Each sum is taken in CSR order whatever the shape, so every shape
//     gives the first port's bits.
//   - wsum mode's epilogues (WsumTail), in the store of every shape: the
//     restriction stores the coarse state it is given (keep) on rows with
//     no entries, the coarse nodes that no fine node maps to, where the
//     solver took a torch.where of the mask; the prolongation stores the
//     fine state's update base + (res - sum) where the solver took two
//     eager ops. Each is rounded as those ops round, so the bits are
//     theirs; a null operand stores the sum.
// At bfloat16 (the bf16 branch, :254-296) the state and weights halve and
// row_ptr and col do not: about 29 MB in flux mode. Each sum stays in
// float32 until its one rounded store.
#include "csr_tile.cuh"

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
      co[c] = to_compute(x_own[c * n_rows + i]);
    }
    const int end = row_ptr[i + 1];
    for (int h = row_ptr[i]; h < end; ++h) {
      const int64_t j = col[h];
      const C w0 = to_compute(w[h]), w1 = to_compute(w[n_half + h]),
              w2 = to_compute(w[2 * n_half + h]);
      for (int c = 0; c < 5; ++c)
        acc[c] += co[c] + to_compute(x_nbr[c * n_nbr + j]) + w0 + w1 + w2;
    }
  }
  for (int c = 0; c < 5; ++c) out[c * n_rows + i] = to_storage<S>(acc[c]);
}

// rw mode on long rows. The row kernel above (kRwRow) gives each row a
// thread that walks its entries one after another, so at each step a
// warp's loads of col and w touch 32 rows' entries, one sector each.
// The two shapes below read each row's entries with neighbouring lanes
// on neighbouring entries instead, and still add each row's values in
// CSR order from zero, so every shape gives the row kernel's bits.

// the value entry (q_i, q_j, w0, w1, w2) adds to its row in channel c:
// (((q_i + q_j) + w0) + w1) + w2, as the row kernel's sum parses
template <typename C>
__device__ __forceinline__ C rw_value(C qi, C qj, C w0, C w1, C w2) {
  return qi + qj + w0 + w1 + w2;
}

// kRwTile: a block owns kThreads consecutive rows, one a thread, and
// walks their contiguous entries [row_ptr[r0], row_ptr[r0 + kThreads]) in
// chunks of E. Per chunk: each row's thread marks its entries with its
// row; the block's threads take the chunk's entries c0 + t, c0 + t +
// kThreads, ... (coalesced col and w loads, all of a thread's loads and
// gathers issued before its values), add each to its row's own values,
// staged once in shared memory, and store the five values; then each
// row's thread adds its entries in CSR order, carrying its sums from chunk
// to chunk. Two barriers a chunk.
template <typename S>
__global__ void __launch_bounds__(kThreads)
    rw_tile_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col, const S* __restrict__ w,
                   int64_t n_half, const S* __restrict__ x_own,
                   const S* __restrict__ x_nbr, int64_t n_nbr,
                   S* __restrict__ out, int64_t n_rows) {
  using C = compute_t<S>;
  constexpr int B = kThreads;
  // entries a tile stages per chunk (csr_tile.cuh): 1024 at fp32 and
  // bf16 (four a thread), 512 at fp64 (two a thread)
  constexpr int E = chunk_entries<C>();
  constexpr int K = E / kThreads;
  __shared__ C sq[5 * B];            // the tile's own rows, channel-major
  __shared__ C sv[5 * E];            // the chunk's values, channel-major
  __shared__ unsigned char srow[E];  // each entry's row in the tile
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * B;
  const int64_t i = r0 + t;
  const bool own = i < n_rows;
  const int64_t r1 = r0 + B < n_rows ? r0 + B : n_rows;
  const int e0 = row_ptr[r0], e1 = row_ptr[r1];
  const int h0 = own ? row_ptr[i] : e1, h1 = own ? row_ptr[i + 1] : e1;
  for (int c = 0; c < 5; ++c)
    sq[c * B + t] = own ? to_compute(x_own[c * n_rows + i]) : C(0);
  C acc[5];
  for (int c = 0; c < 5; ++c) acc[c] = C(0);
  for (int c0 = e0; c0 < e1; c0 += E) {
    const int c1 = c0 + E < e1 ? c0 + E : e1;
    const int a0 = h0 > c0 ? h0 : c0, a1 = h1 < c1 ? h1 : c1;
    for (int h = a0; h < a1; ++h)
      srow[h - c0] = static_cast<unsigned char>(t);
    __syncthreads();  // rows marked, the tile staged, the last chunk read
    int64_t j[K];
    C w0[K], w1[K], w2[K], xj[K][5];
    for (int k = 0; k < K; ++k) {
      const int h = c0 + t + k * kThreads;
      const bool in = h < c1;
      j[k] = in ? col[h] : 0;
      w0[k] = in ? to_compute(w[h]) : C(0);
      w1[k] = in ? to_compute(w[n_half + h]) : C(0);
      w2[k] = in ? to_compute(w[2 * n_half + h]) : C(0);
    }
    for (int k = 0; k < K; ++k)
      for (int c = 0; c < 5; ++c)
        xj[k][c] = c0 + t + k * kThreads < c1
                       ? to_compute(x_nbr[c * n_nbr + j[k]])
                       : C(0);
    for (int k = 0; k < K; ++k) {
      const int e = t + k * kThreads;
      if (c0 + e < c1) {
        const int r = srow[e];
        for (int c = 0; c < 5; ++c)
          sv[c * E + e] =
              rw_value(sq[c * B + r], xj[k][c], w0[k], w1[k], w2[k]);
      }
    }
    __syncthreads();  // the chunk's values are written
    for (int h = a0; h < a1; ++h)
      for (int c = 0; c < 5; ++c) acc[c] += sv[c * E + h - c0];
  }
  if (own)
    for (int c = 0; c < 5; ++c) out[c * n_rows + i] = to_storage<S>(acc[c]);
}

// kRwGroup*: G lanes of a warp share a row and take its entries P = G * K
// at a time, lane g entries base + g, base + G + g, ...: neighbouring
// lanes on neighbouring entries. Each lane stores its entries' values in
// its warp's slice of shared memory; after __syncwarp, lane g < 5 of the
// group adds channel g's P values in CSR order into its sum. Every lane of
// a warp makes as many passes as the warp's longest row needs, so all
// meet at each __syncwarp. No block barrier.
template <typename S, int G, int K>
__global__ void __launch_bounds__(kThreads)
    rw_group_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const S* __restrict__ w,
                    int64_t n_half, const S* __restrict__ x_own,
                    const S* __restrict__ x_nbr, int64_t n_nbr,
                    S* __restrict__ out, int64_t n_rows) {
  using C = compute_t<S>;
  static_assert(G >= 5 && 32 % G == 0, "a group adds its five channels");
  constexpr int P = G * K;          // entries a group takes per pass
  constexpr int R = 32 / G;         // rows a warp
  // a channel's slots in a warp's slice: each group's P, padded by one,
  // so that the 5 R folding lanes of a warp read 5 R different banks
  constexpr int L = R * (P + 1);
  __shared__ C sv[kThreads / 32][5 * L];
  const int lane = threadIdx.x & 31, g = lane % G, gi = lane / G;
  C* v = sv[threadIdx.x >> 5];
  const int64_t wr0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane) / G;
  const int64_t i = wr0 + gi;
  int passes = 0;
  for (int r = 0; r < R; ++r)
    if (wr0 + r < n_rows) {
      const int len = row_ptr[wr0 + r + 1] - row_ptr[wr0 + r];
      const int p = (len + P - 1) / P;
      passes = p > passes ? p : passes;
    }
  const bool own = i < n_rows;
  const int hs = own ? row_ptr[i] : 0, he = own ? row_ptr[i + 1] : 0;
  C co[5];
  for (int c = 0; c < 5; ++c)
    co[c] = own ? to_compute(x_own[c * n_rows + i]) : C(0);
  C acc = C(0);  // channel g of row i, in lanes g < 5
  for (int p = 0; p < passes; ++p) {
    const int base = hs + p * P;
    int64_t j[K];
    C w0[K], w1[K], w2[K], xj[K][5];
    for (int k = 0; k < K; ++k) {
      const int h = base + k * G + g;
      const bool in = h < he;
      j[k] = in ? col[h] : 0;
      w0[k] = in ? to_compute(w[h]) : C(0);
      w1[k] = in ? to_compute(w[n_half + h]) : C(0);
      w2[k] = in ? to_compute(w[2 * n_half + h]) : C(0);
    }
    for (int k = 0; k < K; ++k)
      for (int c = 0; c < 5; ++c)
        xj[k][c] = base + k * G + g < he
                       ? to_compute(x_nbr[c * n_nbr + j[k]])
                       : C(0);
    for (int k = 0; k < K; ++k)
      if (base + k * G + g < he)
        for (int c = 0; c < 5; ++c)
          v[c * L + gi * (P + 1) + k * G + g] =
              rw_value(co[c], xj[k][c], w0[k], w1[k], w2[k]);
    __syncwarp();  // the pass's values are written
    if (g < 5) {
      const int cnt = he - base < P ? he - base : P;
      for (int s = 0; s < cnt; ++s) acc += v[g * L + gi * (P + 1) + s];
    }
    __syncwarp();  // the pass's values are read
  }
  if (own && g < 5) out[g * n_rows + i] = to_storage<S>(acc);
}

// the rw launch shapes: the row kernel, the tile, and lane groups of 8
// lanes (one entry a lane per pass, or two). Groups of 16 lanes, tiles
// with half the chunk and groups whose block walks 256 rows lost to these
// on every level but the tet's coarsest (PERF.md section 6)
enum RwShape : int64_t { kRwRow = 0, kRwTile = 1, kRwGroup8 = 2,
                         kRwGroup8x2 = 3 };
// rows of kRwLongRow entries or more on average are long (the tet's, 9-15
// a row on its levels; the box's are 4-6)
constexpr int64_t kRwLongRow = 10;

// the rw shape for n_rows rows of n_half entries at storage type S. Thin
// levels (below kThinBelow rows) leave the row kernel short of threads:
// lane groups, two entries a lane on long rows. Full levels (kFullLevel
// rows or more) of long rows take the tile, and so do full levels at fp64,
// where the tile beat the row kernel on the box too (37.4-37.8 against
// 40.9-41.0 us). Between the two (38,080 rows on both flagships) and on full levels
// of short rows at fp32 and bf16 the row kernel was the fastest. From
// sweeps of every shape on both flagships' levels and a 64^3 tet's
// (bench/kernel_ab.py --shapes; PERF.md section 6).
template <typename S>
inline int64_t choose_rw(int64_t n_rows, int64_t n_half) {
  const bool long_rows = n_half >= kRwLongRow * n_rows;
  if (n_rows < kThinBelow) return long_rows ? kRwGroup8x2 : kRwGroup8;
  if (n_rows >= kFullLevel && (long_rows || sizeof(S) == 8)) return kRwTile;
  return kRwRow;
}

template <typename S>
int launch_rw(int64_t shape, const int* rp, const int* cl, const S* wt,
              int64_t n_half, const S* xo, const S* xn, int64_t n_nbr,
              S* o, int64_t n_rows, cudaStream_t stream) {
  switch (shape) {
    case kRwRow:
      edge_csr_kernel<S, kRw><<<blocks_for(n_rows), kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    case kRwTile:
      rw_tile_kernel<S><<<blocks_for(n_rows), kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    case kRwGroup8:
      rw_group_kernel<S, 8, 1>
          <<<blocks_for(n_rows, kThreads / 8), kThreads, 0, stream>>>(
              rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    case kRwGroup8x2:
      rw_group_kernel<S, 8, 2>
          <<<blocks_for(n_rows, kThreads / 8), kThreads, 0, stream>>>(
              rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// flux mode on long rows. The row kernel (kFluxRow: edge_csr_kernel in
// flux mode, csr_common.cuh flux_row) gives each row a thread that walks
// its entries one after another: on the tet's ~15-entry rows a warp's
// loads of col and of the four weight rows at step h touch 32 rows ~15
// entries apart, a sector each, as rw mode's row kernel did. The tile
// below is fused_stage.cu's walk without the stage's epilogue: it still
// evaluates each entry's flux_math on the row kernel's values and adds
// each row's values in CSR order from zero, so it gives the row kernel's
// bits.

// kFluxTile: a block of kThreads threads owns B = kTileRows = 128
// consecutive rows, one each for its first B threads, completes them once
// into a shared window from x_own, where the row kernel takes each owner,
// and walks their entries as fused_stage_kernel does (csr_tile.cuh
// tile_flux_sums); then each row's thread stores its sums. Tiles of 256
// rows, a row a thread, were slower on every level of both tets at every
// dtype (PERF.md section 6).
template <typename S>
__global__ void __launch_bounds__(kThreads, FusedMinBlocks<S>::value)
    flux_tile_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col, const S* __restrict__ w,
                     int64_t n_half, const S* __restrict__ x_own,
                     const S* __restrict__ x_nbr, int64_t n_nbr,
                     S* __restrict__ out, int64_t n_rows, bool vec) {
  using C = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t i = r0 + t;
  C acc[5];
  tile_flux_sums<S>(row_ptr, col, w, n_half, x_own, n_rows, x_nbr, n_nbr,
                    r0, vec, smem, acc);
  if (t < kTileRows && i < n_rows)
    for (int c = 0; c < 5; ++c) out[c * n_rows + i] = to_storage<S>(acc[c]);
}

// the flux launch shapes: the row kernel and the tile
enum FluxShape : int64_t { kFluxRow = 0, kFluxTile = 1 };
// levels from kThinBelow up to kFluxMidLevel rows of long rows take the
// row kernel at fp32 and bf16
constexpr int64_t kFluxMidLevel = 65536;

// the flux shape for n_rows rows of n_half entries at storage type S.
// Long rows (kRwLongRow entries or more on average, the tet's) take the
// tile, 3.5x faster than the row kernel at level 0 of the tet flagship
// (NVIDIA H100 80GB HBM3 at 700 W) and faster on its thin levels too;
// but on levels of kThinBelow to kFluxMidLevel rows (the tets' level 1:
// 38,080 and 32,768 rows) the row kernel was as fast or faster at fp32
// and bf16, and the tile faster from 76,160 rows (shard 0 of 4 of the tet
// flagship's level 0). Short rows (the box's, and its spill edges) take
// the row kernel, faster on every level. From sweeps of both shapes on the box flagship's levels, two
// tets' and the sharded level 0's (bench/kernel_ab.py --shapes,
// chip_smoke.py; PERF.md section 6).
template <typename S>
inline int64_t choose_flux(int64_t n_rows, int64_t n_half) {
  if (n_half < kRwLongRow * n_rows) return kFluxRow;
  const bool mid = n_rows >= kThinBelow && n_rows < kFluxMidLevel;
  return mid && sizeof(S) != 8 ? kFluxRow : kFluxTile;
}

template <typename S>
int launch_flux(int64_t shape, const int* rp, const int* cl, const S* wt,
                int64_t n_half, const S* xo, const S* xn, int64_t n_nbr,
                S* o, int64_t n_rows, cudaStream_t stream) {
  switch (shape) {
    case kFluxRow:
      edge_csr_kernel<S, kFlux><<<blocks_for(n_rows), kThreads, 0, stream>>>(
          rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows);
      return static_cast<int>(cudaGetLastError());
    case kFluxTile: {
      constexpr size_t smem = tile_shared_bytes<S, kTileRows>();
      static_assert(smem <= 48 * 1024, "more shared memory than a launch "
                    "gets");
      flux_tile_kernel<S>
          <<<blocks_for(n_rows, kTileRows), kThreads, smem, stream>>>(
              rp, cl, wt, n_half, xo, xn, n_nbr, o, n_rows,
              rows_take_vectors<S>(xo, n_rows));
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a vector of NW 32-bit words: its load type, and its words
template <int NW>
struct Words;
template <>
struct Words<2> {
  using type = uint2;
  __device__ static void split(const type& v, unsigned o[2]) {
    o[0] = v.x;
    o[1] = v.y;
  }
};
template <>
struct Words<4> {
  using type = uint4;
  __device__ static void split(const type& v, unsigned o[4]) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

// element e of a vector of S held as 32-bit words, in the compute type
// (exact)
template <typename S>
struct Bits;
template <>
struct Bits<float> {
  __device__ static float get(const unsigned* t, int e) {
    return __uint_as_float(t[e]);
  }
};
template <>
struct Bits<double> {
  __device__ static double get(const unsigned* t, int e) {
    return __hiloint2double(static_cast<int>(t[2 * e + 1]),
                            static_cast<int>(t[2 * e]));
  }
};
template <>
struct Bits<__nv_bfloat16> {
  __device__ static float get(const unsigned* t, int e) {
    const unsigned w = t[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// K consecutive values at p, aligned to K * sizeof(S) bytes (8 to 32), in
// the compute type: one load of up to 16 bytes, or two
template <typename S, int K, typename C = compute_t<S>>
__device__ __forceinline__ void load_aligned(const S* __restrict__ p,
                                             C out[K]) {
  constexpr int NW = K * static_cast<int>(sizeof(S)) / 4;
  constexpr int PER = NW > 4 ? 4 : NW;
  unsigned t[NW];
  for (int k = 0; k < NW; k += PER)
    Words<PER>::split(*reinterpret_cast<const typename Words<PER>::type*>(
                          reinterpret_cast<const unsigned*>(p) + k),
                      t + k);
  for (int e = 0; e < K; ++e) out[e] = Bits<S>::get(t, e);
}

// wsum mode: how a thread loads its row's entries. kPlainLoads one by
// one; kChunkedLoads kChunk at a time, col as one int4 and w as one
// vector, where the arrays are aligned: one by one up to the row's first
// entry on a chunk boundary, then whole chunks, then one by one to the
// row's end, so that rows of any start and length take chunks;
// kBatchedLoads kChunk at a time, the chunk's col, w and x loads (guarded
// at the row's end) all issued before its sums. Each sum is taken in CSR
// order whatever the loads.
enum WsumLoads : int64_t { kPlainLoads = 0, kChunkedLoads = 1,
                           kBatchedLoads = 2 };
constexpr int kChunk = 4;

// acc[c] += w[h] * x[c0 + c, col[h]] for one entry h
template <typename S, int NC, typename C = compute_t<S>>
__device__ __forceinline__ void wsum_entry(const int* __restrict__ col,
                                           const S* __restrict__ w,
                                           const S* __restrict__ x,
                                           int64_t n_nbr, int h, int c0,
                                           C acc[NC]) {
  const int64_t j = col[h];
  const C wt = to_compute(w[h]);
  for (int c = 0; c < NC; ++c)
    acc[c] += wt * to_compute(x[(c0 + c) * n_nbr + j]);
}

// acc[c] = the weighted sum of channels c0 .. c0 + NC - 1 of row i over
// its entries in CSR order: acc += w[h] * x[col[h]]
template <typename S, int NC, int64_t LOADS, typename C = compute_t<S>>
__device__ __forceinline__ void wsum_row(const int* __restrict__ row_ptr,
                                         const int* __restrict__ col,
                                         const S* __restrict__ w,
                                         const S* __restrict__ x,
                                         int64_t n_nbr, int64_t i, int c0,
                                         bool aligned, C acc[NC]) {
  for (int c = 0; c < NC; ++c) acc[c] = C(0);
  int h = row_ptr[i];
  const int end = row_ptr[i + 1];
  if constexpr (LOADS == kBatchedLoads) {
    for (; h < end; h += kChunk) {
      int64_t j[kChunk];
      C wt[kChunk], xv[kChunk][NC];
      for (int k = 0; k < kChunk; ++k) {
        j[k] = h + k < end ? col[h + k] : 0;
        wt[k] = h + k < end ? to_compute(w[h + k]) : C(0);
      }
      for (int k = 0; k < kChunk; ++k)
        for (int c = 0; c < NC; ++c)
          xv[k][c] = h + k < end ? to_compute(x[(c0 + c) * n_nbr + j[k]])
                                 : C(0);
      for (int k = 0; k < kChunk; ++k)
        if (h + k < end)
          for (int c = 0; c < NC; ++c) acc[c] += wt[k] * xv[k][c];
    }
    return;
  }
  if (LOADS == kChunkedLoads && aligned) {
    for (; h < end && h % kChunk != 0; ++h)
      wsum_entry<S, NC>(col, w, x, n_nbr, h, c0, acc);
    for (; h + kChunk <= end; h += kChunk) {
      const int4 j4 = *reinterpret_cast<const int4*>(col + h);
      const int64_t j[kChunk] = {j4.x, j4.y, j4.z, j4.w};
      C wt[kChunk];
      load_aligned<S, kChunk>(w + h, wt);
      for (int k = 0; k < kChunk; ++k)
        for (int c = 0; c < NC; ++c)
          acc[c] += wt[k] * to_compute(x[(c0 + c) * n_nbr + j[k]]);
    }
  }
  for (; h < end; ++h) wsum_entry<S, NC>(col, w, x, n_nbr, h, c0, acc);
}

// wsum mode's epilogues, (5, n_rows) operands like out, each null or not:
// keep, the value a row with no entries stores (the restriction's coarse
// state); base and res together, out = base + (res - sum) (the
// prolongation: the fine state and its residual). Neither: out = sum.
// The kernels take which one as a template argument (WsumTailKind), so
// that a launch without one runs the store as it was before them.
template <typename S>
struct WsumTail {
  const S* keep;
  const S* base;
  const S* res;
};
enum WsumTailKind : int { kSumOnly = 0, kKeepEmpty = 1, kCorrect = 2 };

// whether row i stores keep's values and nothing else: with kKeepEmpty,
// where it has no entries (tested before the row's sum, so that nothing
// of the test stays live through it)
template <typename S, int TAIL>
__device__ __forceinline__ bool wsum_keeps(const int* __restrict__ row_ptr,
                                           int64_t i) {
  if constexpr (TAIL == kKeepEmpty) return row_ptr[i] == row_ptr[i + 1];
  return false;
}

// the store of element k of a row's sum acc: the sum rounded to storage;
// with kCorrect base + (res - sum), each operation rounded to storage as
// PyTorch's two eager ops round it
template <typename S, int TAIL, typename C = compute_t<S>>
__device__ __forceinline__ S wsum_store(const WsumTail<S>& tail, C acc,
                                        int64_t k) {
  const S sum = to_storage<S>(acc);
  if constexpr (TAIL == kCorrect) {
    const S d = to_storage<S>(sub_rn(to_compute(tail.res[k]),
                                     to_compute(sum)));
    return to_storage<S>(add_rn(to_compute(tail.base[k]), to_compute(d)));
  }
  return sum;
}

// one thread per row, all five channels
template <typename S, int64_t LOADS, int TAIL>
__global__ void __launch_bounds__(kThreads)
    wsum_row_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const S* __restrict__ w,
                    const S* __restrict__ x, int64_t n_nbr,
                    S* __restrict__ out, int64_t n_rows, bool aligned,
                    WsumTail<S> tail) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  if (wsum_keeps<S, TAIL>(row_ptr, i)) {
    for (int c = 0; c < 5; ++c)
      out[c * n_rows + i] = tail.keep[c * n_rows + i];
    return;
  }
  C acc[5];
  wsum_row<S, 5, LOADS>(row_ptr, col, w, x, n_nbr, i, 0, aligned, acc);
  for (int c = 0; c < 5; ++c)
    out[c * n_rows + i] = wsum_store<S, TAIL>(tail, acc[c], c * n_rows + i);
}

// one thread per (row, channel): thread (c, r) of a block sums channel c
// of row r (the block layout of kChannelLanes)
template <typename S, int64_t LOADS, int TAIL>
__global__ void __launch_bounds__(kChannelThreads)
    wsum_split_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col, const S* __restrict__ w,
                      const S* __restrict__ x, int64_t n_nbr,
                      S* __restrict__ out, int64_t n_rows, bool aligned,
                      WsumTail<S> tail) {
  using C = compute_t<S>;
  const int c = threadIdx.x / kChannelLanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kChannelLanes +
                    threadIdx.x % kChannelLanes;
  if (i >= n_rows) return;
  if (wsum_keeps<S, TAIL>(row_ptr, i)) {
    out[c * n_rows + i] = tail.keep[c * n_rows + i];
    return;
  }
  C acc[1];
  wsum_row<S, 1, LOADS>(row_ptr, col, w, x, n_nbr, i, c, aligned, acc);
  out[c * n_rows + i] = wsum_store<S, TAIL>(tail, acc[0], c * n_rows + i);
}

// the wsum launch shape: a thread per (row, channel) or per row, and the
// loads. Long rows (kChunk entries or more on average): per (row,
// channel), chunked. Short rows: batched, per (row, channel) on thin
// levels; at fp64 on full levels per row, plain (kThinBelow, kFullLevel:
// csr_common.cuh).
struct WsumShape {
  int64_t split;
  int64_t loads;
};

template <typename S>
inline WsumShape choose_wsum(int64_t n_rows, int64_t n_half) {
  if (n_half >= kChunk * n_rows) return WsumShape{1, kChunkedLoads};
  const bool full64 = sizeof(S) == 8 && n_rows >= kFullLevel;
  return WsumShape{n_rows < kThinBelow, full64 ? kPlainLoads : kBatchedLoads};
}

template <typename S, int64_t LOADS, int TAIL>
void launch_wsum_t(int64_t split, const int* rp, const int* cl,
                   const S* wt, const S* xn, int64_t n_nbr, S* o,
                   int64_t n_rows, bool aligned, const WsumTail<S>& tail,
                   cudaStream_t stream) {
  if (split)
    wsum_split_kernel<S, LOADS, TAIL>
        <<<blocks_for(n_rows, kChannelLanes), kChannelThreads, 0, stream>>>(
            rp, cl, wt, xn, n_nbr, o, n_rows, aligned, tail);
  else
    wsum_row_kernel<S, LOADS, TAIL>
        <<<blocks_for(n_rows), kThreads, 0, stream>>>(
            rp, cl, wt, xn, n_nbr, o, n_rows, aligned, tail);
}

template <typename S, int64_t LOADS>
void launch_wsum_l(int64_t split, const int* rp, const int* cl,
                   const S* wt, const S* xn, int64_t n_nbr, S* o,
                   int64_t n_rows, bool aligned, const WsumTail<S>& tail,
                   cudaStream_t stream) {
  if (tail.base != nullptr)
    launch_wsum_t<S, LOADS, kCorrect>(split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, tail, stream);
  else if (tail.keep != nullptr)
    launch_wsum_t<S, LOADS, kKeepEmpty>(split, rp, cl, wt, xn, n_nbr, o,
                                        n_rows, aligned, tail, stream);
  else
    launch_wsum_t<S, LOADS, kSumOnly>(split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, tail, stream);
}

template <typename S>
int launch_wsum(WsumShape s, const int* rp, const int* cl, const S* wt,
                const S* xn, int64_t n_nbr, S* o, int64_t n_rows,
                const WsumTail<S>& tail, cudaStream_t stream) {
  constexpr uintptr_t kWAlign = kChunk * sizeof(S) < 16 ? kChunk * sizeof(S)
                                                        : 16;
  const bool aligned = reinterpret_cast<uintptr_t>(cl) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wt) % kWAlign == 0;
  switch (s.loads) {
    case kPlainLoads:
      launch_wsum_l<S, kPlainLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                    n_rows, aligned, tail, stream);
      break;
    case kChunkedLoads:
      launch_wsum_l<S, kChunkedLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, tail, stream);
      break;
    case kBatchedLoads:
      launch_wsum_l<S, kBatchedLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, tail, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(int64_t mode, const void* row_ptr, const void* col,
           const void* w, int64_t n_half, const void* x_own,
           const void* x_nbr, int64_t n_nbr, void* out, int64_t n_rows,
           const WsumTail<S>& tail, cudaStream_t stream) {
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* cl = static_cast<const int*>(col);
  const auto* wt = static_cast<const S*>(w);
  const auto* xo = static_cast<const S*>(x_own);
  const auto* xn = static_cast<const S*>(x_nbr);
  auto* o = static_cast<S*>(out);
  switch (mode) {
    case kFlux:
      return launch_flux<S>(choose_flux<S>(n_rows, n_half), rp, cl, wt,
                            n_half, xo, xn, n_nbr, o, n_rows, stream);
    case kRw:
      return launch_rw<S>(choose_rw<S>(n_rows, n_half), rp, cl, wt, n_half,
                          xo, xn, n_nbr, o, n_rows, stream);
    case kWsum:
      return launch_wsum<S>(choose_wsum<S>(n_rows, n_half), rp, cl, wt, xn,
                            n_nbr, o, n_rows, tail, stream);
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
// (5, n_nbr), out (5, n_rows); in wsum mode the epilogues' operands keep,
// base and res (5, n_rows) or null (WsumTail), null in the other modes.
extern "C" int mgcfd_edge_csr(int64_t dtype, int64_t mode,
                              const void* row_ptr, const void* col,
                              const void* w, int64_t n_half,
                              const void* x_own, const void* x_nbr,
                              int64_t n_nbr, void* out, int64_t n_rows,
                              const void* keep, const void* base,
                              const void* res, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    const mgcfd::WsumTail<S> tail{static_cast<const S*>(keep),
                                  static_cast<const S*>(base),
                                  static_cast<const S*>(res)};
    return mgcfd::launch<S>(mode, row_ptr, col, w, n_half, x_own, x_nbr,
                            n_nbr, out, n_rows, tail, s);
  });
}

// wsum mode at a given shape (split: a thread per (row, channel); loads:
// 0 plain, 1 chunked, 2 batched); the other arguments as
// mgcfd_edge_csr's. bench/kernel_ab.py --shapes and the card tests call
// it: the sweep that set choose_wsum's thresholds times every shape of the
// library the solver loads, so it times the code the path runs, with no
// second build in a chip call.
extern "C" int mgcfd_wsum_at(int64_t dtype, int64_t split, int64_t loads,
                             const void* row_ptr, const void* col,
                             const void* w, int64_t n_half,
                             const void* x_nbr, int64_t n_nbr, void* out,
                             int64_t n_rows, const void* keep,
                             const void* base, const void* res,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    return mgcfd::launch_wsum<S>(
        mgcfd::WsumShape{split, loads}, static_cast<const int*>(row_ptr),
        static_cast<const int*>(col), static_cast<const S*>(w),
        static_cast<const S*>(x_nbr), n_nbr, static_cast<S*>(out), n_rows,
        mgcfd::WsumTail<S>{static_cast<const S*>(keep),
                           static_cast<const S*>(base),
                           static_cast<const S*>(res)},
        s);
  });
}

// the shape mgcfd_edge_csr launches wsum mode at for n_rows rows and
// n_half entries, into shape[0] (split) and shape[1] (loads); launches
// nothing
extern "C" int mgcfd_wsum_shape(int64_t dtype, int64_t n_rows,
                                int64_t n_half, int64_t* shape) {
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    const mgcfd::WsumShape s =
        mgcfd::choose_wsum<decltype(tag)>(n_rows, n_half);
    shape[0] = s.split;
    shape[1] = s.loads;
    return 0;
  });
}

// rw mode at a given shape (0 row, 1 tile, 2 groups of 8 lanes, 3 groups
// of 8 lanes two entries a lane, 4 groups of 16); the other arguments as
// mgcfd_edge_csr's. Only bench/kernel_ab.py --shapes and chip_smoke.py
// call it, to time and check every shape of the library the solver loads.
extern "C" int mgcfd_rw_at(int64_t dtype, int64_t shape, const void* row_ptr,
                           const void* col, const void* w, int64_t n_half,
                           const void* x_own, const void* x_nbr,
                           int64_t n_nbr, void* out, int64_t n_rows,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    return mgcfd::launch_rw<S>(
        shape, static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const S*>(w), n_half, static_cast<const S*>(x_own),
        static_cast<const S*>(x_nbr), n_nbr, static_cast<S*>(out), n_rows,
        s);
  });
}

// the shape mgcfd_edge_csr launches rw mode at for n_rows rows and n_half
// entries, into shape[0]; launches nothing
extern "C" int mgcfd_rw_shape(int64_t dtype, int64_t n_rows, int64_t n_half,
                              int64_t* shape) {
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    shape[0] = mgcfd::choose_rw<decltype(tag)>(n_rows, n_half);
    return 0;
  });
}

// flux mode at a given shape (0 row, 1 tile); the other arguments as
// mgcfd_edge_csr's. Only bench/kernel_ab.py --shapes and chip_smoke.py
// call it, to time and check every shape of the library the solver loads.
extern "C" int mgcfd_flux_at(int64_t dtype, int64_t shape,
                             const void* row_ptr, const void* col,
                             const void* w, int64_t n_half,
                             const void* x_own, const void* x_nbr,
                             int64_t n_nbr, void* out, int64_t n_rows,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    return mgcfd::launch_flux<S>(
        shape, static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const S*>(w), n_half, static_cast<const S*>(x_own),
        static_cast<const S*>(x_nbr), n_nbr, static_cast<S*>(out), n_rows,
        s);
  });
}

// the shape mgcfd_edge_csr launches flux mode at for n_rows rows and
// n_half entries, into shape[0]; launches nothing
extern "C" int mgcfd_flux_shape(int64_t dtype, int64_t n_rows,
                                int64_t n_half, int64_t* shape) {
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    shape[0] = mgcfd::choose_flux<decltype(tag)>(n_rows, n_half);
    return 0;
  });
}
