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
//   - flux and rw modes: one thread per owner row; the 6 MB state stays
//     in the 50 MB L2, so the neighbour gathers hit the cache; weights and
//     indices are streamed once. Both reach half their byte bound at
//     every dtype and are left as the first port wrote them.
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
// At bfloat16 (the bf16 branch, :254-296) the state and weights halve and
// row_ptr and col do not: about 29 MB in flux mode. Each sum stays in
// float32 until its one rounded store.
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

// one thread per row, all five channels
template <typename S, int64_t LOADS>
__global__ void __launch_bounds__(kThreads)
    wsum_row_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const S* __restrict__ w,
                    const S* __restrict__ x, int64_t n_nbr,
                    S* __restrict__ out, int64_t n_rows, bool aligned) {
  using C = compute_t<S>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  C acc[5];
  wsum_row<S, 5, LOADS>(row_ptr, col, w, x, n_nbr, i, 0, aligned, acc);
  for (int c = 0; c < 5; ++c) out[c * n_rows + i] = to_storage<S>(acc[c]);
}

// one thread per (row, channel): thread (c, r) of a block sums channel c
// of row r (the block layout of kChannelLanes)
template <typename S, int64_t LOADS>
__global__ void __launch_bounds__(kChannelThreads)
    wsum_split_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col, const S* __restrict__ w,
                      const S* __restrict__ x, int64_t n_nbr,
                      S* __restrict__ out, int64_t n_rows, bool aligned) {
  using C = compute_t<S>;
  const int c = threadIdx.x / kChannelLanes;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kChannelLanes +
                    threadIdx.x % kChannelLanes;
  if (i >= n_rows) return;
  C acc[1];
  wsum_row<S, 1, LOADS>(row_ptr, col, w, x, n_nbr, i, c, aligned, acc);
  out[c * n_rows + i] = to_storage<S>(acc[0]);
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

template <typename S, int64_t LOADS>
void launch_wsum_l(int64_t split, const int* rp, const int* cl,
                   const S* wt, const S* xn, int64_t n_nbr, S* o,
                   int64_t n_rows, bool aligned, cudaStream_t stream) {
  if (split)
    wsum_split_kernel<S, LOADS>
        <<<blocks_for(n_rows, kChannelLanes), kChannelThreads, 0, stream>>>(
            rp, cl, wt, xn, n_nbr, o, n_rows, aligned);
  else
    wsum_row_kernel<S, LOADS><<<blocks_for(n_rows), kThreads, 0, stream>>>(
        rp, cl, wt, xn, n_nbr, o, n_rows, aligned);
}

template <typename S>
int launch_wsum(WsumShape s, const int* rp, const int* cl, const S* wt,
                const S* xn, int64_t n_nbr, S* o, int64_t n_rows,
                cudaStream_t stream) {
  constexpr uintptr_t kWAlign = kChunk * sizeof(S) < 16 ? kChunk * sizeof(S)
                                                        : 16;
  const bool aligned = reinterpret_cast<uintptr_t>(cl) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wt) % kWAlign == 0;
  switch (s.loads) {
    case kPlainLoads:
      launch_wsum_l<S, kPlainLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                    n_rows, aligned, stream);
      break;
    case kChunkedLoads:
      launch_wsum_l<S, kChunkedLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, stream);
      break;
    case kBatchedLoads:
      launch_wsum_l<S, kBatchedLoads>(s.split, rp, cl, wt, xn, n_nbr, o,
                                      n_rows, aligned, stream);
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
      return launch_wsum<S>(choose_wsum<S>(n_rows, n_half), rp, cl, wt, xn,
                            n_nbr, o, n_rows, stream);
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

// wsum mode at a given shape (split: a thread per (row, channel); loads:
// 0 plain, 1 chunked, 2 batched); the other arguments as
// mgcfd_edge_csr's. Only bench/kernel_ab.py --shapes calls it: the sweep
// that set choose_wsum's thresholds times every shape of the library the
// solver loads, so it times the code the path runs, with no second build
// in a chip call.
extern "C" int mgcfd_wsum_at(int64_t dtype, int64_t split, int64_t loads,
                             const void* row_ptr, const void* col,
                             const void* w, int64_t n_half,
                             const void* x_nbr, int64_t n_nbr, void* out,
                             int64_t n_rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n_rows == 0) return 0;
    return mgcfd::launch_wsum<S>(
        mgcfd::WsumShape{split, loads}, static_cast<const int*>(row_ptr),
        static_cast<const int*>(col), static_cast<const S*>(w),
        static_cast<const S*>(x_nbr), n_nbr, static_cast<S*>(out), n_rows,
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
