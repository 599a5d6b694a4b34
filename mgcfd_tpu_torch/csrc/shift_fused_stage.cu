// shift_fused_stage<S>: one whole RK stage on a box-class mesh, node tiles
// with a shared-memory halo that march along the plan's longest span.
//
// Replaces the Pallas kernel mgcfd_tpu/pallas/flux_shift.py::_fused_kernel
// (:380, launched at :484): per node the span-decomposed internal flux
// (shift_common.cuh), plus the dense boundary + wall flux from the
// aggregated normals nc (11, n) (_bw_flux :357), plus the caller's spill
// flux when there is one, then out = old + fac * flux, and the count of
// NaN, Inf, rho < 0 and E < 0. The sums keep the TPU kernel's order: span
// by span in plan order (acc + val_d(i)) - val_d(i - d), then +
// boundary/wall, then + spill. The count is reduced per block and added
// with one integer atomicAdd per block (csr_common.cuh) into the caller's
// int64 total, so it is deterministic. The epilogue is fused_stage.cu's:
// the residual res = out - old from the stored values (the last RK
// stage).
//
// Bound on the H100 (3.35 TB/s): bytes. Level 0 of the box flagship at
// fp32 moves the state (6.1 MB), the span weights (3 spans, 14.6 MB), old
// (6.1 MB), fac (1.2 MB), nc (13.4 MB) and out (6.1 MB): about 48 MB,
// about 14 us; at bfloat16 about 24 MB, 7 us. chip_smoke.py recomputes it.
// One thread per node, as the kernel was first ported, completed every
// neighbour it read and evaluated every edge value once from each
// endpoint: at level 0 (spans 1, 4480, 70) 7 completions (one division,
// two square roots each) and 6 edge evaluations per node, from about 76
// scalar loads. Its time was instructions and latency, not bytes.
//
// The design, as the TPU kernel completes its window once and evaluates
// each span's values once over its lanes (flux_shift.py:60, :413-422):
//   - A block of kThreads = 256 threads owns a tile of B = 256 consecutive
//     nodes [base, base + B), one node a thread. It completes the window
//     [base - H, base + B + H) once into shared memory, with vector loads
//     (window.cuh).
//   - Halo spans (d <= H <= kMaxHalo = 128; level 0: 1 and 70): the block
//     evaluates val_d(j), j in [base - d, base + B), once into shared
//     memory from the window, one span at a time, in plan order; node i
//     takes val_d(i) and val_d(i - d) from there. (Two spans' values at
//     a time, one barrier fewer, measured slower at fp32 on the H100.)
//   - The marched span (the plan's longest span above kMaxHalo; level 0:
//     4480): the block walks the tiles base, base + d, base + 2d, ... of
//     one pencil for a chunk of M steps. Each thread completes its node's
//     neighbour i + d (the next tile's node), which is both the far end of
//     val_d(i) and, on the next step, the thread's own node; it keeps
//     val_d(i) as the next step's val_d(i' - d). So each value is computed
//     once, plus once per chunk. Both are kept in the thread's own slots
//     of shared memory, not in registers, and so is its node's state. The
//     pencils are the B-wide slices [r0, r0 + B) of [0, d); the last is
//     narrower where B does not divide d, and its spare threads own no
//     node.
//   - Any other span above kMaxHalo is evaluated directly, from both
//     endpoints as before, in the same kernel.
// Per node this is 1 + 2H / B + 2 / M completions and 1 + 1 / M + the
// sum over halo spans of (B + d) / B edge evaluations: at level 0 (H =
// 72, M = 2) 2.6 and 3.8, against 7 and 6 before. The wrapper
// (kernels/shift.py span_schedule) sorts the spans and picks H (the
// largest halo span rounded up to 8) and M (measured: 2 at fp32 and bf16,
// 1 at fp64, on level 0); any plan of up to kMaxSpans spans of any length
// runs.
//
// What holds it back (bench/stage_ab.py on the H100, level 0, warm L2):
// against the one-thread-per-node kernel it replaced it takes 1.13x the
// time at fp32, 1.00x at bf16 and 1.25x at fp64 (at bf16 with a cold L2
// 0.91x). Both fit 5 blocks of 256 threads per SM at fp32. It does fewer
// completions and edge evaluations, but those were not the cost: each
// step runs the window, the halo values and the update as phases between
// barriers, so a tile's latencies add up instead of overlapping across
// independent work in each thread. Staging more per step (the update
// operands in shared memory or registers) cost blocks per SM and was
// slower; so were fewer blocks per SM with more registers.
//
// Shared memory per block: the window, 8 (B + 2H) values, one halo span's
// values, 5 (B + H), and the threads' slots, 13 B, in the compute type: at
// H = 72 (level 0) 32,672 bytes at fp32 and bf16, 65,344 at fp64; at most
// (H = 128) 37,376 and 74,752, asked for above 48 KiB. Registers:
// __launch_bounds__ fits 5 blocks per SM at fp32 and bf16 (window.cuh).
// At bfloat16 (the bf16 branch, :397-431) every operand is stored as bf16
// and widened on load; the window, the span values, the sums and old +
// fac * flux are float32, rounded once on store and counted before
// rounding.
#include "window.cuh"

namespace mgcfd {

constexpr int kMaxHalo = 128;
enum SpanKind : int64_t { kHaloSpan = 0, kMarchedSpan = 1, kDirectSpan = 2 };

struct SpanTiles {
  int64_t d[kMaxSpans];
  int64_t kind[kMaxSpans];
  int64_t count;
  int64_t march;    // index of the marched span, or -1
  int64_t halo;     // H
  int64_t stride;   // the marched span, else B
  int64_t pencils;  // ceil(stride / B)
  int64_t steps;    // ceil(n / stride)
  int64_t chunk;    // M, steps per block
  int64_t vec;      // the state rows take vector loads
};

// dynamic shared memory per block at a halo H: the window (8, B + 2H),
// one halo span's values (5, B + H: a halo span d <= H has B + d) and
// the threads' slots (13, B), in the compute type C
template <typename C>
inline size_t shared_bytes(int H) {
  return sizeof(C) * (8 * (kThreads + 2 * H) + 5 * (kThreads + H) +
                      13 * kThreads);
}

// val_d(j) from completed endpoints a, b; span weights w (4, n) read only
// for 0 <= j < n, zero elsewhere (shift_common.cuh's rows)
template <typename S, typename T = compute_t<S>>
__device__ __forceinline__ void edge_at(const State8<T>& a,
                                        const State8<T>& b,
                                        const S* __restrict__ w, int64_t n,
                                        int64_t j, T v[5]) {
  edge_value<S, false>(a, b, w, n, j < n ? j : -1, v);
}

template <typename S, bool RES>
__global__ void __launch_bounds__(kThreads, ShiftMinBlocks<S>::value)
    shift_fused_stage_kernel(SpanTiles sp, const S* __restrict__ w,
                             const S* __restrict__ q,
                             const S* __restrict__ old,
                             const S* __restrict__ fac,
                             const S* __restrict__ nc,
                             const S* __restrict__ spill,
                             S* __restrict__ out, S* __restrict__ res,
                             long long* __restrict__ total, int64_t n) {
  using C = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = static_cast<int>(sp.halo);
  const int W = kThreads + 2 * H;          // window
  const int VW = kThreads + H;             // one halo span's values
  C* sq = reinterpret_cast<C*>(smem);      // (8, W)
  C* sv = sq + 8 * W;                      // (5, VW)
  // each thread's own slots, kept in shared memory rather than registers
  // (more blocks fit on an SM): node i + dm and val_dm(i - dm)
  C* sahead = sv + 5 * VW;           // (8, B)
  C* sprev = sahead + 8 * kThreads;  // (5, B)
  const int t = threadIdx.x;
  const int64_t r0 = (blockIdx.x % sp.pencils) * kThreads;
  const int64_t s0 = (blockIdx.x / sp.pencils) * sp.chunk;
  const int64_t s1 =
      s0 + sp.chunk < sp.steps ? s0 + sp.chunk : sp.steps;
  const bool in_pencil = r0 + t < sp.stride;
  const bool marched = sp.march >= 0;
  const int64_t dm = marched ? sp.d[sp.march] : 0;
  const auto node_i = [&] { return get8(sq, W, H + t); };
  int bad = 0;
  for (int64_t s = s0; s < s1; ++s) {
    const int64_t base = r0 + s * sp.stride;
    if (base >= n) break;  // the same for every thread of the block
    const int64_t i = base + t;
    const bool own = in_pencil && i < n;
    if (s == s0 || !marched) {
      complete_window<S>(q, n, base - H, W, sq, W, 0, sp.vec);
    } else {
      put8(sq, W, H + t, get8(sahead, kThreads, t));
      complete_window<S>(q, n, base - H, H, sq, W, 0, sp.vec);
      complete_window<S>(q, n, base + kThreads, H, sq, W, H + kThreads,
                         sp.vec);
    }
    if (marched && (own || s + 1 < s1))
      put8(sahead, kThreads, t, node_or_quiescent(q, n, i + dm));
    __syncthreads();  // the window is written
    if (marched && own && s == s0) {
      C v[5];
      edge_at<S>(node_or_quiescent(q, n, i - dm), node_i(),
                 w + sp.march * 4 * n, n, i - dm, v);
      for (int c = 0; c < 5; ++c) sprev[c * kThreads + t] = v[c];
    }
    C acc[5];
    for (int c = 0; c < 5; ++c) acc[c] = C(0);
    bool sv_read = false;  // sv holds values that threads have read
    for (int k = 0; k < sp.count; ++k) {
      const int64_t d = sp.d[k];
      const S* wk = w + k * 4 * n;
      C a[5], b[5];
      if (sp.kind[k] == kHaloSpan) {
        // the span's values val_d(base - d + x), x < B + d, once each
        const int dd = static_cast<int>(d);
        if (sv_read) __syncthreads();  // the previous span's are read
        for (int x = t; x < kThreads + dd; x += kThreads) {
          C v[5];
          edge_at<S>(get8(sq, W, H - dd + x), get8(sq, W, H + x), wk, n,
                     base - dd + x, v);
          for (int c = 0; c < 5; ++c) sv[c * VW + x] = v[c];
        }
        __syncthreads();  // the span's values are written
        for (int c = 0; c < 5; ++c) {
          a[c] = sv[c * VW + t + dd];
          b[c] = sv[c * VW + t];
        }
        sv_read = true;
      } else if (!own) {
        continue;
      } else if (sp.kind[k] == kMarchedSpan) {
        edge_at<S>(node_i(), get8(sahead, kThreads, t), wk, n, i, a);
        for (int c = 0; c < 5; ++c) {
          b[c] = sprev[c * kThreads + t];
          sprev[c * kThreads + t] = a[c];
        }
      } else {
        edge_at<S>(node_i(), node_or_quiescent(q, n, i + d), wk, n, i, a);
        edge_at<S>(node_or_quiescent(q, n, i - d), node_i(), wk, n, i - d,
                   b);
      }
      for (int c = 0; c < 5; ++c) acc[c] = (acc[c] + a[c]) - b[c];
    }
    if (own)
      bad += update_node<S, RES>(node_i(), acc, nc, old, fac, spill, n, i,
                                 out, res, n, i);
    __syncthreads();  // the window and span values are read
  }
  add_block_count(bad, total);
}

template <typename S>
int launch_shift_fused(const SpanTiles& sp, const void* w, const void* q,
                       const void* old, const void* fac, const void* nc,
                       const void* spill, void* out, void* res,
                       void* total, int64_t n, cudaStream_t stream) {
  const size_t smem = shared_bytes<compute_t<S>>(static_cast<int>(sp.halo));
  const int64_t blocks =
      sp.pencils * ((sp.steps + sp.chunk - 1) / sp.chunk);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // each instantiation is raised once per device (window.cuh SharedGrant)
  static SharedGrant granted[2];
  auto* kernel = res != nullptr ? shift_fused_stage_kernel<S, true>
                                : shift_fused_stage_kernel<S, false>;
  const int rc = allow_shared(kernel, shared_bytes<compute_t<S>>(kMaxHalo),
                              granted[res != nullptr]);
  if (rc != 0) return rc;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          sp, static_cast<const S*>(w), static_cast<const S*>(q),
          static_cast<const S*>(old), static_cast<const S*>(fac),
          static_cast<const S*>(nc), static_cast<const S*>(spill),
          static_cast<S*>(out), static_cast<S*>(res),
          static_cast<long long*>(total), n);
  return static_cast<int>(cudaGetLastError());
}

// the tiling of a plan: spans by kind, the stride, pencils and steps
// (kernels/shift.py span_schedule computes the same); -1 if the kinds do
// not describe a plan the kernel can tile
inline int make_span_tiles(const int64_t* deltas, const int64_t* kinds,
                           int64_t count, int64_t halo, int64_t chunk,
                           int64_t n, SpanTiles* sp) {
  if (count < 0 || count > kMaxSpans || halo < 0 || halo > kMaxHalo ||
      halo % 8 != 0 || chunk < 1 || n < 0)
    return -1;
  sp->count = count;
  sp->march = -1;
  sp->halo = halo;
  sp->chunk = chunk;
  for (int64_t k = 0; k < count; ++k) {
    sp->d[k] = deltas[k];
    sp->kind[k] = kinds[k];
    if (deltas[k] <= 0) return -1;
    if (kinds[k] == kHaloSpan) {
      if (deltas[k] > halo) return -1;
    } else if (kinds[k] == kMarchedSpan) {
      if (sp->march >= 0) return -1;
      sp->march = k;
    } else if (kinds[k] != kDirectSpan) {
      return -1;
    }
  }
  sp->stride = sp->march >= 0 ? deltas[sp->march] : kThreads;
  sp->pencils = (sp->stride + kThreads - 1) / kThreads;
  sp->steps = n > 0 ? (n + sp->stride - 1) / sp->stride : 0;
  return 0;
}

}  // namespace mgcfd

// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code or a schedule the
// kernel cannot tile. dtype: 0 float32, 1 float64, 2 bfloat16 (the
// storage type of every float operand). deltas and kinds are host arrays
// of num_deltas (<= 16) spans and their kinds in plan order (0 halo, 1
// marched, at most one, 2 direct); halo: H, a multiple of 8 up to 128, at
// least every halo span; steps_per_chunk: M >= 1. Device pointers: w
// (num_deltas, 4, n), q, old, out (5, n), fac (n), nc (11, n), spill (5,
// n) or null, res (5, n) or null, and total: one int64 to which the
// kernel adds the count.
extern "C" int mgcfd_shift_fused_stage(
    int64_t dtype, const int64_t* deltas, const int64_t* kinds,
    int64_t num_deltas, int64_t halo, int64_t steps_per_chunk,
    const void* w, const void* q, const void* old, const void* fac,
    const void* nc, const void* spill, void* out, void* res, void* total,
    int64_t n, void* stream) {
  mgcfd::SpanTiles sp;
  if (mgcfd::make_span_tiles(deltas, kinds, num_deltas, halo,
                             steps_per_chunk, n, &sp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    sp.vec = mgcfd::rows_take_vectors<S>(q, n) &&
             sp.stride % mgcfd::Vec<S>::width == 0;
    return mgcfd::launch_shift_fused<S>(sp, w, q, old, fac, nc, spill, out,
                                        res, total, n, s);
  });
}
