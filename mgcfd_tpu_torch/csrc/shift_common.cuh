// Device math shared by shift_flux.cu and shift_fused_stage.cu: the span
// decomposition of the internal-edge flux on box-class meshes, one thread
// per node, written from what mgcfd_tpu/pallas/flux_shift.py computes.
//
// The plan (prep/shift.py) puts every covered edge (j, j + d) of span d on
// row j of a dense weight array. The edge value of row j of span d is
//   val_d(j) = edge(q[j], q[j + d], w_d[j])
// and node i's internal flux is, span by span in plan order,
//   acc = (acc + val_d(i)) - val_d(i - d)
// which is the TPU kernel's per-span accumulation. Each edge value is
// computed twice, once by each endpoint's thread: no atomics, and every
// sum has one fixed order.
//
// Rows are evaluated as the TPU kernel evaluates its lanes: a row with no
// edge has zero weight and is evaluated all the same (so a NaN spreads as
// it does there), and an endpoint outside [0, n) is quiescent gas
// (rho = 1, momentum 0, E = 1) with zero weight, the TPU kernel's masked
// lanes. Weights are stored full width as (D, 4, n), rows wx, wy, wz, |w|,
// zero where there is no edge, so a span needs no offset arithmetic.
#pragma once

#include "csr_common.cuh"

namespace mgcfd {

constexpr int kMaxSpans = 16;  // build_shift_plan's default max_deltas

struct Spans {
  int64_t d[kMaxSpans];
  int64_t count;
};

template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ State8<C> node_or_quiescent(
    const S* __restrict__ q, int64_t n, int64_t j) {
  if (j >= 0 && j < n) return complete8(q, n, j);
  return complete8<C>(C(1), C(0), C(0), C(0), C(1));
}

// val_d(j) into v; w is span d's (4, n) weight block, zero for j < 0.
// Flux mode: flux_shift.py::_edge_val_ch (:80), the op order of
// csr_common.cuh's flux_math. Rw mode: the indirect_rw twin
// _edge_val_rw (:108), (q_a + q_b) + ((wx + wy) + wz) per channel.
// In the compute type T; w is stored as S.
template <typename S, bool RW, typename T = compute_t<S>>
__device__ __forceinline__ void edge_value(const State8<T>& a,
                                           const State8<T>& b,
                                           const S* __restrict__ w,
                                           int64_t n, int64_t j, T v[5]) {
  T wx = T(0), wy = T(0), wz = T(0), wt = T(0);
  if (j >= 0) {
    wx = to_compute(w[j]);
    wy = to_compute(w[n + j]);
    wz = to_compute(w[2 * n + j]);
    wt = to_compute(w[3 * n + j]);
  }
  if constexpr (RW) {
    const T e = (wx + wy) + wz;
    v[0] = (a.rho + b.rho) + e;
    v[1] = (a.mx + b.mx) + e;
    v[2] = (a.my + b.my) + e;
    v[3] = (a.mz + b.mz) + e;
    v[4] = (a.E + b.E) + e;
  } else {
    flux_math(a, b, wx, wy, wz, wt, v);
  }
}

// acc = node i's internal flux (or its rw twin) over every span, in the
// compute type T (float32 at bfloat16 until the caller's one store)
template <typename S, bool RW, typename T = compute_t<S>>
__device__ __forceinline__ void span_sum(const Spans& sp,
                                         const S* __restrict__ w,
                                         const S* __restrict__ q, int64_t n,
                                         int64_t i, const State8<T>& qi,
                                         T acc[5]) {
  for (int c = 0; c < 5; ++c) acc[c] = T(0);
  for (int64_t k = 0; k < sp.count; ++k) {
    const int64_t d = sp.d[k];
    const S* wk = w + k * 4 * n;
    T v[5];
    edge_value<S, RW>(qi, node_or_quiescent(q, n, i + d), wk, n, i, v);
    for (int c = 0; c < 5; ++c) acc[c] += v[c];
    edge_value<S, RW>(node_or_quiescent(q, n, i - d), qi, wk, n, i - d, v);
    for (int c = 0; c < 5; ++c) acc[c] -= v[c];
  }
}

inline int make_spans(const int64_t* deltas, int64_t count, Spans* sp) {
  if (count < 0 || count > kMaxSpans) return -1;
  for (int64_t k = 0; k < count; ++k) sp->d[k] = deltas[k];
  sp->count = count;
  return 0;
}

}  // namespace mgcfd
