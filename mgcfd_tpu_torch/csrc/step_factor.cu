// step_factor<S>: the step factor of a variable-major (5, n) state and
// the factors of the RK stages, fac[j * n + i] = sf[i] / (RK + 1 - j), in
// two launches a level visit (one for the legacy variant).
//
// Replaces no Pallas kernel: mgcfd_tpu takes the step factor in jnp
// (mgcfd_tpu/solver/solver.py:590 t_step_factor), which XLA fuses on the
// TPU. The port ran it as eager PyTorch ops on the card: t_primitives'
// twelve elementwise kernels and a reduction, speed + sos, 0.5 * cbrt(V),
// the divide, torch.min and / V, then one divide for each RK stage's
// factor: about 20 launches a visit, each a pass over the level.
//
// What it computes (cfd_loops.cpp:13-157; solver.py t_step_factor, with
// tops.t_primitives' operation order):
//   corrected: dt[i] = (0.5 cbrt(V[i])) / (|v[i]| + c[i]),
//              sf[i] = min_k dt[k] / V[i];
//   legacy:    sf[i] = (1 / (sqrt(V[i]) (|v[i]| + c[i]))) * 0.5.
// It gives the eager ops' bits on the card at every dtype. Every
// operation is an intrinsic that rounds once (Rn below), so nvcc's
// contraction of a multiply and an add into one FMA, on by default
// (kernels/build.py's flags), cannot change a rounding; and each
// operation is the one the eager op computes: 1.0 / rho and 0.5 / x are
// torch's reciprocal times the scalar (Tensor.__rtruediv__);
// speed_sqd = (vx vx + vy vy) + vz vz, the order in which torch.sum adds
// three rows; sf / float(RK + 1 - j) is a multiply by the divisor's
// reciprocal in the compute type, which is how torch divides a CUDA tensor
// by a host scalar; the scalars are cast to the compute type as torch
// casts a Python float. At bfloat16 the eager ops compute each operation
// in float32 and round its result to bf16 on store, and so does the
// kernel (Eager below): every operation's result is rounded to bf16 where
// the eager op stores it, the three squares' sum once after its float
// adds (torch.sum accumulates in float32), and a divide by a host scalar
// once after its float multiply.
//
// Bound on the H100 (3.35 TB/s): bytes. Pass 1 reads q and cbrt(V), pass
// 2 reads V and writes the RK factors: 10 values a node, 12.2 MB at fp32
// on the box flagship's level 0 (304,640 nodes), about 3.6 us; the legacy
// pass reads q and V and writes the factors, 9 values a node.
//
// The design:
//   - Pass 1 (step_min_kernel): a thread completes kStepNodes nodes
//     kThreads apart, so that a warp's loads of each channel are
//     contiguous, and keeps the least dt; a warp's least by shuffles, the
//     block's through shared memory, stored as partials[block]. Thread 0
//     then fences and counts the block's arrival with one integer
//     atomicAdd; the block that arrives last reduces the blocks' minima
//     into partials[blocks] and sets the counter back to 0, so the next
//     launch, or a CUDA graph's replay, finds it at 0. No float atomic:
//     the minimum is the same whatever the blocks' order.
//   - Where the caller gives prims (the window path's level buffer),
//     pass 1 also stores each node's primitives for the first RK stage
//     to gather (csr_common.cuh store_primitives): complete8 of the
//     stored q, the fused stage's own operations, apart from the
//     eager-order values above, which keep their bits; 8 B a node more
//     written at fp32.
//   - The minimum propagates NaN as torch.min does (fminf drops it): a NaN
//     in any node's dt makes every factor NaN.
//   - Pass 2 (stage_factor_kernel): a thread a node, sf = min / V[i], and
//     the RK factors, each rounded as the eager sf / V then / (RK + 1 - j).
//   - Legacy (legacy_step_kernel): no minimum, so pass 2 alone, completing
//     its node itself.
// The caller owns the scratch: partials (blocks + 1 values of the compute
// type) and the counter (one int32, zeroed once). Each kernel is a
// template on the storage type S and computes in compute_t<S>
// (csr_common.cuh).
#include <cmath>

#include "csr_common.cuh"

namespace mgcfd {

constexpr int kRK = 3;
// pass 1: nodes a thread, and so nodes a block
constexpr int kStepNodes = 4;
constexpr int64_t kStepBlockNodes = int64_t(kThreads) * kStepNodes;

// one rounding to nearest a operation, never contracted
template <typename C>
struct Rn;
template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
};
template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
};

// an eager op of storage type S: the operation in the compute type, then
// its result rounded to S, where the eager op stores it (a no-op at
// float32 and float64)
template <typename S>
struct Eager {
  using C = compute_t<S>;
  using R = Rn<C>;
  static __device__ __forceinline__ C st(C a) {
    return to_compute(to_storage<S>(a));
  }
  static __device__ __forceinline__ C add(C a, C b) {
    return st(R::add(a, b));
  }
  static __device__ __forceinline__ C sub(C a, C b) {
    return st(R::sub(a, b));
  }
  static __device__ __forceinline__ C mul(C a, C b) {
    return st(R::mul(a, b));
  }
  static __device__ __forceinline__ C div(C a, C b) {
    return st(R::div(a, b));
  }
  static __device__ __forceinline__ C sqrt(C a) { return st(R::sqrt(a)); }
};

// |v| + c of node i of a (5, n) state (tops.t_primitives)
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ C speed_plus_sos(const S* __restrict__ q,
                                            int64_t n, int64_t i) {
  using Op = Eager<S>;
  using R = Rn<C>;
  const C rho = to_compute(q[i]), mx = to_compute(q[n + i]),
          my = to_compute(q[2 * n + i]), mz = to_compute(q[3 * n + i]),
          e = to_compute(q[4 * n + i]);
  const C inv = Op::div(C(1), rho);
  const C vx = Op::mul(mx, inv), vy = Op::mul(my, inv),
          vz = Op::mul(mz, inv);
  // torch.sum of the three squares: added in the compute type, rounded once
  const C speed_sqd = Op::st(R::add(
      R::add(Op::mul(vx, vx), Op::mul(vy, vy)), Op::mul(vz, vz)));
  const C p = Op::mul(C(kGamma - 1.0),
                      Op::sub(e, Op::mul(Op::mul(C(0.5), rho), speed_sqd)));
  const C sos = Op::sqrt(Op::mul(Op::mul(C(kGamma), p), inv));
  return Op::add(Op::sqrt(speed_sqd), sos);
}

// the least of a and b, NaN if either is NaN (torch.min)
template <typename C>
__device__ __forceinline__ C nan_min(C a, C b) {
  return (a != a || a <= b) ? a : b;
}

// the block's least v, in thread 0; `shared` holds a value a warp
template <typename C>
__device__ __forceinline__ C block_min(C v, C* shared) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_min(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? shared[lane] : C(INFINITY);
    for (int off = 16; off > 0; off >>= 1)
      v = nan_min(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// fac[j * n + i] = sf / (RK + 1 - j), as the eager divide by a host scalar
// rounds it: a multiply by the divisor's reciprocal, stored
template <typename S, typename C = compute_t<S>>
__device__ __forceinline__ void store_stages(C sf, S* __restrict__ fac,
                                             int64_t n, int64_t i) {
#pragma unroll
  for (int j = 0; j < kRK; ++j)
    fac[j * n + i] = to_storage<S>(Rn<C>::mul(sf, C(1) / C(kRK + 1 - j)));
}

// PRIM: the epilogue that also stores each node's primitives into prims
// (2, n), complete8 of the stored q as the fused stage completes it,
// apart from the eager-order values above (csr_common.cuh)
template <typename S, bool PRIM>
__global__ void __launch_bounds__(kThreads)
    step_min_kernel(const S* __restrict__ q, const S* __restrict__ cbrt_v,
                    compute_t<S>* __restrict__ partials,
                    unsigned int* __restrict__ arrivals,
                    compute_t<S>* __restrict__ prims, int64_t n) {
  using C = compute_t<S>;
  using Op = Eager<S>;
  __shared__ C shared[kThreads / 32];
  __shared__ bool last;
  const int64_t first = int64_t(blockIdx.x) * kStepBlockNodes + threadIdx.x;
  C m = C(INFINITY);
#pragma unroll
  for (int k = 0; k < kStepNodes; ++k) {
    const int64_t i = first + int64_t(k) * kThreads;
    if (i < n) {
      m = nan_min(m, Op::div(Op::mul(C(0.5), to_compute(cbrt_v[i])),
                             speed_plus_sos(q, n, i)));
      if constexpr (PRIM) store_primitives(complete8(q, n, i), prims, n, i);
    }
  }
  m = block_min(m, shared);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(arrivals, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every block stored its minimum and fenced before it arrived; read
  // them past L1
  C g = C(INFINITY);
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads)
    g = nan_min(g, __ldcg(partials + b));
  g = block_min(g, shared);
  if (threadIdx.x == 0) {
    partials[gridDim.x] = g;
    *arrivals = 0u;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    stage_factor_kernel(const S* __restrict__ volumes,
                        const compute_t<S>* __restrict__ least,
                        S* __restrict__ fac, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  store_stages(Eager<S>::div(*least, to_compute(volumes[i])), fac, n, i);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    legacy_step_kernel(const S* __restrict__ q,
                       const S* __restrict__ volumes, S* __restrict__ fac,
                       int64_t n) {
  using C = compute_t<S>;
  using Op = Eager<S>;
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const C x = Op::mul(Op::sqrt(to_compute(volumes[i])),
                      speed_plus_sos(q, n, i));
  store_stages(Op::mul(Op::div(C(1), x), C(0.5)), fac, n, i);
}

template <typename S>
int launch_step(bool legacy, const void* q, const void* volumes,
                const void* cbrt_v, void* partials, int64_t partials_len,
                void* arrivals, void* prims, void* fac, int64_t n,
                cudaStream_t s) {
  const auto node_blocks = static_cast<unsigned>((n + kThreads - 1) /
                                                 kThreads);
  if (legacy) {
    legacy_step_kernel<S><<<node_blocks, kThreads, 0, s>>>(
        static_cast<const S*>(q), static_cast<const S*>(volumes),
        static_cast<S*>(fac), n);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (n + kStepBlockNodes - 1) / kStepBlockNodes;
  if (partials_len < blocks + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using C = compute_t<S>;
  C* part = static_cast<C*>(partials);
  auto* pass1 = prims != nullptr ? step_min_kernel<S, true>
                                 : step_min_kernel<S, false>;
  pass1<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const S*>(q), static_cast<const S*>(cbrt_v), part,
      static_cast<unsigned int*>(arrivals), static_cast<C*>(prims), n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stage_factor_kernel<S><<<node_blocks, kThreads, 0, s>>>(
      static_cast<const S*>(volumes), part + blocks, static_cast<S*>(fac),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgcfd

// Returns the cudaError_t of the launches (0 = success), or
// cudaErrorInvalidValue for an unknown dtype code or for partials shorter
// than pass 1's blocks + 1. q (5, n); volumes, cbrt_v (n); fac (RK, n)
// out, all of the dtype; partials (partials_len values of its compute
// type) and arrivals (one int32, 0 before the first launch) are the
// caller's scratch, which the kernels leave ready for the next launch.
// cbrt_v, partials and arrivals are not read when legacy is nonzero.
// prims: (2, n) of the compute type, where pass 1 stores q's primitives
// (csr_common.cuh), or null; the legacy pass stores none.
extern "C" int mgcfd_step_factor(int64_t dtype, int64_t legacy,
                                 const void* q, const void* volumes,
                                 const void* cbrt_v, void* partials,
                                 int64_t partials_len, void* arrivals,
                                 void* prims, void* fac, int64_t n,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return mgcfd::dispatch_dtype(dtype, [&](auto tag) {
    using S = decltype(tag);
    if (n == 0) return 0;
    return mgcfd::launch_step<S>(legacy != 0, q, volumes, cbrt_v, partials,
                                 partials_len, arrivals, prims, fac, n, s);
  });
}
