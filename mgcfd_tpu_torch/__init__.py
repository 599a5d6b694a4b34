"""mgcfd_tpu_torch — the multigrid Euler solver of ``mgcfd_tpu`` in PyTorch,
with hand-written CUDA kernels for an NVIDIA H100.

It imports torch, numpy and scipy, never jax and nothing of ``mgcfd_tpu``.
Layering follows the JAX package:
  core/      constants, typed containers, solver config
  mesh/      the reference's mesh files and their npz cache, box and
             tetrahedral generators, duplication, edge-weight conditioning
  prep/      owner-sorted CSR plans for the edge and multigrid kernels,
             span plans, RCM renumbering
  ops/       plain torch ops (flux, stepping, multigrid, validation)
  kernels/   the nvcc build and the kernel wrappers (sources in csrc/)
  solver/    RK smoother + multigrid V-cycle; K cycles as a CUDA graph
  monitor/   the instrumented solver, the reference's CSV reports, the
             cost model, device time per function from torch.profiler
  validate/  golden-comparison tolerances
  cli/       command-line entry point (subset of the reference flags)
  bench/     the flagship problems, the cycle profile, kernel A/B timing
  utils/     gated diagnostic logging
"""

__version__ = "0.1.0"
