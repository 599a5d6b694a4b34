"""step_factor: the step factor of a (5, N) state and the factors of the
RK stages in two launches — the CUDA kernel csrc/step_factor.cu, its
wrapper and its plain PyTorch version.

Replaces no Pallas kernel: mgcfd_tpu takes the step factor in jnp, which
XLA fuses on the TPU, and the port ran it as about 20 eager launches a
level visit. The wrapper returns fac (RK, N), row j the factor of RK
stage j, the step factor over (RK + 1 - j), which the stages take as
they are. On the card it launches the kernel, whose factors equal the
plain version's bit for bit at every dtype (the source says how, bfloat16
included): the corrected variant in two launches (the nodes' least dt,
then the factors), the legacy one in one. It takes the plain version for
tensors on the CPU. On the card it needs the level's StepScratch,
allocated once, outside any graph capture. The corrected variant's first
pass also stores the state's primitives (fused_stage.primitives) where
the caller gives it a buffer (prims_out), for the first RK stage to
gather: counted under epilogue.primitives.
"""
from __future__ import annotations

import torch

from ..core.constants import RK
from ..ops import tops
from . import build, edge_csr
from .counts import launched
from .edge_csr import compute_dtype, pointer
from .fused_stage import check_primitives, primitives

# nodes a block of the kernel's first pass (kStepBlockNodes in
# csrc/step_factor.cu: 256 threads of 4 nodes)
STEP_BLOCK_NODES = 1024


def step_factor_plain(q, volumes, cbrt_volumes, legacy: bool):
    """Step factor (N,) of a (5, N) state (cfd_loops.cpp:13-157): the
    legacy 0.5 / (sqrt(V) (|v| + c)), or the least 0.5 cbrt(V) / (|v| + c)
    of all nodes over each node's V."""
    prim = tops.t_primitives(q)
    if legacy:
        return 0.5 / (torch.sqrt(volumes) * (prim["speed"] + prim["sos"]))
    dt = 0.5 * cbrt_volumes / (prim["speed"] + prim["sos"])
    return torch.min(dt).expand(dt.shape) / volumes


def stage_factors_plain(q, volumes, cbrt_volumes, legacy: bool):
    """What the kernel computes: (RK, N), row j the step factor over
    (RK + 1 - j)."""
    sf = step_factor_plain(q, volumes, cbrt_volumes, legacy)
    return torch.stack([sf / float(RK + 1 - j) for j in range(RK)])


class StepScratch:
    """A level's scratch for the kernel's corrected variant: each first-
    pass block's least dt, then the least of all (partials), and the
    count of blocks that have arrived (arrivals), 0 between launches."""

    def __init__(self, num_nodes: int, dtype: torch.dtype, device):
        blocks = -(-num_nodes // STEP_BLOCK_NODES)
        self.num_nodes = num_nodes
        self.partials = torch.empty(blocks + 1, dtype=compute_dtype(dtype),
                                    device=device)
        self.arrivals = torch.zeros(1, dtype=torch.int32, device=device)


class StepFactor:
    """The step_factor kernel."""

    def __init__(self, name: str = "step_factor"):
        self.name = name

    def __call__(self, q, volumes, cbrt_volumes, legacy: bool,
                 scratch: StepScratch | None = None, prims_out=None):
        """q: (5, N); volumes, cbrt_volumes: (N,). Returns fac (RK, N).
        scratch: the level's, required on the card. prims_out: a (2, N)
        buffer that takes q's primitives, or None; the legacy variant
        stores none."""
        n = q.shape[1]
        for name, t, shape in (("q", q, (5, n)), ("volumes", volumes, (n,)),
                               ("cbrt_volumes", cbrt_volumes, (n,))):
            if tuple(t.shape) != shape or t.dtype != q.dtype or \
                    t.device != q.device or not t.is_contiguous():
                raise ValueError(f"step_factor: {name} must be a contiguous "
                                 f"{shape} {q.dtype} tensor on {q.device}")
        check_primitives(prims_out, q, self.name, "prims_out")
        if legacy and prims_out is not None:
            raise ValueError("step_factor: the legacy variant stores no "
                             "primitives")
        if not edge_csr._on_card(q):
            if prims_out is not None:
                prims_out.copy_(primitives(q))
            return stage_factors_plain(q, volumes, cbrt_volumes, legacy)
        if scratch is None:
            raise ValueError("step_factor: a StepScratch is required on "
                             "the card")
        if scratch.num_nodes != n or \
                scratch.partials.dtype != compute_dtype(q.dtype) or \
                scratch.partials.device != q.device:
            raise ValueError(f"step_factor: scratch for {scratch.num_nodes} "
                             f"{scratch.partials.dtype} nodes on "
                             f"{scratch.partials.device}, state of {n} "
                             f"{q.dtype} nodes on {q.device}")
        fac = torch.empty((RK, n), dtype=q.dtype, device=q.device)
        rc = build.library().mgcfd_step_factor(
            build.dtype_code(q), int(legacy), q.data_ptr(),
            volumes.data_ptr(), cbrt_volumes.data_ptr(),
            scratch.partials.data_ptr(), scratch.partials.numel(),
            scratch.arrivals.data_ptr(), pointer(prims_out),
            fac.data_ptr(), n,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, self.name)
        launched(self.name, n=1 if legacy else 2)
        if prims_out is not None:
            launched(epilogues=("primitives",))
        return fac


step_factor = StepFactor()
