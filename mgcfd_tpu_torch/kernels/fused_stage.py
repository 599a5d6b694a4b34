"""fused_stage: one whole RK stage per launch — the CUDA kernel
csrc/fused_stage.cu, its wrapper and its plain PyTorch version.

Replaces mgcfd_tpu/pallas/flux_window.py::_window_fused_kernel. Per node:
the internal-edge flux over its CSR row, plus the boundary + wall flux
from the aggregated normals, which the kernel takes compacted to the nodes
with a boundary or wall face (kernels/boundary.py BoundaryRows), then out
= old + fac * flux,
plus the count of NaN/Inf/negative density or energy, added into an
int64 counter of one element: the caller's (the solver's cycle count),
else a new zero. The wrapper
launches the kernel for CUDA tensors and takes the plain version only for
tensors on the CPU. At bfloat16 (flux_window.py:382-413) every operand is
loaded as bf16, the stage is computed in float32, the new state rounded
once on store, and the invalid count taken on the float32 values.

Two epilogues, which this kernel and shift.fused_stage share (see
stage_outputs): the count added into the caller's counter, and, for the
last RK stage, the residual q_next - old from the stored values. Each
launch that carries one is counted under epilogue.invalid or
epilogue.residual (stage_epilogues).

The kernel completes each tile's own nodes once, in shared memory, and any
other neighbour again from device memory: tile_local_entries counts a
CSR's entries of the first kind.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build, edge_csr
from .boundary import as_dense, check_rows
from .counts import launched
from .edge_csr import DeviceCSR, complete8, compute_dtype, pointer


def bw_flux(qo, nc):
    """Boundary + wall flux from the owner's completed state and nc
    (flux_window._bw_flux_ch; rows 0:3 summed boundary normals, 3:6
    summed wall normals, 6:11 the far-field wall constant)."""
    _rho, mx, my, mz, E, p, _s, inv = qo
    vx, vy, vz = mx * inv, my * inv, mz * inv
    bx, by, bz = nc[0], nc[1], nc[2]
    hx, hy, hz = 0.5 * nc[3], 0.5 * nc[4], 0.5 * nc[5]
    de_p = E + p
    return torch.stack([
        hx * mx + hy * my + hz * mz + nc[6],
        bx * p + hx * (vx * mx + p) + hy * (vx * my) + hz * (vx * mz)
        + nc[7],
        by * p + hx * (vy * mx) + hy * (vy * my + p) + hz * (vy * mz)
        + nc[8],
        bz * p + hx * (vz * mx) + hy * (vz * my) + hz * (vz * mz + p)
        + nc[9],
        hx * (vx * de_p) + hy * (vy * de_p) + hz * (vz * de_p) + nc[10],
    ])


def fused_stage_plain(csr: DeviceCSR, nc, q, old, fac, count=None,
                      residual: bool = False):
    """What the kernel computes, as stage_outputs gives it; nc the
    BoundaryRows or the dense (11, N) operand."""
    c = compute_dtype(q.dtype)
    acc = edge_csr.row_sums("flux", csr, q)
    qc = q.to(c)
    qnew = old.to(c) + fac.to(c) * (acc + bw_flux(complete8(qc),
                                                  as_dense(nc).to(c)))
    return stage_outputs(qnew, old, count, residual)


def stage_outputs(qnew, old, count=None, residual: bool = False):
    """What the two fused stages store of the new state qnew (in the
    compute type): (q_next, count), q_next rounded once to old's dtype and
    its invalid count added into count, an int64 counter of one element
    (a new zero where it is None); with residual also res = q_next - old,
    taken from the stored values and rounded once, the bits of the eager
    q_next - old, as a third value."""
    out = qnew.to(old.dtype)
    if count is None:
        count = new_count(old.device)
    count.add_(invalid_count(qnew))
    if not residual:
        return out, count
    return out, count, (out.to(qnew.dtype) - old.to(qnew.dtype)).to(
        old.dtype)


def tile_local_entries(plan) -> int:
    """The entries of an owner CSR (a CSRPlan) whose column lies in its
    owner row's tile of FLUX_TILE_ROWS rows: the neighbours the kernel
    reads from the nodes its block completed in shared memory."""
    rows = edge_csr.FLUX_TILE_ROWS
    return int(np.count_nonzero(plan.col // rows == plan.owner // rows))


def new_count(device):
    """A fused stage's counter where its caller keeps none: an int64
    zero of one element."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def check_count(count, q, name: str) -> None:
    """Raise unless count is an int64 counter of one element beside q."""
    if count is not None and (count.dtype != torch.int64
                              or count.numel() != 1
                              or count.device != q.device
                              or not count.is_contiguous()):
        raise ValueError(f"{name}: count must be a contiguous int64 tensor "
                         f"of one element on {q.device}")


def stage_epilogues(count, residual: bool) -> list:
    """The epilogues a fused stage's launch carried: the count into its
    caller's counter, the residual."""
    return [name for name, on in (("invalid", count is not None),
                                  ("residual", residual)) if on]


def invalid_count(q):
    """Count of NaN/Inf anywhere and of negative density or energy in a
    (5, N) state, as a 0-d int32 (validation.cpp:107-138)."""
    bad = ((~torch.isfinite(q)).sum() + (q[0] < 0).sum()
           + (q[4] < 0).sum())
    return bad.to(torch.int32)


class FusedStage:
    """The fused_stage kernel."""

    def __init__(self, name: str = "fused_stage"):
        self.name = name

    def __call__(self, csr: DeviceCSR, bnd, q, old, fac, count=None,
                 residual: bool = False):
        """q, old: (5, N); bnd: the BoundaryRows of the level's aggregated
        normals (kernels/boundary.py); fac: (N,) = step factor /
        (RK + 1 - j); count: the int64 counter of one element that the
        kernel adds the invalid count into, or None for a new zero.
        Returns (q_next, count), with residual also q_next - old (see
        stage_outputs)."""
        if csr.num_cols != csr.num_rows:
            raise ValueError("fused_stage: owner and neighbour spaces "
                             "must coincide")
        edge_csr.check_operands(csr, q, "flux")
        n = csr.num_rows
        for name, t, shape in (("old", old, (5, n)), ("fac", fac, (n,))):
            if tuple(t.shape) != shape or t.dtype != q.dtype or \
                    t.device != q.device or not t.is_contiguous():
                raise ValueError(f"fused_stage: {name} must be a contiguous "
                                 f"{shape} {q.dtype} tensor on {q.device}")
        check_rows(bnd, q, n, self.name)
        check_count(count, q, self.name)
        if not edge_csr._on_card(q):
            return fused_stage_plain(csr, bnd, q, old, fac, count, residual)
        out = torch.empty_like(q)
        res = torch.empty_like(q) if residual else None
        total = count if count is not None else new_count(q.device)
        rc = build.library().mgcfd_fused_stage(
            build.dtype_code(q), csr.row_ptr.data_ptr(),
            csr.col.data_ptr(), csr.w.data_ptr(), csr.num_entries,
            q.data_ptr(), old.data_ptr(), fac.data_ptr(),
            bnd.mask.data_ptr(), bnd.rank.data_ptr(), bnd.vals.data_ptr(),
            bnd.stored, out.data_ptr(), pointer(res), total.data_ptr(), n,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, self.name)
        launched(self.name, epilogues=stage_epilogues(count, residual))
        return (out, total, res) if residual else (out, total)


fused_stage = FusedStage()
