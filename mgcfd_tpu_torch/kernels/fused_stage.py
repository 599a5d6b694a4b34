"""fused_stage: one whole RK stage per launch — the CUDA kernel
csrc/fused_stage.cu, its wrapper and its plain PyTorch version.

Replaces mgcfd_tpu/pallas/flux_window.py::_window_fused_kernel. Per node:
the internal-edge flux over its CSR row, plus the dense boundary + wall
flux from the aggregated normals nc (11, N), then out = old + fac * flux,
plus the count of NaN/Inf/negative density or energy. The wrapper
launches the kernel for CUDA tensors and takes the plain version only for
tensors on the CPU. At bfloat16 (flux_window.py:382-413) every operand is
loaded as bf16, the stage is computed in float32, the new state rounded
once on store, and the invalid count taken on the float32 values.
"""
from __future__ import annotations

import torch

from . import build, edge_csr
from .edge_csr import DeviceCSR, complete8, compute_dtype


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


def fused_stage_plain(csr: DeviceCSR, nc, q, old, fac):
    """What the kernel computes: (q_next (5, N), invalid count int32)."""
    c = compute_dtype(q.dtype)
    acc = edge_csr.row_sums("flux", csr, q)
    qc = q.to(c)
    qnew = old.to(c) + fac.to(c) * (acc + bw_flux(complete8(qc), nc.to(c)))
    return qnew.to(q.dtype), invalid_count(qnew)


def invalid_count(q):
    """Count of NaN/Inf anywhere and of negative density or energy in a
    (5, N) state, as a 0-d int32 (validation.cpp:107-138)."""
    bad = ((~torch.isfinite(q)).sum() + (q[0] < 0).sum()
           + (q[4] < 0).sum())
    return bad.to(torch.int32)


class FusedStage:
    """The fused_stage kernel; ``launches`` counts kernel launches."""

    def __init__(self, name: str = "fused_stage"):
        self.name = name
        self.launches = 0

    def __call__(self, csr: DeviceCSR, nc, q, old, fac):
        """q, old: (5, N); nc: (11, N); fac: (N,) = step factor /
        (RK + 1 - j). Returns (q_next, invalid count as a 0-d int32)."""
        if csr.num_cols != csr.num_rows:
            raise ValueError("fused_stage: owner and neighbour spaces "
                             "must coincide")
        edge_csr.check_operands(csr, q, "flux")
        n = csr.num_rows
        for name, t, shape in (("old", old, (5, n)), ("nc", nc, (11, n)),
                               ("fac", fac, (n,))):
            if tuple(t.shape) != shape or t.dtype != q.dtype or \
                    t.device != q.device or not t.is_contiguous():
                raise ValueError(f"fused_stage: {name} must be a contiguous "
                                 f"{shape} {q.dtype} tensor on {q.device}")
        if not edge_csr._on_card(q):
            return fused_stage_plain(csr, nc, q, old, fac)
        out = torch.empty_like(q)
        invalid = torch.zeros(1, dtype=torch.int32, device=q.device)
        rc = build.library().mgcfd_fused_stage(
            build.dtype_code(q), csr.row_ptr.data_ptr(),
            csr.col.data_ptr(), csr.w.data_ptr(), csr.num_entries,
            q.data_ptr(), old.data_ptr(), fac.data_ptr(), nc.data_ptr(),
            out.data_ptr(), invalid.data_ptr(), n,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, self.name)
        self.launches += 1
        return out, invalid[0]


fused_stage = FusedStage()
