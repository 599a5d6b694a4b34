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
CSR's entries of the first kind. Where the caller gives it prims_in, the
state's stored primitives (primitives: 1/rho and speed + speed of sound,
a (2, N) operand in the compute type), it gathers those two values of
every node instead of a divide and two square roots; where it gives it
prims_out, it stores the new state's, for the next stage. Both give the
bits of the kernel without them. The solver gives them on the levels
whose neighbours lie close enough for the two more loads an entry to
cost less than the completion (gathers_primitives). A launch that stored
them is counted under epilogue.primitives, one that gathered them under
primitives.gathered.
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
                      residual: bool = False, prims_in=None, prims_out=None):
    """What the kernel computes, as stage_outputs gives it; nc the
    BoundaryRows or the dense (11, N) operand; q's primitives gathered
    from prims_in where it is given, the new state's stored into
    prims_out where it is."""
    c = compute_dtype(q.dtype)
    acc = edge_csr.row_sums("flux", csr, q, prims=prims_in)
    qc = q.to(c)
    qnew = old.to(c) + fac.to(c) * (acc + bw_flux(complete8(qc, prims_in),
                                                  as_dense(nc).to(c)))
    out = stage_outputs(qnew, old, count, residual)
    if prims_out is not None:
        prims_out.copy_(primitives(out[0]))
    return out


def primitives(q):
    """The stored primitives of a (5, N) state: (2, N) in the compute
    type, row 0 each node's 1/rho and row 1 its speed + speed of sound,
    as complete8 gives them from the stored values."""
    p = complete8(q.to(compute_dtype(q.dtype)))
    return torch.stack([p[7], p[6]])


def check_primitives(prims, q, name: str, what: str) -> None:
    """Raise unless prims is None or a contiguous (2, N) operand of q's
    compute type beside the (5, N) state q."""
    shape = (2, q.shape[1])
    if prims is not None and (
            tuple(prims.shape) != shape
            or prims.dtype != compute_dtype(q.dtype)
            or prims.device != q.device or not prims.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous {shape} "
                         f"{compute_dtype(q.dtype)} tensor on {q.device}")


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


# a level's fused stages gather the stored primitives where a load of
# their flux phase touches at most GATHER_SECTORS_MAX[dtype] sectors on
# average (gather_sectors), or where the level's state and primitives
# take at most GATHER_FOOTPRINT_MAX bytes. Each entry then loads two more
# rows; on a level whose neighbours scatter those loads cost more than
# the divide and the two square roots they save, unless the level is
# small (a few thousand nodes, which the caches hold). Chosen on the H100
# from kernel_ab.py's visit rows (one visit, the step factor and three
# stages) on the levels of M6's RCM hierarchy at 1x and 8x and of the RCM
# tet, at each storage dtype. Each sector limit lies between the levels
# that gained and those that lost, levels within the footprint aside:
#   float32: 6.4, 10.5 and 12.8 sectors 4-8 % faster; 19.9, 22.8 and
#     28.6 2-25 % slower;
#   bfloat16 (a state half as wide, so the two loads weigh more): 6.4
#     3.5 % faster at 8x and 1 % slower at 1x, 10.5 2 % slower, 12.8
#     within 1 %, 19.9 and above 6-30 % slower;
#   float64 (4 nodes a sector): 8.9 2-3 % faster, 12.7 1 % slower, 17.1
#     within 0.3 %, 23.7 and above 7-20 % slower.
# Every level within the footprint ran faster at every dtype: the tet's
# levels 2 and 3 (4,896 and 648 nodes, 12-274 KB; 21.6 and 8.2 sectors
# at fp32), 3-10 %; the smallest level that lost holds 81,180 nodes (1.5
# MB at bf16).
GATHER_SECTORS_MAX = {torch.float32: 16.0, torch.bfloat16: 9.0,
                      torch.float64: 11.0}
GATHER_FOOTPRINT_MAX = 512 * 1024


def gathers_primitives(csr: DeviceCSR) -> bool:
    """Whether a level's fused stages gather the stored primitives on its
    owner CSR (GATHER_SECTORS_MAX, GATHER_FOOTPRINT_MAX)."""
    return gather_footprint(csr) <= GATHER_FOOTPRINT_MAX or \
        gather_sectors(csr) <= GATHER_SECTORS_MAX[csr.w.dtype]


def gather_footprint(csr: DeviceCSR) -> int:
    """Bytes of the (5, N) state and the (2, N) primitives that a level's
    flux phase gathers from."""
    return csr.num_cols * (5 * csr.w.element_size()
                           + 2 * compute_dtype(csr.w.dtype).itemsize)


def primitive_buffers(num_nodes: int, dtype, device) -> tuple:
    """A level's two ping-pong (2, N) buffers of stored primitives, in
    the compute type of the storage dtype: each stage gathers from one
    what the launch before it stored and stores into the other."""
    return tuple(torch.zeros((2, num_nodes), dtype=compute_dtype(dtype),
                             device=device) for _ in range(2))


def gather_sectors(csr: DeviceCSR) -> float:
    """The mean number of distinct 32-byte sectors of a compute-type row
    that one load of the flux phase touches: each warp evaluates 32
    consecutive entries at a time, and the neighbours outside their
    owner's tile (read from device memory) fall into this many sectors
    of each row it loads, from 1 (neighbours side by side) to 32
    (scattered)."""
    warp = 32
    nodes = 32 // compute_dtype(csr.w.dtype).itemsize
    rows = edge_csr.FLUX_TILE_ROWS
    col = csr.col.long()
    sector = torch.where(col // rows == csr.owner // rows, -1, col // nodes)
    sector = torch.nn.functional.pad(sector, (0, -len(sector) % warp),
                                     value=-1).view(-1, warp)
    s = sector.sort(dim=1).values
    distinct = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum(1) \
        + (s[:, 0] >= 0)
    return float(distinct.double().mean()) if len(s) else 0.0


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


def stage_epilogues(count, residual: bool, prims_out=None) -> list:
    """The epilogues a fused stage's launch carried: the count into its
    caller's counter, the residual, the new state's primitives."""
    return [name for name, on in (("invalid", count is not None),
                                  ("residual", residual),
                                  ("primitives", prims_out is not None))
            if on]


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
                 residual: bool = False, prims_in=None, prims_out=None):
        """q, old: (5, N); bnd: the BoundaryRows of the level's aggregated
        normals (kernels/boundary.py); fac: (N,) = step factor /
        (RK + 1 - j); count: the int64 counter of one element that the
        kernel adds the invalid count into, or None for a new zero;
        prims_in: q's stored primitives (primitives), or None to complete
        every node; prims_out: a (2, N) buffer, not prims_in, that takes
        q_next's, or None. Returns (q_next, count), with residual also
        q_next - old (see stage_outputs)."""
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
        check_primitives(prims_in, q, self.name, "prims_in")
        check_primitives(prims_out, q, self.name, "prims_out")
        if prims_in is not None and prims_out is not None and \
                prims_in.data_ptr() == prims_out.data_ptr():
            raise ValueError(f"{self.name}: prims_out must not be the "
                             "buffer prims_in, which the launch reads")
        if not edge_csr._on_card(q):
            return fused_stage_plain(csr, bnd, q, old, fac, count, residual,
                                     prims_in, prims_out)
        out = torch.empty_like(q)
        res = torch.empty_like(q) if residual else None
        total = count if count is not None else new_count(q.device)
        rc = build.library().mgcfd_fused_stage(
            build.dtype_code(q), csr.row_ptr.data_ptr(),
            csr.col.data_ptr(), csr.w.data_ptr(), csr.num_entries,
            q.data_ptr(), old.data_ptr(), fac.data_ptr(),
            bnd.mask.data_ptr(), bnd.rank.data_ptr(), bnd.vals.data_ptr(),
            bnd.stored, out.data_ptr(), pointer(res), total.data_ptr(),
            pointer(prims_in), pointer(prims_out), n,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, self.name)
        launched(self.name,
                 epilogues=stage_epilogues(count, residual, prims_out),
                 gathered=("primitives",) if prims_in is not None else ())
        return (out, total, res) if residual else (out, total)


fused_stage = FusedStage()
