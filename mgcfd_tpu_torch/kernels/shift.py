"""shift: the span-decomposed flux of box-class meshes — the CUDA kernels
csrc/shift_flux.cu (flux and rw modes) and csrc/shift_fused_stage.cu,
their wrappers and their plain PyTorch versions.

Replace mgcfd_tpu/pallas/flux_shift.py::_kernel (both modes) and
::_fused_kernel. For node i and each span d of the plan, in plan order,
    acc = (acc + val_d(i)) - val_d(i - d),
    val_d(j) = edge(q[j], q[j + d], w_d[j]),
where an endpoint outside [0, N) is quiescent gas (rho = 1, momentum 0,
E = 1) with zero weight, as the TPU kernel masks its lanes (the plain
versions below spell this out). The flux kernel unrolls the span loop
of short plans and in rw mode gives each (node, channel) a thread on
thin levels; launch_shape below mirrors its C entry point's choice. The
fused stage's kernel tiles the nodes and shares their states through
shared memory; span_schedule below sorts a plan's spans for it. The
wrappers launch the kernels for CUDA tensors and take the plain versions
only for tensors on the CPU; anything else raises. Each role has its own
wrapper instance with its own launch count (``launches``): ``flux``,
``rw`` and ``fused_stage``.

At bfloat16 (flux_shift.py:163-201 and :397-431) the kernels and their
plain versions load bf16, compute in float32 and round once on store;
the fused stage's invalid count is taken on the float32 values. The fused
stage adds its count into an int64 counter and carries fused_stage's
epilogues (kernels/fused_stage.py stage_outputs): the count into the
caller's counter and the residual.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..prep.shift import ShiftPlan
from . import build, edge_csr
from .edge_csr import (FULL_LEVEL, STORAGE_DTYPES, THIN_BELOW, complete8,
                       compute_dtype, flux_math, pointer)
from .fused_stage import (bw_flux, check_count, count_epilogues,
                          new_count, stage_outputs)

MAX_SPANS = 16   # kMaxSpans in csrc/shift_common.cuh
MODES = {"flux": 0, "rw": 1}

# the fused stage's tiling (csrc/shift_fused_stage.cu)
TILE_NODES = 256      # B = kThreads: nodes per tile, one a thread
MAX_HALO = 128        # kMaxHalo: the longest span kept in the halo
HALO_ALIGN = 8        # H is a multiple of 8, so vector loads stay aligned
# steps per chunk M aim at this many blocks: at fp32 and bf16 (5 blocks
# fit on each of the 132 SMs) M = 2 on the box flagship's level 0, at fp64
# (3 fit) M = 1, the fastest of M = 1, 2, 4, 8 on the H100 when the
# kernel was designed
TARGET_BLOCKS = {torch.float32: 528, torch.bfloat16: 528,
                 torch.float64: 1056}
HALO, MARCHED, DIRECT = 0, 1, 2   # span kinds (SpanKind)

# the flux kernel's launch shape (csrc/shift_flux.cu choose_shape)
MAX_UNROLLED = 4        # kMaxUnrolled: plans of at most this many spans
CHANNEL_LANES = 64      # kChannelLanes (csrc/csr_common.cuh)


@dataclasses.dataclass(frozen=True)
class FluxShape:
    """How the flux kernel covers N nodes: one node a thread, or in rw
    mode with ``split`` one (node, channel) a thread; with ``unroll`` the
    span loop unrolled (plans of at most MAX_UNROLLED spans)."""

    split: bool
    unroll: bool


def launch_shape(mode: str, dtype: torch.dtype, num_nodes: int,
                 num_spans: int) -> FluxShape:
    """The flux kernel's shape for N nodes of a storage dtype and a plan
    of num_spans spans: rw mode splits the channels below THIN_BELOW
    nodes; the span loop is unrolled for plans of at most MAX_UNROLLED
    spans, but not in rw mode at fp64 from FULL_LEVEL nodes on. The
    mirror of the C entry point's choose_shape."""
    rw = mode == "rw"
    full64 = dtype == torch.float64 and num_nodes >= FULL_LEVEL
    return FluxShape(split=rw and num_nodes < THIN_BELOW,
                     unroll=num_spans <= MAX_UNROLLED and not (rw and full64))


@dataclasses.dataclass(frozen=True)
class SpanSchedule:
    """How the fused stage tiles a plan of spans over N nodes.

    Each span in plan order is HALO (d <= MAX_HALO: its values are
    evaluated once per tile from the shared-memory window), MARCHED (the
    longest span above MAX_HALO: the tiles of a pencil step along it and
    carry its values) or DIRECT (any other: evaluated from both endpoints).
    Block b owns pencil b % pencils, the nodes [r0, r0 + TILE_NODES) of
    [0, stride) with r0 = pencil * TILE_NODES, and the steps [c * chunk,
    (c + 1) * chunk) with c = b // pencils; step s covers the nodes
    r0 + s * stride + t for t < min(TILE_NODES, stride - r0)."""

    kinds: tuple
    halo: int        # H: the window reaches H nodes beyond the tile
    stride: int      # the marched span, else TILE_NODES
    pencils: int
    steps: int
    chunk: int       # M, steps per block

    @property
    def blocks(self) -> int:
        return self.pencils * -(-self.steps // self.chunk)


def span_schedule(deltas, num_nodes: int,
                  dtype=torch.float32) -> SpanSchedule:
    """The fused stage's tiling of a plan in a storage dtype (the C entry
    point checks it and derives stride, pencils and steps the same
    way)."""
    deltas = [int(d) for d in deltas]
    long = [k for k, d in enumerate(deltas) if d > MAX_HALO]
    march = max(long, key=lambda k: deltas[k]) if long else None
    kinds = tuple(HALO if d <= MAX_HALO else MARCHED if k == march
                  else DIRECT for k, d in enumerate(deltas))
    short = [d for d in deltas if d <= MAX_HALO]
    halo = -(-max(short, default=0) // HALO_ALIGN) * HALO_ALIGN
    stride = deltas[march] if march is not None else TILE_NODES
    pencils = -(-stride // TILE_NODES)
    steps = -(-num_nodes // stride)
    chunk = 1
    if march is not None:
        chunk = max(1, pencils * steps // TARGET_BLOCKS[dtype])
    return SpanSchedule(kinds=kinds, halo=halo, stride=stride,
                        pencils=pencils, steps=steps, chunk=chunk)


@dataclasses.dataclass
class DeviceShift:
    """A ShiftPlan's spans on a device: weights (D, 4, N), rows wx, wy,
    wz and |w| (computed in fp64 on the host, then cast), zero where a
    row has no edge."""

    num_nodes: int
    deltas: tuple
    w: torch.Tensor
    schedule: SpanSchedule = dataclasses.field(init=False)

    def __post_init__(self):
        self.schedule = span_schedule(self.deltas, self.num_nodes,
                                      self.w.dtype)

    @classmethod
    def from_plan(cls, plan: ShiftPlan, num_nodes: int, device,
                  dtype) -> "DeviceShift":
        if len(plan.deltas) > MAX_SPANS:
            raise ValueError(f"{len(plan.deltas)} spans; the kernels take "
                             f"at most {MAX_SPANS}")
        w = np.zeros((len(plan.deltas), 4, num_nodes))
        for i, wd in enumerate(plan.weights):
            w[i, :3, :wd.shape[0]] = wd.T
            w[i, 3, :wd.shape[0]] = np.sqrt((wd * wd).sum(axis=1))
        return cls(num_nodes=num_nodes,
                   deltas=tuple(int(d) for d in plan.deltas),
                   w=torch.as_tensor(w).to(device=device, dtype=dtype))


def _quiescent(n: int, like: torch.Tensor) -> torch.Tensor:
    q = torch.zeros((5, n), dtype=like.dtype, device=like.device)
    q[0] = 1.0
    q[4] = 1.0
    return q


def edge_values(mode: str, qa, qb, w):
    """(5, L) edge values of rows with a-states qa, b-states qb and
    weights w (4, L): flux_shift._edge_val_ch or, in rw mode,
    _edge_val_rw."""
    if mode == "rw":
        return (qa + qb) + ((w[0] + w[1]) + w[2])
    return flux_math(complete8(qa), complete8(qb), w[0], w[1], w[2], w[3])


def shift_plain(mode: str, sh: DeviceShift, q):
    """What the flux and rw modes compute, one span at a time, in
    compute_dtype(q.dtype), rounded once to q.dtype."""
    return span_sums(mode, sh, q).to(q.dtype)


def span_sums(mode: str, sh: DeviceShift, q):
    """shift_plain before its final rounding: in compute_dtype."""
    c = compute_dtype(q.dtype)
    q = q.to(c)
    w = sh.w.to(c)
    n = q.shape[1]
    acc = torch.zeros_like(q)
    for k, d in enumerate(sh.deltas):
        quiet = _quiescent(d, q)
        # val_d(j) for j in [0, N): b-endpoint j + d, quiescent past N-1
        val = edge_values(mode, q, torch.cat([q[:, d:], quiet], dim=1),
                          w[k])
        # val_d(j) for j in [-d, 0): quiescent a-endpoint, zero weight
        low = edge_values(mode, quiet, q[:, :d], torch.zeros(
            (4, d), dtype=q.dtype, device=q.device))
        acc = acc + val
        acc = acc - torch.cat([low, val[:, :n - d]], dim=1)
    return acc


def shift_fused_stage_plain(sh: DeviceShift, nc, q, old, fac, spill=None,
                            count=None, residual: bool = False):
    """What the fused kernel computes, as stage_outputs gives it."""
    c = compute_dtype(q.dtype)
    acc = span_sums("flux", sh, q) + bw_flux(complete8(q.to(c)), nc.to(c))
    if spill is not None:
        acc = acc + spill.to(c)
    qnew = old.to(c) + fac.to(c) * acc
    return stage_outputs(qnew, old, count, residual)


def _check(sh: DeviceShift, q, name: str) -> None:
    if q.dtype not in STORAGE_DTYPES or q.dtype != sh.w.dtype:
        raise TypeError(f"{name}: dtype {q.dtype} with weights "
                        f"{sh.w.dtype}; float32, float64 or bfloat16, "
                        "matching")
    n = sh.num_nodes
    if tuple(q.shape) != (5, n) or not q.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (5, {n}) state, got "
                         f"{tuple(q.shape)}")
    if sh.w.device != q.device:
        raise ValueError(f"{name}: weights and state on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def _c_int64s(values):
    return (ctypes.c_int64 * max(1, len(values)))(*values)


class ShiftFlux:
    """The shift_flux kernel in one mode, for one role on the path."""

    def __init__(self, name: str, mode: str):
        self.name = name
        self.mode = mode
        self.launches = 0

    def __call__(self, sh: DeviceShift, q: torch.Tensor) -> torch.Tensor:
        """(5, N) state -> (5, N) internal flux (or its rw twin), at the
        shape the C entry point picks."""
        return self._launch(sh, q, None)

    def at(self, sh: DeviceShift, q: torch.Tensor,
           shape: FluxShape) -> torch.Tensor:
        """The same at a given shape, for timing shapes (the arrays must
        take it)."""
        return self._launch(sh, q, shape)

    def _launch(self, sh, q, shape):
        _check(sh, q, self.name)
        if not edge_csr._on_card(q):
            return shift_plain(self.mode, sh, q)
        out = torch.empty_like(q)
        deltas = _c_int64s(sh.deltas)
        lib = build.library()
        operands = (ctypes.addressof(deltas), len(sh.deltas),
                    sh.w.data_ptr(), q.data_ptr(), out.data_ptr(),
                    sh.num_nodes,
                    torch.cuda.current_stream(q.device).cuda_stream)
        if shape is None:
            rc = lib.mgcfd_shift_flux(build.dtype_code(q), MODES[self.mode],
                                      *operands)
        else:
            rc = lib.mgcfd_shift_flux_at(build.dtype_code(q),
                                         MODES[self.mode], int(shape.split),
                                         int(shape.unroll), *operands)
        build.check(rc, self.name)
        self.launches += 1
        return out

    def shape(self, sh: DeviceShift) -> FluxShape:
        """The shape the C entry point picks for this plan; launches
        nothing."""
        got = (ctypes.c_int64 * 2)()
        rc = build.library().mgcfd_shift_flux_shape(
            build.DTYPE_CODES[sh.w.dtype], MODES[self.mode], sh.num_nodes,
            len(sh.deltas), ctypes.addressof(got))
        build.check(rc, self.name)
        return FluxShape(split=bool(got[0]), unroll=bool(got[1]))


class ShiftFusedStage:
    """The shift_fused_stage kernel; ``launches`` counts kernel launches."""

    def __init__(self, name: str = "shift.fused_stage"):
        self.name = name
        self.launches = 0

    def __call__(self, sh: DeviceShift, nc, q, old, fac, spill=None,
                 count=None, residual: bool = False):
        """q, old: (5, N); nc: (11, N); fac: (N,) = step factor /
        (RK + 1 - j); spill: (5, N) flux of the plan's spill edges, or
        None; count and residual as fused_stage's. Returns (q_next,
        count), with residual also q_next - old."""
        _check(sh, q, self.name)
        n = sh.num_nodes
        operands = [("old", old, (5, n)), ("nc", nc, (11, n)),
                    ("fac", fac, (n,))]
        if spill is not None:
            operands.append(("spill", spill, (5, n)))
        for what, t, shape in operands:
            if tuple(t.shape) != shape or t.dtype != q.dtype or \
                    t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{self.name}: {what} must be a contiguous "
                                 f"{shape} {q.dtype} tensor on {q.device}")
        check_count(count, q, self.name)
        if not edge_csr._on_card(q):
            return shift_fused_stage_plain(sh, nc, q, old, fac, spill, count,
                                           residual)
        out = torch.empty_like(q)
        res = torch.empty_like(q) if residual else None
        total = count if count is not None else new_count(q.device)
        deltas, sched = _c_int64s(sh.deltas), sh.schedule
        kinds = _c_int64s(sched.kinds)
        rc = build.library().mgcfd_shift_fused_stage(
            build.dtype_code(q), ctypes.addressof(deltas),
            ctypes.addressof(kinds), len(sh.deltas), sched.halo,
            sched.chunk, sh.w.data_ptr(), q.data_ptr(), old.data_ptr(),
            fac.data_ptr(), nc.data_ptr(), pointer(spill), out.data_ptr(),
            pointer(res), total.data_ptr(), n,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(rc, self.name)
        self.launches += 1
        count_epilogues(count, residual)
        return (out, total, res) if residual else (out, total)


flux = ShiftFlux("shift.flux", "flux")
rw = ShiftFlux("shift.rw", "rw")
fused_stage = ShiftFusedStage()
