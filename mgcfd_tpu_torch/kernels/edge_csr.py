"""edge_csr: owner-sorted half-edge sums in three modes — the CUDA kernel
csrc/edge_csr.cu, its wrapper and its plain PyTorch version.

Replaces mgcfd_tpu/pallas/flux_window.py::_window_kernel (flux, rw and
wsum modes). In wsum mode the kernel gives each (row, channel) or each
row a thread and loads a row's entries plain, chunked or batched; in rw
mode it gives each row a thread, or takes a tile's entries or a row's
with neighbouring lanes; in flux mode it gives each row a thread, or takes
a tile's entries with the tile's rows completed once in shared memory; the
C entry point chooses the shape for the CSR, and wsum_shape, rw_shape and
flux_shape below mirror that.
The wrapper launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU; anything else raises.
Each role on the solver's path has its own wrapper instance, whose
launches are counted under its name (kernels/counts.py): ``flux``,
``rw``, ``restrict`` and ``prolong``. Each launch is also counted under
the shape the C entry point chose, ``<wrapper>.<shape>`` (e.g.
``edge_csr.rw.tile``); the shape is asked of the entry point once per
CSR, at the wrapper's first launch on it.

In flux and rw modes the neighbour space may be wider than the owner
space, with the owners its first num_rows columns: the sharded solver's
[block | separator pool] operand (parallel/sharded.py). The owners' values
then come as a (5, num_rows) operand of their own (``own``).

In wsum mode the kernel's store carries the MG transfers' updates where
the caller hands it their operands (wsum_tail): ``keep``, the coarse
state that rows with no entries store (the restriction's unmapped coarse
nodes), and ``correct`` = (base, res), the store base + (res - sum) (the
prolongation's update of the fine state). Each launch that carries one
is counted under epilogue.restrict or epilogue.prolong.

The state and weights are float32, float64 or bfloat16. bfloat16 is a
storage format, as in the TPU kernel's bf16 branch
(flux_window.py:254-296): the kernel and its plain version load bf16,
compute in float32 and round once, to nearest even, on store.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.constants import GAMMA, SMOOTHING_COEFFICIENT
from ..prep.csr import CSRPlan
from . import build
from .counts import launched

MODES = {"flux": 0, "rw": 1, "wsum": 2}
# levels below THIN_BELOW nodes or rows get a thread per (node or row,
# channel); at fp64 levels of FULL_LEVEL or more skip the extra loads in
# flight (csrc/csr_common.cuh kThinBelow, kFullLevel)
THIN_BELOW = 16384
FULL_LEVEL = 131072
# how a wsum thread loads its row's entries (csrc/edge_csr.cu WsumLoads)
PLAIN, CHUNKED, BATCHED = 0, 1, 2
CHUNK = 4   # kChunk
# rw mode's shapes (csrc/edge_csr.cu RwShape): a thread per row; a block
# per 256-row tile; groups of 8 lanes a row, one or two entries a lane per
# pass
RW_ROW, RW_TILE, RW_GROUP8, RW_GROUP8X2 = range(4)
RW_SHAPES = {RW_ROW: "row", RW_TILE: "tile", RW_GROUP8: "group8",
             RW_GROUP8X2: "group8x2"}
# rows of RW_LONG_ROW entries or more on average take a long-row shape
RW_LONG_ROW = 10   # kRwLongRow
# the tile's rows (kThreads) and the lane groups' (lanes a row, entries a
# lane per pass)
RW_TILE_ROWS = 256
RW_GROUPS = {RW_GROUP8: (8, 1), RW_GROUP8X2: (8, 2)}
# flux mode's shapes (csrc/edge_csr.cu FluxShape): a thread per row; a
# block per tile of FLUX_TILE_ROWS rows (csrc/csr_tile.cuh kTileRows, the
# fused stage's tiles too)
FLUX_ROW, FLUX_TILE = range(2)
FLUX_SHAPES = {FLUX_ROW: "row", FLUX_TILE: "tile"}
FLUX_TILE_ROWS = 128
# levels from THIN_BELOW up to FLUX_MID_LEVEL rows of long rows take the
# row kernel at fp32 and bf16 (kFluxMidLevel)
FLUX_MID_LEVEL = 65536
# a wsum shape's name: how its threads load a row's entries
WSUM_LOADS = {PLAIN: "plain", CHUNKED: "chunked", BATCHED: "batched"}
_MIN_WEIGHT_ROWS = {"flux": 4, "rw": 3, "wsum": 1}


@dataclasses.dataclass
class DeviceCSR:
    """A CSRPlan on a device: row_ptr and col int32 for the kernel, the
    per-entry owner int64 for the plain version, weights (K, H)."""

    num_rows: int
    num_cols: int
    row_ptr: torch.Tensor
    col: torch.Tensor
    owner: torch.Tensor
    w: torch.Tensor
    # wrapper name -> the counter its launches on this CSR add to, from
    # the shape the C entry point chose (EdgeCSR.counter)
    counters: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @property
    def num_entries(self) -> int:
        return int(self.col.shape[0])

    @classmethod
    def from_plan(cls, plan: CSRPlan, device, dtype) -> "DeviceCSR":
        if plan.num_entries >= 2 ** 31:
            raise ValueError("CSR too large for int32 indices")

        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        return cls(num_rows=plan.num_rows, num_cols=plan.num_cols,
                   row_ptr=put(plan.row_ptr, torch.int32),
                   col=put(plan.col, torch.int32),
                   owner=put(plan.owner, torch.int64),
                   w=put(plan.w, dtype))


@dataclasses.dataclass(frozen=True)
class WsumShape:
    """How the wsum kernel covers a CSR: a thread per (row, channel) with
    ``split``, else per row; ``loads`` PLAIN, CHUNKED or BATCHED."""

    split: bool
    loads: int


def wsum_shape(num_rows: int, num_entries: int,
               dtype: torch.dtype) -> WsumShape:
    """The wsum kernel's shape: long rows (mean CHUNK entries or more, the
    restriction) per (row, channel) with chunked loads; short rows (the
    prolongation) batched, per (row, channel) below THIN_BELOW rows, and at
    fp64 from FULL_LEVEL rows on per row with plain loads. The mirror of
    the C entry point's choose_wsum."""
    if num_entries >= CHUNK * num_rows:
        return WsumShape(split=True, loads=CHUNKED)
    full64 = dtype == torch.float64 and num_rows >= FULL_LEVEL
    return WsumShape(split=num_rows < THIN_BELOW,
                     loads=PLAIN if full64 else BATCHED)


def rw_shape(num_rows: int, num_entries: int, dtype: torch.dtype) -> int:
    """The rw kernel's shape: below THIN_BELOW rows lane groups, two
    entries a lane on long rows (RW_LONG_ROW entries or more on average,
    the tet's); from FULL_LEVEL rows on the tile for long rows, and at
    fp64 for any; else a thread per row. The mirror of the C entry point's
    choose_rw."""
    long_rows = num_entries >= RW_LONG_ROW * num_rows
    if num_rows < THIN_BELOW:
        return RW_GROUP8X2 if long_rows else RW_GROUP8
    if num_rows >= FULL_LEVEL and (long_rows or dtype == torch.float64):
        return RW_TILE
    return RW_ROW


def flux_shape(num_rows: int, num_entries: int, dtype: torch.dtype) -> int:
    """The flux kernel's shape: rows of RW_LONG_ROW entries or more on
    average (the tet's) take the tile, but a thread per row from
    THIN_BELOW up to FLUX_MID_LEVEL rows at fp32 and bf16; shorter rows a
    thread per row. The mirror of the C entry point's choose_flux."""
    if num_entries < RW_LONG_ROW * num_rows:
        return FLUX_ROW
    mid = THIN_BELOW <= num_rows < FLUX_MID_LEVEL
    return FLUX_ROW if mid and dtype != torch.float64 else FLUX_TILE


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


STORAGE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels compute in for a storage type: float32 for
    bfloat16, else the storage type itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def chunk_entries(dtype: torch.dtype) -> int:
    """Entries a tile stages per chunk (csrc/csr_tile.cuh chunk_entries):
    4096 bytes over the compute type's size."""
    return 4096 // compute_dtype(dtype).itemsize


def complete8(q, prims=None):
    """(5, ...) conserved -> [rho, mx, my, mz, E, p, speed+sos, 1/rho],
    the op order of flux_window._complete8 and csr_common.cuh; with prims,
    the state's stored primitives (2, ...) [1/rho, speed+sos]
    (kernels/fused_stage.py primitives), those two taken from it and p
    from its 1/rho, as the kernels gather them."""
    rho, mx, my, mz, E = q[0], q[1], q[2], q[3], q[4]
    inv = 1.0 / rho if prims is None else prims[0]
    vx, vy, vz = mx * inv, my * inv, mz * inv
    speed_sqd = vx * vx + vy * vy + vz * vz
    p = (GAMMA - 1.0) * (E - 0.5 * rho * speed_sqd)
    s = (torch.sqrt(speed_sqd) + torch.sqrt(GAMMA * p * inv)
         if prims is None else prims[1])
    return [rho, mx, my, mz, E, p, s, inv]


def flux_math(qo, qn, w0, w1, w2, wt):
    """Flux value into the owner of each half-edge (flux_window._flux_math)."""
    ro, mox, moy, moz, Eo, po, so, iro = qo
    rn, mnx, mny, mnz, En, pn, sn, irn = qn
    factor = wt * (-0.5 * SMOOTHING_COEFFICIENT) * (so + sn)
    wmo = w0 * mox + w1 * moy + w2 * moz
    wmn = w0 * mnx + w1 * mny + w2 * mnz
    wvo = wmo * iro
    wvn = wmn * irn
    psum = po + pn
    return torch.stack([
        factor * (ro - rn) - 0.5 * (wmo + wmn),
        factor * (mox - mnx) - 0.5 * (wvo * mox + wvn * mnx + w0 * psum),
        factor * (moy - mny) - 0.5 * (wvo * moy + wvn * mny + w1 * psum),
        factor * (moz - mnz) - 0.5 * (wvo * moz + wvn * mnz + w2 * psum),
        factor * (Eo - En) - 0.5 * (wvo * (Eo + po) + wvn * (En + pn)),
    ])


def edge_csr_plain(mode: str, csr: DeviceCSR, x: torch.Tensor,
                   own: torch.Tensor | None = None, keep=None,
                   correct=None):
    """What the kernel computes, as gathers plus one index_add_: per entry
    h of row i with neighbour j (owner values from `own` when given, else
    from x's first columns),
      flux  out[:, i] += flux_math(q_i, q_j, w[0:3, h], w[3, h])
      rw    out[:, i] += q_i + q_j + w0 + w1 + w2
      wsum  out[:, i] += w[0, h] * x[:, j],
    in compute_dtype(x.dtype), rounded once to x.dtype; in wsum mode then
    the epilogues of wsum_tail."""
    return wsum_tail(csr, row_sums(mode, csr, x, own).to(x.dtype), keep,
                     correct)


def wsum_tail(csr: DeviceCSR, out, keep=None, correct=None):
    """wsum mode's epilogues on the rounded sums out (csrc/edge_csr.cu
    WsumTail): the rows with no entries take keep's columns; correct =
    (base, res) gives base + (res - out), each operation rounded to the
    storage dtype as the kernel rounds it."""
    if keep is not None:
        empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
        out = torch.where(empty[None], keep, out)
    if correct is not None:
        base, res = correct
        out = base + (res - out)
    return out


def row_sums(mode: str, csr: DeviceCSR, x: torch.Tensor,
             own: torch.Tensor | None = None, prims=None):
    """edge_csr_plain before its final rounding: in compute_dtype. prims:
    in flux mode without own, x's stored primitives, gathered as the
    fused stage gathers them (complete8)."""
    c = compute_dtype(x.dtype)
    x = x.to(c)
    xn = x.index_select(1, csr.col)
    w = csr.w.to(c)
    if mode == "wsum":
        vals = w[0] * xn
    else:
        xo = (x if own is None else own.to(c)).index_select(1, csr.owner)
        if mode == "flux":
            po = pn = None
            if prims is not None:
                po = prims.index_select(1, csr.owner)
                pn = prims.index_select(1, csr.col)
            vals = flux_math(complete8(xo, po), complete8(xn, pn), w[0],
                             w[1], w[2], w[3])
        else:
            vals = xo + xn + w[0] + w[1] + w[2]
    out = torch.zeros((x.shape[0], csr.num_rows), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(1, csr.owner, vals)


def check_operands(csr: DeviceCSR, x: torch.Tensor, mode: str,
                   own: torch.Tensor | None = None) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype not in STORAGE_DTYPES or x.dtype != csr.w.dtype:
        raise TypeError(f"edge_csr: dtype {x.dtype} with weights "
                        f"{csr.w.dtype}; float32, float64 or bfloat16, "
                        "matching")
    if tuple(x.shape) != (5, csr.num_cols) or not x.is_contiguous():
        raise ValueError(f"edge_csr: need a contiguous (5, {csr.num_cols}) "
                         f"state, got {tuple(x.shape)}")
    if mode != "wsum" and csr.num_cols < csr.num_rows:
        raise ValueError(f"edge_csr {mode}: the neighbour space must hold "
                         "the owner space as its first columns")
    wider = mode != "wsum" and csr.num_cols > csr.num_rows
    if (own is None and wider) or (own is not None and (
            not wider or own.dtype != x.dtype or own.device != x.device
            or not own.is_contiguous()
            or tuple(own.shape) != (5, csr.num_rows))):
        raise ValueError(f"edge_csr {mode}: `own`, a contiguous "
                         f"(5, {csr.num_rows}) operand like x, goes with a "
                         "neighbour space wider than the owners', in flux "
                         "or rw mode")
    if csr.w.shape[0] < _MIN_WEIGHT_ROWS[mode]:
        raise ValueError(f"edge_csr {mode}: needs {_MIN_WEIGHT_ROWS[mode]} "
                         f"weight rows, plan has {csr.w.shape[0]}")
    if any(t.device != x.device for t in (csr.row_ptr, csr.col, csr.w)):
        raise ValueError("edge_csr: plan and state on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_csr: unsupported device {x.device}")


def check_tail(csr: DeviceCSR, x: torch.Tensor, mode: str, keep,
               correct) -> None:
    """Raise on epilogue operands the kernel does not take: wsum mode
    only, one of keep and correct, each a contiguous (5, num_rows)
    operand like x."""
    if keep is None and correct is None:
        return
    if mode != "wsum" or (keep is not None and correct is not None):
        raise ValueError("edge_csr: keep or correct, not both, in wsum "
                         "mode only")
    for t in (keep,) if keep is not None else tuple(correct):
        if (tuple(t.shape) != (5, csr.num_rows) or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"edge_csr wsum: an epilogue operand must be "
                             f"a contiguous (5, {csr.num_rows}) {x.dtype} "
                             f"tensor on {x.device}")


def pointer(t):
    """A tensor's device address, or None (NULL) for an operand left
    out."""
    return None if t is None else t.data_ptr()


def tail_pointers(keep, correct) -> tuple:
    """The C entry points' keep, base and res."""
    base, res = correct if correct is not None else (None, None)
    return pointer(keep), pointer(base), pointer(res)


class EdgeCSR:
    """The edge_csr kernel in one mode, for one role on the path."""

    def __init__(self, name: str, mode: str):
        self.name = name
        self.mode = mode

    def counter(self, shape) -> str:
        """The counter a launch at `shape` (as rw_shape, flux_shape or
        wsum_shape give it for this wrapper's mode) adds to:
        <wrapper>.<shape name>, the name RW_SHAPES or FLUX_SHAPES gives,
        or WSUM_LOADS' of a WsumShape's loads."""
        if self.mode == "wsum":
            return f"{self.name}.{WSUM_LOADS[shape.loads]}"
        names = RW_SHAPES if self.mode == "rw" else FLUX_SHAPES
        return f"{self.name}.{names[shape]}"

    def _count(self, counter: str, keep=None, correct=None) -> None:
        launched(self.name, counter, epilogues=[
            name for name, t in (("restrict", keep), ("prolong", correct))
            if t is not None])

    def __call__(self, csr: DeviceCSR, x: torch.Tensor,
                 own: torch.Tensor | None = None, keep=None,
                 correct=None) -> torch.Tensor:
        """(5, num_cols) -> (5, num_rows). own: with a neighbour space
        wider than the owners' (flux and rw modes), the owners' (5,
        num_rows) values, equal to x[:, :num_rows]. keep, correct: wsum
        mode's epilogues (wsum_tail), (5, num_rows) operands."""
        check_operands(csr, x, self.mode, own)
        check_tail(csr, x, self.mode, keep, correct)
        if not _on_card(x):
            return edge_csr_plain(self.mode, csr, x, own, keep, correct)
        out = torch.empty((5, csr.num_rows), dtype=x.dtype, device=x.device)
        x_own = 0 if self.mode == "wsum" else \
            (x if own is None else own).data_ptr()
        rc = build.library().mgcfd_edge_csr(
            build.dtype_code(x), MODES[self.mode],
            csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.w.data_ptr(),
            csr.num_entries, x_own, x.data_ptr(), csr.num_cols,
            out.data_ptr(), csr.num_rows, *tail_pointers(keep, correct),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(rc, self.name)
        counter = csr.counters.get(self.name)
        if counter is None:     # the CSR's first launch: ask its shape
            counter = csr.counters[self.name] = self.counter(self.shape(csr))
        self._count(counter, keep, correct)
        return out

    def at(self, csr: DeviceCSR, x: torch.Tensor, shape,
           own: torch.Tensor | None = None, keep=None, correct=None):
        """wsum mode at a WsumShape, rw mode at an rw shape (RW_ROW, ...)
        or flux mode at a flux shape (FLUX_ROW, ...), for timing and
        checking shapes; own, keep and correct as in __call__."""
        check_operands(csr, x, self.mode, own)
        check_tail(csr, x, self.mode, keep, correct)
        if not _on_card(x):
            return edge_csr_plain(self.mode, csr, x, own, keep, correct)
        out = torch.empty((5, csr.num_rows), dtype=x.dtype, device=x.device)
        lib, stream = build.library(), \
            torch.cuda.current_stream(x.device).cuda_stream
        if self.mode == "wsum":
            rc = lib.mgcfd_wsum_at(
                build.dtype_code(x), int(shape.split), shape.loads,
                csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.w.data_ptr(),
                csr.num_entries, x.data_ptr(), csr.num_cols, out.data_ptr(),
                csr.num_rows, *tail_pointers(keep, correct), stream)
        else:
            fn = lib.mgcfd_rw_at if self.mode == "rw" else lib.mgcfd_flux_at
            rc = fn(build.dtype_code(x), shape, csr.row_ptr.data_ptr(),
                    csr.col.data_ptr(), csr.w.data_ptr(), csr.num_entries,
                    (x if own is None else own).data_ptr(), x.data_ptr(),
                    csr.num_cols, out.data_ptr(), csr.num_rows, stream)
        build.check(rc, self.name)
        self._count(self.counter(shape), keep, correct)
        return out

    def shape(self, csr: DeviceCSR):
        """The shape the C entry point picks for this CSR: a WsumShape in
        wsum mode, an rw or flux shape in those modes; launches nothing."""
        got = (ctypes.c_int64 * 2)()
        fn = {"wsum": build.library().mgcfd_wsum_shape,
              "rw": build.library().mgcfd_rw_shape,
              "flux": build.library().mgcfd_flux_shape}[self.mode]
        rc = fn(build.DTYPE_CODES[csr.w.dtype], csr.num_rows,
                csr.num_entries, ctypes.addressof(got))
        build.check(rc, self.name)
        if self.mode != "wsum":
            return int(got[0])
        return WsumShape(split=bool(got[0]), loads=int(got[1]))


flux = EdgeCSR("edge_csr.flux", "flux")
rw = EdgeCSR("edge_csr.rw", "rw")
restrict = EdgeCSR("edge_csr.wsum.restrict", "wsum")
prolong = EdgeCSR("edge_csr.wsum.prolong", "wsum")
