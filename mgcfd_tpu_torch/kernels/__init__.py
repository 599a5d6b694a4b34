"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers.

WRAPPERS lists every kernel wrapper; each kernel launch of one is counted
in one store (counts.COUNTS) so that a run can show which kernels it went
through: utils.spans's counters() reports them as launches.<wrapper>. The
edge_csr wrappers (EDGE_CSR) also count them by the shape their C entry
point chose, as launches.<wrapper>.<shape> (launches.edge_csr.rw.tile,
launches.edge_csr.wsum.prolong.plain, ...). Both variable-major
paths run step_factor once a level visit (two launches, one for the
legacy variant). The window path
(accumulate='window') runs fused_stage, edge_csr.rw, edge_csr.restrict and
edge_csr.prolong, or with fuse_window_stage=False edge_csr.flux over the
whole owner CSR in place of fused_stage; the box path (accumulate='pallas') runs
shift.fused_stage (or shift.flux when the stage is unfused), shift.rw and
the same restrict and prolong, plus edge_csr.flux and edge_csr.rw over
the spill edges where its plan leaves any. The launches that carried
each epilogue (EPILOGUE_NAMES: a fused stage's count into its caller's
counter and its residual; the restriction's and the prolongation's
updates) are the counters epilogue.<name>; a window or span cycle
carries 18 / 6 / 3 / 3 (invalid / residual / restrict / prolong). On the
window path's levels with buffers (fused_stage.gathers_primitives) the
first pass of the step factor and the first two RK stages also store the
state's primitives for the next stage (epilogue.primitives, 3 a visit,
2 under the legacy step factor, which stores none), and every fused
stage gathers them (primitives.gathered, 3 a visit, 2 legacy): 18 and 18
a cycle where every level has buffers; the span path neither.
"""
from ..utils import spans
from . import edge_csr, fused_stage as _fused, shift, step_factor as _step
from .boundary import BoundaryRows, boundary_rows
from .counts import COUNTS
from .edge_csr import DeviceCSR
from .shift import DeviceShift

EDGE_CSR = (edge_csr.flux, edge_csr.rw, edge_csr.restrict, edge_csr.prolong)
WRAPPERS = (*EDGE_CSR, _fused.fused_stage, shift.flux, shift.rw,
            shift.fused_stage, _step.step_factor)
EPILOGUE_NAMES = ("invalid", "residual", "restrict", "prolong")
# the counters launch_counts(shapes=True) reports under their own names
_KEPT = ("epilogue", "primitives")


def reset_launch_counts() -> None:
    """Every counter to 0; the wrappers' and the epilogues' are kept at
    0, so that counters() lists them."""
    COUNTS.clear()
    COUNTS.update({**{f"launches.{w.name}": 0 for w in WRAPPERS},
                   **{f"epilogue.{name}": 0 for name in EPILOGUE_NAMES}})


def _named(prefix: str) -> dict:
    """{name: count} of the counters <prefix>.<name>."""
    return {k[len(prefix) + 1:]: n for k, n in COUNTS.items()
            if k.startswith(prefix + ".")}


def launch_counts(shapes: bool = False) -> dict:
    """{wrapper name: launches}; with `shapes` also the edge_csr
    wrappers' {<wrapper>.<shape>: launches} of the shapes they ran,
    {epilogue.<name>: launches that carried it} of the epilogues that ran
    and {primitives.gathered: launches} where any gathered them."""
    if not shapes:
        return {w.name: COUNTS[f"launches.{w.name}"] for w in WRAPPERS}
    return {**_named("launches"),
            **{f"{p}.{k}": n for p in _KEPT for k, n in _named(p).items()
               if n}}


def add_launch_counts(counts: dict) -> None:
    """Add launch_counts()' {wrapper name, shape, epilogue or gathered
    counter: launches} to the counts."""
    COUNTS.update({k if k.startswith(tuple(f"{p}." for p in _KEPT))
                   else f"launches.{k}": n for k, n in counts.items()})


reset_launch_counts()
spans.source("launches", lambda: _named("launches"))
spans.source("epilogue", lambda: _named("epilogue"))
spans.source("primitives", lambda: _named("primitives"))


__all__ = ["BoundaryRows", "boundary_rows", "DeviceCSR", "DeviceShift",
           "EDGE_CSR", "WRAPPERS", "COUNTS",
           "reset_launch_counts", "launch_counts", "add_launch_counts"]
