"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers.

WRAPPERS lists every kernel wrapper; each counts its own kernel launches
so that a run can show which kernels it went through (utils.spans's
counters() reports them as launches.<wrapper>). The edge_csr wrappers
(EDGE_CSR) also count them by the shape their C entry point chose, as
launches.<wrapper>.<shape> (launches.edge_csr.rw.tile,
launches.edge_csr.wsum.prolong.plain, ...). Both variable-major
paths run step_factor once a level visit (two launches, one for the
legacy variant). The window path
(accumulate='window') runs fused_stage, edge_csr.rw, edge_csr.restrict and
edge_csr.prolong, or with fuse_window_stage=False edge_csr.flux over the
whole owner CSR in place of fused_stage; the box path (accumulate='pallas') runs
shift.fused_stage (or shift.flux when the stage is unfused), shift.rw and
the same restrict and prolong, plus edge_csr.flux and edge_csr.rw over
the spill edges where its plan leaves any.
"""
from ..utils import spans
from . import edge_csr, fused_stage as _fused, shift, step_factor as _step
from .edge_csr import DeviceCSR
from .shift import DeviceShift

EDGE_CSR = (edge_csr.flux, edge_csr.rw, edge_csr.restrict, edge_csr.prolong)
WRAPPERS = (*EDGE_CSR, _fused.fused_stage, shift.flux, shift.rw,
            shift.fused_stage, _step.step_factor)
_EDGE_CSR = {w.name: w for w in EDGE_CSR}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    for w in EDGE_CSR:
        w.by_shape.clear()


def launch_counts(shapes: bool = False) -> dict:
    """{wrapper name: launches}; with `shapes` also the edge_csr
    wrappers' {<wrapper>.<shape>: launches} of the shapes they ran."""
    out = {w.name: w.launches for w in WRAPPERS}
    if shapes:
        for w in EDGE_CSR:
            out.update(w.by_shape)
    return out


def add_launch_counts(counts: dict) -> None:
    """Add launch_counts()' {wrapper name or shape counter: launches} to
    the counts: a replayed CUDA graph launches the kernels its capture
    recorded without calling the wrappers (MGCFDSolver.run_batched)."""
    for w in WRAPPERS:
        w.launches += counts.get(w.name, 0)
    for name, n in counts.items():
        # a shape counter is its wrapper's name and the shape's
        w = _EDGE_CSR.get(name.rpartition(".")[0])
        if w is not None:
            w.by_shape[name] = w.by_shape.get(name, 0) + n


spans.source("launches", lambda: launch_counts(shapes=True))


__all__ = ["DeviceCSR", "DeviceShift", "EDGE_CSR", "WRAPPERS",
           "reset_launch_counts", "launch_counts", "add_launch_counts"]
