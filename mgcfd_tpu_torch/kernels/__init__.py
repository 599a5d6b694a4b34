"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers.

WRAPPERS lists every kernel wrapper; each counts its own kernel launches
so that a run can show which kernels it went through (utils.spans's
counters() reports them as launches.<wrapper>). Both variable-major
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

WRAPPERS = (edge_csr.flux, edge_csr.rw, edge_csr.restrict,
            edge_csr.prolong, _fused.fused_stage, shift.flux, shift.rw,
            shift.fused_stage, _step.step_factor)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.name: w.launches for w in WRAPPERS}


def add_launch_counts(counts: dict) -> None:
    """Add {wrapper name: launches} to the counts: a replayed CUDA graph
    launches the kernels its capture recorded without calling the
    wrappers (MGCFDSolver.run_batched)."""
    for w in WRAPPERS:
        w.launches += counts.get(w.name, 0)


spans.source("launches", launch_counts)


__all__ = ["DeviceCSR", "DeviceShift", "WRAPPERS", "reset_launch_counts",
           "launch_counts", "add_launch_counts"]
