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
the spill edges where its plan leaves any. The launches that carried
each epilogue (fused_stage.EPILOGUES: a fused stage's count into its
caller's counter and its residual; edge_csr.EPILOGUES: the restriction's
and the prolongation's updates) are the counters epilogue.<name>; a
window or span cycle carries 18 / 6 / 3 / 3 (invalid / residual /
restrict / prolong).
"""
from ..utils import spans
from . import edge_csr, fused_stage as _fused, shift, step_factor as _step
from .edge_csr import DeviceCSR
from .shift import DeviceShift

EDGE_CSR = (edge_csr.flux, edge_csr.rw, edge_csr.restrict, edge_csr.prolong)
WRAPPERS = (*EDGE_CSR, _fused.fused_stage, shift.flux, shift.rw,
            shift.fused_stage, _step.step_factor)
_EDGE_CSR = {w.name: w for w in EDGE_CSR}
_EPILOGUES = (_fused.EPILOGUES, edge_csr.EPILOGUES)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    for w in EDGE_CSR:
        w.by_shape.clear()
    for counts in _EPILOGUES:
        for name in counts:
            counts[name] = 0


def _launches() -> dict:
    """{wrapper name: launches} and the edge_csr wrappers'
    {<wrapper>.<shape>: launches} of the shapes they ran."""
    out = {w.name: w.launches for w in WRAPPERS}
    for w in EDGE_CSR:
        out.update(w.by_shape)
    return out


def _epilogues() -> dict:
    """{epilogue name: launches that carried it}."""
    return {k: n for counts in _EPILOGUES for k, n in counts.items()}


def launch_counts(shapes: bool = False) -> dict:
    """{wrapper name: launches}; with `shapes` also the edge_csr
    wrappers' {<wrapper>.<shape>: launches} of the shapes they ran and
    {epilogue.<name>: launches that carried it} of the epilogues that
    ran."""
    if not shapes:
        return {w.name: w.launches for w in WRAPPERS}
    return {**_launches(), **{f"epilogue.{k}": n
                              for k, n in _epilogues().items() if n}}


def add_launch_counts(counts: dict) -> None:
    """Add launch_counts()' {wrapper name, shape or epilogue counter:
    launches} to the counts: a replayed CUDA graph launches the kernels
    its capture recorded without calling the wrappers
    (MGCFDSolver.run_batched)."""
    for w in WRAPPERS:
        w.launches += counts.get(w.name, 0)
    for name, n in counts.items():
        # a shape counter is its wrapper's name and the shape's
        prefix, _, last = name.rpartition(".")
        w = _EDGE_CSR.get(prefix)
        if w is not None:
            w.by_shape[name] = w.by_shape.get(name, 0) + n
        elif prefix == "epilogue":
            for counts in _EPILOGUES:
                if last in counts:
                    counts[last] += n


spans.source("launches", _launches)
spans.source("epilogue", _epilogues)


__all__ = ["DeviceCSR", "DeviceShift", "EDGE_CSR", "WRAPPERS",
           "reset_launch_counts", "launch_counts", "add_launch_counts"]
