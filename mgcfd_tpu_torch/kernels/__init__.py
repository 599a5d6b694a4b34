"""Hand-written CUDA kernels (sources in ../csrc) and their wrappers.

WRAPPERS lists every kernel wrapper; each counts its own kernel launches
so that a run can show which kernels it went through. All but
edge_csr.flux are on the solver's kernel path: the fused stage carries
the flux mode's row loop itself.
"""
from . import edge_csr, fused_stage as _fused
from .edge_csr import DeviceCSR

WRAPPERS = (edge_csr.flux, edge_csr.rw, edge_csr.restrict,
            edge_csr.prolong, _fused.fused_stage)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.name: w.launches for w in WRAPPERS}


__all__ = ["DeviceCSR", "WRAPPERS", "reset_launch_counts", "launch_counts"]
