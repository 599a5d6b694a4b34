"""Step factors and the RK stage update, node-major."""
from __future__ import annotations

import torch

from ..core.constants import RK
from .physics import primitive_quantities


def compute_step_factor_legacy(q, volumes):
    """Rodinia-compatible 0.5 / (sqrt(V) * (|v| + c)), no global reduction
    (cfd_loops.cpp:13-73). The square root in 3D is an upstream bug kept
    on purpose: FVCORR validation depends on it (PARITY.md:48)."""
    p = primitive_quantities(q)
    return 0.5 / (torch.sqrt(volumes) * (p["speed"] + p["sos"]))


def compute_step_factor(q, volumes):
    """Per-node dt = 0.5 * cbrt(V) / (|v| + c); the GLOBAL min is broadcast
    and pre-divided by the local volume (cfd_loops.cpp:76-157)."""
    p = primitive_quantities(q)
    dt = 0.5 * torch.pow(volumes, 1.0 / 3.0) / (p["speed"] + p["sos"])
    return torch.min(dt).expand(volumes.shape) / volumes


def time_step(j, step_factors, fluxes, old_variables):
    """RK stage j: old + (sf / (RK + 1 - j)) * flux (cfd_loops.cpp:215-280)."""
    factor = step_factors / float(RK + 1 - j)
    return old_variables + factor[:, None] * fluxes
