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


def cbrt_volumes(volumes: torch.Tensor) -> torch.Tensor:
    """cbrt(V) of the stored volumes, taken on the host in their dtype and
    put back on their device. torch.pow(V, 1/3) is what mgcfd_tpu's
    jnp.cbrt computes on the CPU to within its last bit: on a 20^3 box at
    fp32 the two are equal on 99% of the volumes and 1 ulp apart on the
    rest, where numpy's correctly rounded cbrt equals jnp.cbrt on 9%.
    Taken on the host, it is the same value on the card as on the CPU;
    the volumes never change, so the solver takes it once per level
    rather than once per visit."""
    v = volumes.detach().to("cpu")
    return torch.pow(v, 1.0 / 3.0).to(volumes.device)


def compute_step_factor(q, volumes, cbrt_v=None):
    """Per-node dt = 0.5 * cbrt(V) / (|v| + c); the GLOBAL min is broadcast
    and pre-divided by the local volume (cfd_loops.cpp:76-157). cbrt_v:
    cbrt_volumes(volumes), taken here when not given."""
    if cbrt_v is None:
        cbrt_v = cbrt_volumes(volumes)
    p = primitive_quantities(q)
    dt = 0.5 * cbrt_v / (p["speed"] + p["sos"])
    return torch.min(dt).expand(volumes.shape) / volumes


def time_step(j, step_factors, fluxes, old_variables):
    """RK stage j: old + (sf / (RK + 1 - j)) * flux (cfd_loops.cpp:215-280)."""
    factor = step_factors / float(RK + 1 - j)
    return old_variables + factor[:, None] * fluxes
