"""Pointwise Euler physics over node-major (..., 5) states
(reference cfd_loops.h:57-153). The flux tensor F (..., 3, 5) holds

    F[d, 0]   = momentum[d]
    F[d, 1+k] = velocity[k] * momentum[d] + p * delta(d, k)
    F[d, 4]   = velocity[d] * (density_energy + p)

with the vel[k]*mom[d] orientation of the reference's rounding."""
from __future__ import annotations

import torch

from ..core.constants import GAMMA


def primitive_quantities(q: torch.Tensor) -> dict:
    """pressure = (gamma-1) * (E - 0.5 * rho * |v|^2) and
    speed_of_sound = sqrt(gamma * p / rho) (cfd_loops.h:140-148)."""
    rho = q[..., 0]
    mom = q[..., 1:4]
    energy = q[..., 4]
    vel = mom / rho[..., None]
    speed_sqd = torch.sum(vel * vel, dim=-1)
    pressure = (GAMMA - 1.0) * (energy - 0.5 * rho * speed_sqd)
    sos = torch.sqrt(GAMMA * pressure / rho)
    return {"rho": rho, "mom": mom, "energy": energy, "vel": vel,
            "speed_sqd": speed_sqd, "speed": torch.sqrt(speed_sqd),
            "pressure": pressure, "sos": sos}


def flux_tensor(q: torch.Tensor, prim: dict | None = None) -> torch.Tensor:
    """q: (..., 5) -> F: (..., 3, 5)."""
    if prim is None:
        prim = primitive_quantities(q)
    mom, vel, p = prim["mom"], prim["vel"], prim["pressure"]
    de_p = prim["energy"] + p
    mom_block = vel[..., None, :] * mom[..., :, None]       # (..., d, k)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    mom_block = mom_block + p[..., None, None] * eye
    density_col = mom[..., :, None]
    energy_col = (vel * de_p[..., None])[..., :, None]
    return torch.cat([density_col, mom_block, energy_col], dim=-1)
