"""Variable-major (5, N) node-wise ops for the kernel path's cycle.
Same math as physics.py, axes swapped."""
from __future__ import annotations

import numpy as np
import torch

from ..core.constants import GAMMA, RK


def t_primitives(q):
    """q: (5, ...) -> dict of (...) primitives; one reciprocal of rho
    feeds the velocity and the speed of sound (<= 1 ulp from mom/rho)."""
    rho = q[0]
    mom = q[1:4]
    energy = q[4]
    inv_rho = 1.0 / rho
    vel = mom * inv_rho[None]
    speed_sqd = torch.sum(vel * vel, dim=0)
    pressure = (GAMMA - 1.0) * (energy - 0.5 * rho * speed_sqd)
    sos = torch.sqrt(GAMMA * pressure * inv_rho)
    return {"rho": rho, "mom": mom, "vel": vel, "energy": energy,
            "speed_sqd": speed_sqd, "speed": torch.sqrt(speed_sqd),
            "pressure": pressure, "sos": sos}


def build_dense_boundary_wall(num_nodes, bedge_b, bedge_w, wedge_b,
                              wedge_w, ff_flux):
    """Host-side per-node sums of the boundary and wall normals plus the
    far-field wall constant. Returns numpy (bd_normal (3, N),
    wall_normal (3, N), wall_const (5, N))."""
    bd = np.zeros((num_nodes, 3))
    np.add.at(bd, bedge_b, bedge_w)
    wl = np.zeros((num_nodes, 3))
    np.add.at(wl, wedge_b, wedge_w)
    wall_const = 0.5 * np.einsum("nd,dv->vn", wl, np.asarray(ff_flux))
    return bd.T.copy(), wl.T.copy(), wall_const


def t_dense_boundary_wall_flux(q, bd_normal, wall_normal, wall_const):
    """Boundary + wall flux from per-node aggregated normals. Both edge
    classes read only their destination node and are linear in the
    normal, so a node's faces collapse into one normal each:
      boundary: momentum += (sum of boundary normals) * p
      wall:     flux += 0.5 * W . F(q) + 0.5 * W . F_farfield (constant)
    bd_normal, wall_normal: (3, N); wall_const: (5, N)."""
    prim = t_primitives(q)
    p = prim["pressure"]
    mx, my, mz = q[1], q[2], q[3]
    vx, vy, vz = prim["vel"]
    de_p = q[4] + p
    hx, hy, hz = (0.5 * wall_normal[d] for d in range(3))
    bx, by, bz = bd_normal[0], bd_normal[1], bd_normal[2]
    rows = (
        hx * mx + hy * my + hz * mz,
        bx * p + hx * (vx * mx + p) + hy * (vx * my) + hz * (vx * mz),
        by * p + hx * (vy * mx) + hy * (vy * my + p) + hz * (vy * mz),
        bz * p + hx * (vz * mx) + hy * (vz * my) + hz * (vz * mz + p),
        hx * (vx * de_p) + hy * (vy * de_p) + hz * (vz * de_p),
    )
    return torch.stack(rows, dim=0) + wall_const


def t_time_step(j, step_factors, fluxes, old_variables):
    factor = step_factors / float(RK + 1 - j)
    return old_variables + factor[None] * fluxes
