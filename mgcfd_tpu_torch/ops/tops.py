"""Variable-major (5, N) ops (mgcfd_tpu/ops/tops.py): the state as
(NVAR, N) for the kernel paths and the transposed shift path. Same math
as physics.py and flux.py, axes swapped."""
from __future__ import annotations

import numpy as np
import torch

from ..core.constants import GAMMA, RK, SMOOTHING_COEFFICIENT


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


def t_flux_tensor(q, prim=None):
    """q: (5, N) -> F: (3, 5, N); F[d, v] = flux of v in direction d,
    the momentum block oriented vel[k] * mom[d] (as physics.flux_tensor)."""
    if prim is None:
        prim = t_primitives(q)
    mom, vel, p = prim["mom"], prim["vel"], prim["pressure"]
    de_p = prim["energy"] + p
    mom_block = vel[None, :, :] * mom[:, None, :]       # (d, k, N)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)[:, :, None]
    mom_block = mom_block + p[None, None, :] * eye
    density_row = mom[:, None, :]                       # (3, 1, N)
    energy_row = (vel * de_p[None])[:, None, :]         # (3, 1, N)
    return torch.cat([density_row, mom_block, energy_row], dim=1)


def t_internal_edge_flux(q_a, q_b, ew, ewt=None):
    """q_a, q_b: (5, E); ew: (3, E) -> (5, E) value into a (negated for
    b). ewt: |ew| when precomputed."""
    if ewt is None:
        ewt = torch.sqrt(torch.sum(ew * ew, dim=0))
    pa, pb = t_primitives(q_a), t_primitives(q_b)
    fa = t_flux_tensor(q_a, pa)
    fb = t_flux_tensor(q_b, pb)
    factor = (-ewt * (SMOOTHING_COEFFICIENT * 0.5)
              * (pa["speed"] + pb["speed"] + pa["sos"] + pb["sos"]))
    central = torch.einsum("de,dve->ve", ew, fa + fb)
    return factor[None] * (q_a - q_b) - 0.5 * central


def t_boundary_edge_flux(q_b, ew):
    p = t_primitives(q_b)["pressure"]
    zeros = torch.zeros_like(p)[None]
    return torch.cat([zeros, ew * p[None], zeros], dim=0)


def t_wall_edge_flux(q_b, ew, ff_flux_t):
    """ff_flux_t: (3, 5) far-field flux tensor."""
    fb = t_flux_tensor(q_b)
    return 0.5 * torch.einsum("de,dve->ve", ew, fb + ff_flux_t[:, :, None])


def t_shift_flux(deltas, weights, variables, num_nodes):
    """Span-by-span internal flux; weights[i]: (3, N - d)."""
    flux = torch.zeros_like(variables)
    for d, wd in zip(deltas, weights):
        val = t_internal_edge_flux(variables[:, :num_nodes - d],
                                   variables[:, d:], wd)
        flux[:, :num_nodes - d] += val
        flux[:, d:] -= val
    return flux


def t_shift_flux_rolled(deltas, wpad, variables):
    """All spans in one evaluation over (..., D*N) operands: the b-side
    states are rolled views of the state, the b-side sums a rolled
    subtraction. The lanes that wrap around carry zero weight, so with a
    physical state their edge values are exactly zero.
    wpad: (3|4, D*N) span-major (rows 0:3 the weights, zero where there
    is no edge; row 3 |w|), or (D, 3|4, N)."""
    return _rolled_pass(
        deltas, wpad, variables,
        lambda qa, qb, ew, ewt: t_internal_edge_flux(qa, qb, ew, ewt))


def _rolled_pass(deltas, wpad, variables, edge_val):
    """Lane-concatenated (..., D*N) operands, one edge_val evaluation,
    then a roll-subtract for the b-sides."""
    D = len(deltas)
    V, n = variables.shape
    if wpad.ndim == 3:
        wpad = wpad.permute(1, 0, 2).reshape(wpad.shape[1], D * n)
    ew = wpad[:3]
    ewt = wpad[3] if wpad.shape[0] == 4 else None
    qa = torch.cat([variables] * D, dim=1)
    qb = torch.cat([torch.roll(variables, -d, dims=1) for d in deltas],
                   dim=1)
    val = edge_val(qa, qb, ew, ewt).reshape(V, D, n)
    flux = torch.sum(val, dim=1)
    for i, d in enumerate(deltas):
        flux = flux - torch.roll(val[:, i, :], d, dims=1)
    return flux


def t_shift_rw_rolled(deltas, wpad, variables):
    """The indirect_rw twin of t_shift_flux_rolled: the same operands and
    accumulation with near-zero arithmetic
    (indirect_rw_kernel.elemfunc.c:42-55)."""
    return _rolled_pass(
        deltas, wpad, variables,
        lambda qa, qb, ew, ewt: qa + qb + (ew[0] + ew[1] + ew[2])[None])


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


def t_segment_accumulate(val, dest, num_nodes):
    """(5, E) values into (5, N) at their destination nodes."""
    out = torch.zeros((val.shape[0], num_nodes), dtype=val.dtype,
                      device=val.device)
    return out.index_add_(1, dest, val)
