"""Edge flux values and their accumulation into nodes: the plain
edge-stream paths (accumulate='segment' and 'scatter'; 'ell' in
prep/incidence.py). Per-edge values are computed edge-major; the
internal-edge b-side value is the exact negation of the a-side value (the
reference's FLUX_REUSE_FLUX observation)."""
from __future__ import annotations

import torch

from ..core.constants import SMOOTHING_COEFFICIENT
from .physics import primitive_quantities, flux_tensor


def internal_edge_flux(q_a, q_b, ew, ewt=None):
    """Per-internal-edge flux into node a (negate for node b):
    factor * (q_a - q_b) - 0.5 * ew . (F_a + F_b) with
    factor = -|ew| * 0.2 * 0.5 * (speed_a + speed_b + sos_a + sos_b)
    (flux_kernel.elemfunc.c:130-162)."""
    if ewt is None:
        ewt = torch.sqrt(torch.sum(ew * ew, dim=-1))
    pa = primitive_quantities(q_a)
    pb = primitive_quantities(q_b)
    fa = flux_tensor(q_a, pa)
    fb = flux_tensor(q_b, pb)
    factor = (-ewt * (SMOOTHING_COEFFICIENT * 0.5)
              * (pa["speed"] + pb["speed"] + pa["sos"] + pb["sos"]))
    central = torch.einsum("ed,edv->ev", ew, fa + fb)
    return factor[:, None] * (q_a - q_b) - 0.5 * central


def boundary_edge_flux(q_b, ew):
    """Far-field boundary edge: momentum flux = pressure * normal
    (flux_boundary_kernel.elemfunc.c:41-45)."""
    p = primitive_quantities(q_b)["pressure"]
    zeros = torch.zeros_like(p)[:, None]
    return torch.cat([zeros, ew * p[:, None], zeros], dim=-1)


def wall_edge_flux(q_b, ew, ff_flux):
    """Wall edge: 0.5 * normal . (F_farfield + F_b) for all five variables
    (flux_wall_kernel.elemfunc.c:51-69). ff_flux: (3, 5)."""
    fb = flux_tensor(q_b)
    return 0.5 * torch.einsum("ed,edv->ev", ew, fb + ff_flux[None])


def internal_edge_flux_crippled(q_a, q_b, ew):
    """Arithmetically gutted twin of internal_edge_flux: the same memory
    traffic, deliberately meaningless math, which isolates the
    memory-bound ceiling (flux_kernel_crippled.elemfunc.c; driver use
    euler3d_cpu_double.cpp:399-418). Not physics; do not fix the math:
    the arithmetic is mgcfd_tpu's op for op."""
    ewt = torch.sqrt(torch.sum(ew * ew, dim=-1))

    def gutted(q, recip):
        rho, mom, pe = q[..., 0], q[..., 1:4], q[..., 4]
        vel = mom * recip[..., None]
        speed_sqd = vel[..., 0] + vel[..., 1] * vel[..., 2]
        pressure = pe - rho * speed_sqd
        sos = pressure * recip
        de_p = pe + pressure
        fde = vel * de_p[..., None]
        return mom, speed_sqd, pressure, sos, fde

    mom_b, ss_b, pr_b, sos_b, fde_b = gutted(q_b,
                                             torch.ones_like(q_b[..., 0]))
    mom_a, ss_a, pr_a, sos_a, fde_a = gutted(q_a, 1.0 / q_a[..., 0])

    factor = (-ewt * (SMOOTHING_COEFFICIENT * 0.5)
              * (ss_a + ss_b + sos_a + sos_b))
    fsum = ew  # factor_x/y/z collapse; keep the loads live
    msum = mom_a + mom_b
    p_val = factor * (q_a[..., 0] - q_b[..., 0]) + torch.sum(
        -0.5 * fsum * msum, dim=-1)
    m_val = (factor[..., None] * (mom_a - mom_b)
             + torch.sum(-0.5 * fsum, dim=-1, keepdim=True) * msum)
    pe_val = factor * (q_a[..., 4] - q_b[..., 4]) + torch.sum(
        -0.5 * fsum * (fde_a + fde_b), dim=-1)
    return torch.cat([p_val[:, None], m_val, pe_val[:, None]], dim=-1)


def indirect_rw_edge_values(q_a, q_b, ew):
    """The data-movement twin's per-edge values (val_a, val_b): the same
    gather/scatter pattern as the flux with near-zero arithmetic
    (indirect_rw_kernel.elemfunc.c:42-55)."""
    val_a = torch.stack([q_b[:, 0] + ew[:, 0], q_b[:, 1] + ew[:, 2],
                         q_b[:, 2], q_b[:, 3], q_b[:, 4] + ew[:, 1]],
                        dim=-1)
    return val_a, q_a


def accumulate_flux(num_nodes, edge_a, edge_b, val_internal,
                    bedge_b=None, val_boundary=None,
                    wedge_b=None, val_wall=None, mode: str = "segment",
                    val_internal_b=None):
    """Combine per-edge values into (num_nodes, 5):
      'segment'  one index_add_ over the concatenated (destination,
                 value) stream;
      'scatter'  chained index_add_ calls in mgcfd_tpu's order: a-side,
                 b-side, boundary, wall (the reference's += loop).
    val_internal_b defaults to -val_internal (antisymmetry)."""
    if val_internal_b is None:
        val_internal_b = -val_internal
    out = torch.zeros((num_nodes, val_internal.shape[-1]),
                      dtype=val_internal.dtype, device=val_internal.device)
    dests = [edge_a, edge_b]
    vals = [val_internal, val_internal_b]
    if val_boundary is not None:
        dests.append(bedge_b)
        vals.append(val_boundary)
    if val_wall is not None:
        dests.append(wedge_b)
        vals.append(val_wall)
    if mode == "scatter":
        for d, v in zip(dests, vals):
            out.index_add_(0, d, v)
        return out
    if mode == "segment":
        return out.index_add_(0, torch.cat(dests), torch.cat(vals))
    raise ValueError(f"unknown accumulation mode: {mode}")
