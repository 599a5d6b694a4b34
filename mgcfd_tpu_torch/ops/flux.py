"""Edge flux values and their accumulation into nodes: the plain
edge-stream path (accumulate='segment'). Per-edge values are computed
edge-major; the internal-edge b-side value is the exact negation of the
a-side value (the reference's FLUX_REUSE_FLUX observation)."""
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
                    wedge_b=None, val_wall=None, val_internal_b=None):
    """Segment-sum of the per-edge values into (num_nodes, 5): one
    index_add_ over the concatenated (destination, value) stream.
    val_internal_b defaults to -val_internal (antisymmetry)."""
    if val_internal_b is None:
        val_internal_b = -val_internal
    dests = [edge_a, edge_b]
    vals = [val_internal, val_internal_b]
    if val_boundary is not None:
        dests.append(bedge_b)
        vals.append(val_boundary)
    if val_wall is not None:
        dests.append(wedge_b)
        vals.append(val_wall)
    out = torch.zeros((num_nodes, val_internal.shape[-1]),
                      dtype=val_internal.dtype, device=val_internal.device)
    return out.index_add_(0, torch.cat(dests), torch.cat(vals))
