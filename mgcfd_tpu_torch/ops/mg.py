"""Multigrid transfers, node-major plain torch: restriction of the
solution variables and the reference's live prolongation operator
(prolong_residuals_interpolate_proper, mg_loops.cpp:678-864)."""
from __future__ import annotations

import torch


def mg_restrict(vars_fine, vars_coarse, mapping, num_coarse_nodes):
    """Segment mean of the fine variables into their coarse parents
    (mg_loops.cpp:30-202). Unmapped coarse nodes keep their old value;
    mapping[i] is defined for fine ids i < len(mapping)."""
    mgc = mapping.shape[0]
    shape = (num_coarse_nodes, vars_fine.shape[1])
    sums = torch.zeros(shape, dtype=vars_fine.dtype,
                       device=vars_fine.device).index_add_(
        0, mapping, vars_fine[:mgc])
    counts = torch.zeros(num_coarse_nodes, dtype=vars_fine.dtype,
                         device=vars_fine.device).index_add_(
        0, mapping, torch.ones(mgc, dtype=vars_fine.dtype,
                               device=vars_fine.device))
    mapped = counts > 0
    safe = torch.where(mapped, counts, torch.ones_like(counts))
    return torch.where(mapped[:, None], sums / safe[:, None], vars_coarse)


def _inv_dist(dx):
    return 1.0 / torch.sqrt(torch.sum(dx * dx, dim=-1))


def prolong_residuals_interpolate(res_coarse, res_fine, vars_fine,
                                  mapping, coords_coarse, coords_fine,
                                  edge_a, edge_b):
    """Inverse-distance interpolation of the coarse residuals onto the fine
    nodes over the fine internal edges, then
    vars_fine += res_fine - interpolated. Kept from the reference:
      - a fine node exactly coincident with its parent takes the parent's
        residual with weight 1 (mg_loops.cpp:745-752);
      - the a1 -> b2 term uses the distance to a1 but the residual of b1
        (mg_loops.cpp:804-810), a reference bug kept for output parity;
      - a fine node on no internal edge interpolates 0 (the reference
        divides 0/0 there; such nodes do not occur in real meshes)."""
    num_fine = vars_fine.shape[0]
    parent = mapping
    coincident = torch.all(coords_fine == coords_coarse[parent], dim=-1)

    a1 = parent[edge_a]
    b1 = parent[edge_b]
    ca1, cb1 = coords_coarse[a1], coords_coarse[b1]
    ca2, cb2 = coords_fine[edge_a], coords_fine[edge_b]
    r_a1, r_b1 = res_coarse[a1], res_coarse[b1]

    id_a1a2 = _inv_dist(ca2 - ca1)
    id_b1a2 = _inv_dist(cb1 - ca2)
    id_b1b2 = _inv_dist(cb2 - cb1)
    id_a1b2 = _inv_dist(ca1 - cb2)

    live_a = (~coincident[edge_a]).to(vars_fine.dtype)
    live_b = (~coincident[edge_b]).to(vars_fine.dtype)

    val_a = live_a[:, None] * (id_a1a2[:, None] * r_a1
                               + id_b1a2[:, None] * r_b1)
    w_a = live_a * (id_a1a2 + id_b1a2)
    # r_b1 twice: the reference's a1 -> b2 term reads residuals1[b1]
    val_b = live_b[:, None] * ((id_b1b2 + id_a1b2)[:, None] * r_b1)
    w_b = live_b * (id_b1b2 + id_a1b2)

    dest = torch.cat([edge_a, edge_b])
    acc = torch.zeros_like(vars_fine).index_add_(
        0, dest, torch.cat([val_a, val_b]))
    wsum = torch.zeros(num_fine, dtype=vars_fine.dtype,
                       device=vars_fine.device).index_add_(
        0, dest, torch.cat([w_a, w_b]))
    safe_w = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    wavg = torch.where(coincident[:, None], res_coarse[parent],
                       acc / safe_w[:, None])
    return vars_fine + (res_fine - wavg)
