"""Shift decomposition of the edge set (mgcfd_tpu/prep/shift.py).

After a banded node order (a box mesh's generator order is one), the
index spans delta = b - a of the internal edges collapse onto a few
values: a box has exactly three, 1, nz and ny*nz. All edges of one span
form one diagonal of the adjacency matrix and are evaluated densely:

    val = edge_flux(q[:N-d], q[d:], W_d)    W_d: (N-d, 3), zero rows
    flux[:N-d] += val                       where there is no edge
    flux[d:]   -= val

Edges whose span is rare (below `min_density`), and duplicate (a, span)
pairs, are left over as spill edges for the caller's edge-stream path.
The plan is the same object as the JAX package's: the same spans in the
same order, the same dense weights and the same spill edges in the same
order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import MeshLevel


@dataclasses.dataclass
class ShiftPlan:
    deltas: list[int]            # covered spans, descending coverage
    weights: list[np.ndarray]    # per span d: (N - d, 3) dense weights
    spill_a: np.ndarray          # leftover internal edges
    spill_b: np.ndarray
    spill_w: np.ndarray
    num_covered: int
    num_edges: int

    @property
    def coverage(self) -> float:
        return self.num_covered / max(1, self.num_edges)


def build_shift_plan(lvl: MeshLevel, max_deltas: int = 16,
                     min_density: float = 0.01) -> ShiftPlan:
    n = lvl.num_nodes
    a = lvl.edge_a.astype(np.int64)
    b = lvl.edge_b.astype(np.int64)
    w = lvl.edge_w
    # spans are positive by construction (edges emitted with a < b,
    # io.cpp:92-112); an imported mesh might not be, so normalise
    flip = a > b
    if flip.any():
        a, b, w = (np.where(flip, b, a), np.where(flip, a, b),
                   np.where(flip[:, None], -w, w))
    delta = b - a

    counts = np.bincount(delta, minlength=1)
    order = np.argsort(counts)[::-1]
    chosen = [int(d) for d in order[:max_deltas]
              if d > 0 and counts[d] >= max(1, min_density * n)]

    covered = np.zeros(a.shape[0], dtype=bool)
    weights = []
    deltas = []
    for d in chosen:
        sel = np.flatnonzero((delta == d) & ~covered)
        if sel.size == 0:
            continue
        # duplicate (a, span) pairs cannot share a dense row: keep the
        # first in edge order, spill the rest
        _, first = np.unique(a[sel], return_index=True)
        keep = sel[first]
        dense = np.zeros((n - d, 3))
        dense[a[keep]] = w[keep]
        covered[keep] = True
        weights.append(dense)
        deltas.append(d)

    spill = ~covered
    return ShiftPlan(
        deltas=deltas, weights=weights,
        spill_a=a[spill].astype(np.int32),
        spill_b=b[spill].astype(np.int32),
        spill_w=w[spill],
        num_covered=int(covered.sum()),
        num_edges=int(a.shape[0]))


def shift_flux(deltas, weights, spill, variables, flux_fn, num_nodes):
    """Dense span evaluation, node-major. weights: per span a (N-d, 3)
    tensor; spill: (a, b, w) tensors; flux_fn(q_a, q_b, w) -> values.
    Returns the (N, 5) internal-edge flux."""
    flux = torch.zeros((num_nodes, variables.shape[-1]),
                       dtype=variables.dtype, device=variables.device)
    for d, wd in zip(deltas, weights):
        val = flux_fn(variables[:num_nodes - d], variables[d:], wd)
        flux[:num_nodes - d] += val
        flux[d:] -= val
    sa, sb, sw = spill
    if sa.shape[0]:
        val = flux_fn(variables[sa], variables[sb], sw)
        flux.index_add_(0, torch.cat([sa, sb]), torch.cat([val, -val]))
    return flux
