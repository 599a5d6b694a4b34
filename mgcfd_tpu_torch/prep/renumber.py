"""Node renumbering for gather locality (mgcfd_tpu.prep.renumber): reverse
Cuthill-McKee on each level, so that edge endpoints cluster near the
diagonal and the kernels' gathers hit neighbouring memory. Generated box
meshes are well ordered already; imported meshes (and the shuffled tet
generator) are not.

mgcfd_tpu's tile_interleave_order / tile_interleave_levels lay nodes out
for the TPU's (8, 128) window tiles and have no counterpart here, as
SolverConfig.window_tile_order has none.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import MeshLevel, MultigridMesh


def rcm_order(num_nodes: int, edge_a: np.ndarray,
              edge_b: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee over the CSR adjacency, a BFS that visits each
    node's unvisited neighbours by ascending degree (stable), seeds taken
    by ascending degree. Returns `order`, order[new_id] = old_id, equal
    element for element to mgcfd_tpu's rcm_order: a node's adjacency is
    the edges it is the a end of, then those it is the b end of, each in
    edge order (a stable sort by source gives the order of its per-edge
    fill)."""
    deg = np.bincount(edge_a, minlength=num_nodes) + np.bincount(
        edge_b, minlength=num_nodes)
    starts = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    src = np.concatenate([edge_a, edge_b])
    adj = np.concatenate([edge_b, edge_a]).astype(np.int64)[
        np.argsort(src, kind="stable")]

    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = adj[starts[u]:starts[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


def apply_node_order(lvl: MeshLevel, order: np.ndarray) -> MeshLevel:
    """A level whose new node i is old node order[i]: node arrays permuted,
    edges re-indexed in their order. Edges are not flipped where a > b
    afterwards: the prolongation treats the two ends apart (the a1 -> b2
    quirk, mg_loops.cpp:804-810). The level's own mg_mapping rows are
    permuted; its values name the next level's nodes, which the caller
    fixes if that level is renumbered too (renumber_hierarchy)."""
    if lvl.mg_mapping is not None and \
            lvl.mg_mapping.shape[0] != lvl.num_nodes:
        raise ValueError("renumbering requires a full fine->coarse "
                         "mapping (one entry per node)")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    new = dataclasses.replace(
        lvl,
        volumes=lvl.volumes[order],
        coords=None if lvl.coords is None else lvl.coords[order],
        edge_a=inv[lvl.edge_a].astype(np.int32),
        edge_b=inv[lvl.edge_b].astype(np.int32),
        bedge_b=inv[lvl.bedge_b].astype(np.int32),
        wedge_b=inv[lvl.wedge_b].astype(np.int32),
        mg_mapping=None if lvl.mg_mapping is None
        else lvl.mg_mapping[order],
    )
    new.validate()
    return new


def renumber_hierarchy(mesh: MultigridMesh,
                       align_coarse: bool = True) -> MultigridMesh:
    """Renumber every level, fixing the inter-level maps (renumbering level
    l permutes the values of level l-1's mg_mapping and the rows of level
    l's own). Level 0 takes rcm_order; with align_coarse each coarser level
    is ordered by the mean new index of its children in the level below
    (childless nodes last, in their old order), so that a coarse node sits
    near its children and the transfers' gathers stay local. Returns a new
    mesh; the input is not modified."""
    new_levels = []
    for lev, lvl in enumerate(mesh.levels):
        if lev > 0 and align_coarse and \
                new_levels[lev - 1].mg_mapping is not None:
            fmap = new_levels[lev - 1].mg_mapping  # values: old ids here
            sums = np.zeros(lvl.num_nodes)
            cnts = np.zeros(lvl.num_nodes)
            np.add.at(sums, fmap, np.arange(fmap.shape[0], dtype=float))
            np.add.at(cnts, fmap, 1.0)
            pos = np.where(cnts > 0, sums / np.maximum(cnts, 1), np.inf)
            order = np.lexsort((np.arange(lvl.num_nodes), pos))
        else:
            order = rcm_order(lvl.num_nodes, lvl.edge_a, lvl.edge_b)
        inv = np.empty_like(order)
        inv[order] = np.arange(order.shape[0])
        new_levels.append(apply_node_order(lvl, order))
        if lev > 0 and new_levels[lev - 1].mg_mapping is not None:
            new_levels[lev - 1].mg_mapping = \
                inv[new_levels[lev - 1].mg_mapping]
    return MultigridMesh(levels=new_levels, variant=mesh.variant,
                         problem_size=mesh.problem_size, name=mesh.name)


def locality_stats(lvl: MeshLevel) -> dict:
    """Mean and max |a - b| over the internal edges: the index distance
    RCM shrinks."""
    d = np.abs(lvl.edge_a.astype(np.int64) - lvl.edge_b.astype(np.int64))
    return {"mean_span": float(d.mean()) if d.size else 0.0,
            "max_span": int(d.max()) if d.size else 0,
            "num_edges": int(d.size)}
