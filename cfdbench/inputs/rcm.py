"""Reverse Cuthill-McKee renumbering of a hierarchy (a frozen copy of
mgcfd_tpu_torch.prep.renumber: the same node order for the same mesh).
Level 0 takes RCM; each coarser level is ordered by the mean new index of
its children, so that a coarse node sits near them."""
from __future__ import annotations

import dataclasses

import numpy as np

from .level import Hierarchy, Level


def rcm_order(num_nodes: int, edge_a, edge_b) -> np.ndarray:
    """order[new_id] = old_id: a BFS visiting each node's unvisited
    neighbours by ascending degree (stable), seeds by ascending degree,
    reversed."""
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


def apply_node_order(lvl: Level, order: np.ndarray) -> Level:
    """New node i is old node order[i]; edges keep their order and their
    orientation."""
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    new = dataclasses.replace(
        lvl, volumes=lvl.volumes[order],
        coords=None if lvl.coords is None else lvl.coords[order],
        edge_a=inv[lvl.edge_a].astype(np.int32),
        edge_b=inv[lvl.edge_b].astype(np.int32),
        bedge_b=inv[lvl.bedge_b].astype(np.int32),
        wedge_b=inv[lvl.wedge_b].astype(np.int32),
        mg_mapping=None if lvl.mg_mapping is None
        else lvl.mg_mapping[order])
    new.validate()
    return new


def renumber_hierarchy(mesh: Hierarchy) -> Hierarchy:
    """Every level renumbered and the inter-level maps fixed; the input
    is not modified."""
    new_levels: list[Level] = []
    for lev, lvl in enumerate(mesh.levels):
        if lev > 0 and new_levels[lev - 1].mg_mapping is not None:
            fmap = new_levels[lev - 1].mg_mapping   # values: old ids here
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
    return Hierarchy(levels=new_levels, variant=mesh.variant,
                     problem_size=mesh.problem_size)
