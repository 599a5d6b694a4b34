"""Mesh duplication, the app's -m (io_enhanced.cpp:89-201; a frozen copy
of mgcfd_tpu_torch.mesh.duplicate: the same arrays for the same mesh): m
disjoint copies of every level, node ids shifted per copy, each edge
class keeping all copies of it together, and the multigrid map shifted
by the coarser level's node count per copy."""
from __future__ import annotations

import numpy as np

from .level import Hierarchy, Level


def _dup_level(lvl: Level, m: int, nel_above: int) -> Level:
    n = lvl.num_nodes

    def tile_idx(idx):
        return (np.tile(idx.astype(np.int64), m)
                + np.repeat(np.arange(m, dtype=np.int64) * n,
                            idx.shape[0])).astype(np.int32)

    out = Level(
        volumes=np.tile(lvl.volumes, m),
        coords=None if lvl.coords is None else np.tile(lvl.coords, (m, 1)),
        edge_a=tile_idx(lvl.edge_a), edge_b=tile_idx(lvl.edge_b),
        edge_w=np.tile(lvl.edge_w, (m, 1)),
        bedge_b=tile_idx(lvl.bedge_b), bedge_w=np.tile(lvl.bedge_w, (m, 1)),
        wedge_b=tile_idx(lvl.wedge_b), wedge_w=np.tile(lvl.wedge_w, (m, 1)))
    if lvl.mg_mapping is not None:
        k = lvl.mg_mapping.shape[0]
        out.mg_mapping = (np.tile(lvl.mg_mapping, m)
                          + np.repeat(np.arange(m, dtype=np.int64)
                                      * nel_above, k))
    out.validate()
    return out


def duplicate_hierarchy(mesh: Hierarchy, m: int) -> Hierarchy:
    """m copies of the hierarchy side by side; the mesh itself when m is
    1."""
    if m <= 1:
        return mesh
    levels = mesh.levels
    return Hierarchy(
        levels=[_dup_level(lv, m, levels[i + 1].num_nodes
                           if i + 1 < len(levels) else 0)
                for i, lv in enumerate(levels)],
        variant=mesh.variant, problem_size=mesh.problem_size * m)
