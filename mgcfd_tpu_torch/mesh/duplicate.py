"""Mesh duplication, -m (reference duplicate_mesh, io_enhanced.cpp:
89-201): m disjoint copies of every level, node ids shifted per copy,
each edge class keeping all copies of it together, and the MG mapping
shifted by the coarser level's node count per copy. A problem-size
multiplier, as in mgcfd_tpu.mesh.duplicate. A duplication is the span
mgcfd.duplicate (utils/spans.py)."""
from __future__ import annotations

import numpy as np

from ..core.types import MeshLevel, MultigridMesh
from ..utils import spans


def _dup_level(lvl: MeshLevel, m: int, nel_above: int) -> MeshLevel:
    n = lvl.num_nodes

    def tile_idx(idx: np.ndarray) -> np.ndarray:
        return (np.tile(idx.astype(np.int64), m)
                + np.repeat(np.arange(m, dtype=np.int64) * n,
                            idx.shape[0])).astype(np.int32)

    def tile_w(w: np.ndarray) -> np.ndarray:
        return np.tile(w, (m, 1))

    out = MeshLevel(
        volumes=np.tile(lvl.volumes, m),
        coords=None if lvl.coords is None else np.tile(lvl.coords, (m, 1)),
        edge_a=tile_idx(lvl.edge_a), edge_b=tile_idx(lvl.edge_b),
        edge_w=tile_w(lvl.edge_w),
        bedge_b=tile_idx(lvl.bedge_b), bedge_w=tile_w(lvl.bedge_w),
        wedge_b=tile_idx(lvl.wedge_b), wedge_w=tile_w(lvl.wedge_w),
    )
    if lvl.mg_mapping is not None:
        mgc = lvl.mg_mapping.shape[0]
        out.mg_mapping = (np.tile(lvl.mg_mapping, m)
                          + np.repeat(np.arange(m, dtype=np.int64)
                                      * nel_above, mgc))
    out.validate()
    return out


def duplicate_mesh(mesh: MultigridMesh, m: int) -> MultigridMesh:
    if m <= 1:
        return mesh
    with spans.span("mgcfd.duplicate"):
        new_levels = []
        for i, lvl in enumerate(mesh.levels):
            nel_above = (mesh.levels[i + 1].num_nodes
                         if i + 1 < mesh.num_levels else 0)
            new_levels.append(_dup_level(lvl, m, nel_above))
    return MultigridMesh(levels=new_levels, variant=mesh.variant,
                         problem_size=mesh.problem_size * m,
                         name=mesh.name)
