"""Mesh-construction semantics shared by the generators and the .dat
reader: edge classification from a node adjacency listing and edge-weight
conditioning (reference io.cpp:70-137, validation.cpp:28-75, call site
euler3d_cpu_double.cpp:333-352)."""
from __future__ import annotations

import numpy as np

from ..core.constants import MeshVariant
from ..core.types import MeshLevel

BOUNDARY_NEIGHBOUR = -1
WALL_NEIGHBOUR = -2


def build_edges_from_adjacency(volumes: np.ndarray,
                               coords: np.ndarray | None,
                               degrees: np.ndarray,
                               neighbour_ids: np.ndarray,
                               neighbour_weights: np.ndarray,
                               variant: MeshVariant) -> MeshLevel:
    """The reference's read_grid rules over a whole listing at once.
    Node i lists degrees[i] entries; neighbour_ids (E,) and
    neighbour_weights (E, 3) hold every node's entries in node order,
    then listing order. Scanning nodes in ascending order, an entry
    (j, w) of node i emits an edge only when j < i (each internal edge is
    listed by both endpoints and the occurrence at the larger one wins):
    j = -1 a far-field boundary edge at i, j = -2 a wall edge at i, else
    the internal edge (a=j, b=i) with normal -w. FVCORR also flips the
    boundary and wall normals. Each class keeps emission order, as
    mgcfd_tpu.mesh.build.build_edges_from_adjacency's per-node loop does."""
    degrees = np.asarray(degrees, dtype=np.int64)
    ids = np.asarray(neighbour_ids, dtype=np.int64)
    wts = np.asarray(neighbour_weights, dtype=np.float64).reshape(-1, 3)
    owner = np.repeat(np.arange(degrees.shape[0], dtype=np.int64), degrees)
    emit = ids < owner
    bnd = emit & (ids == BOUNDARY_NEIGHBOUR)
    wall = emit & (ids == WALL_NEIGHBOUR)
    internal = emit & ~bnd & ~wall
    sign = -1.0 if variant.flips_all_normals else 1.0
    lvl = MeshLevel(
        volumes=np.asarray(volumes, dtype=np.float64),
        coords=None if coords is None else np.asarray(coords, np.float64),
        edge_a=ids[internal].astype(np.int32),
        edge_b=owner[internal].astype(np.int32),
        edge_w=-wts[internal],
        bedge_b=owner[bnd].astype(np.int32), bedge_w=sign * wts[bnd],
        wedge_b=owner[wall].astype(np.int32), wedge_w=sign * wts[wall])
    lvl.validate()
    return lvl


def apply_ewt_conditioning(mesh_levels: list[MeshLevel],
                           variant: MeshVariant) -> None:
    """In place: divide each internal-edge normal by its endpoint distance
    (adjust_ewt) and scale every edge normal by the variant's damping
    factor (dampen_ewt). No-op for variants without damping."""
    factor = variant.ewt_damping_factor
    if factor is None:
        return
    for lvl in mesh_levels:
        if lvl.coords is None:
            raise ValueError("ewt conditioning requires coords")
        d = lvl.coords[lvl.edge_b] - lvl.coords[lvl.edge_a]
        dist = np.sqrt((d * d).sum(axis=1))
        lvl.edge_w = (lvl.edge_w / dist[:, None]) * factor
        lvl.bedge_w = lvl.bedge_w * factor
        lvl.wedge_w = lvl.wedge_w * factor
