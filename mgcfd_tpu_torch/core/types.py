"""Host-side mesh containers (numpy). The solver moves them to the device.

Edge conventions (reference read_grid, io.cpp:70-137): internal edges
connect (a, b) with the directed normal a -> b, flux goes +val into a and
-val into b; boundary (far-field) and wall edges touch only node b.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .constants import MeshVariant

# the array fields of a MeshLevel, as each reader and writer carries them
LEVEL_ARRAYS = ("volumes", "coords", "edge_a", "edge_b", "edge_w",
                "bedge_b", "bedge_w", "wedge_b", "wedge_w", "mg_mapping")


@dataclasses.dataclass
class MeshLevel:
    """One multigrid level of an unstructured 3D mesh."""

    volumes: np.ndarray           # (N,) float64
    coords: Optional[np.ndarray]  # (N, 3) float64 or None
    edge_a: np.ndarray            # (Ei,) int32
    edge_b: np.ndarray            # (Ei,) int32
    edge_w: np.ndarray            # (Ei, 3) float64
    bedge_b: np.ndarray           # (Eb,) int32 boundary edge node
    bedge_w: np.ndarray           # (Eb, 3)
    wedge_b: np.ndarray           # (Ew,) int32 wall edge node
    wedge_w: np.ndarray           # (Ew, 3)
    # fine -> coarse map to the NEXT level, defined for fine ids < mg_size
    mg_mapping: Optional[np.ndarray] = None
    structured_dims: Optional[tuple] = None

    @property
    def num_nodes(self) -> int:
        return int(self.volumes.shape[0])

    @property
    def num_internal_edges(self) -> int:
        return int(self.edge_a.shape[0])

    @property
    def num_boundary_edges(self) -> int:
        return int(self.bedge_b.shape[0])

    @property
    def num_wall_edges(self) -> int:
        return int(self.wedge_b.shape[0])

    @property
    def num_edges(self) -> int:
        return (self.num_internal_edges + self.num_boundary_edges
                + self.num_wall_edges)

    def validate(self) -> None:
        """Raise ValueError on inconsistent shapes or out-of-range ids."""
        n, e = self.num_nodes, self.num_internal_edges
        ok = (self.edge_b.shape == (e,) and self.edge_w.shape == (e, 3)
              and self.bedge_w.shape == (self.bedge_b.shape[0], 3)
              and self.wedge_w.shape == (self.wedge_b.shape[0], 3)
              and (self.coords is None or self.coords.shape == (n, 3)))
        for idx in (self.edge_a, self.edge_b, self.bedge_b, self.wedge_b):
            ok = ok and (idx.size == 0 or (idx.min() >= 0
                                           and idx.max() < n))
        if not ok:
            raise ValueError("inconsistent MeshLevel arrays")


@dataclasses.dataclass
class MultigridMesh:
    """A multigrid hierarchy (finest level first) plus its variant."""

    levels: list[MeshLevel]
    variant: MeshVariant
    problem_size: int = 1
    name: str = "synthetic"

    @property
    def num_levels(self) -> int:
        return len(self.levels)
