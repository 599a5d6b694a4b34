"""Host containers of one multigrid level and of a hierarchy.

Internal edges (a, b) carry the normal a -> b; boundary (far-field) and
wall edges touch node b only, their normals stored inward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Level:
    volumes: np.ndarray            # (N,) float64
    coords: Optional[np.ndarray]   # (N, 3) float64
    edge_a: np.ndarray             # (Ei,) int32
    edge_b: np.ndarray
    edge_w: np.ndarray             # (Ei, 3) float64
    bedge_b: np.ndarray            # (Eb,) int32
    bedge_w: np.ndarray            # (Eb, 3)
    wedge_b: np.ndarray            # (Ew,) int32
    wedge_w: np.ndarray            # (Ew, 3)
    mg_mapping: Optional[np.ndarray] = None   # fine -> coarse, int64

    @property
    def num_nodes(self) -> int:
        return int(self.volumes.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_a.shape[0] + self.bedge_b.shape[0]
                   + self.wedge_b.shape[0])

    def validate(self) -> None:
        n, e = self.num_nodes, self.edge_a.shape[0]
        ok = (self.edge_b.shape == (e,) and self.edge_w.shape == (e, 3)
              and self.bedge_w.shape == (self.bedge_b.shape[0], 3)
              and self.wedge_w.shape == (self.wedge_b.shape[0], 3)
              and (self.coords is None or self.coords.shape == (n, 3)))
        for idx in (self.edge_a, self.edge_b, self.bedge_b, self.wedge_b):
            ok = ok and (idx.size == 0 or (idx.min() >= 0
                                           and idx.max() < n))
        if not ok:
            raise ValueError("inconsistent Level arrays")


@dataclasses.dataclass
class Hierarchy:
    levels: list
    variant: str = "m6wing"
    problem_size: int = 1
