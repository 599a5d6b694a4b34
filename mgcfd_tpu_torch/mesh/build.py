"""Edge-weight conditioning (reference validation.cpp:28-75, call site
euler3d_cpu_double.cpp:333-352)."""
from __future__ import annotations

import numpy as np

from ..core.constants import MeshVariant
from ..core.types import MeshLevel


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
