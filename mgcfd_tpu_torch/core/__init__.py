from .constants import (GAMMA, NVAR, NDIM, RK, SMOOTHING_COEFFICIENT,
                        MeshVariant, far_field_state)
from .types import MeshLevel, MultigridMesh
from .config import SolverConfig

__all__ = ["GAMMA", "NVAR", "NDIM", "RK", "SMOOTHING_COEFFICIENT",
           "MeshVariant", "far_field_state", "MeshLevel", "MultigridMesh",
           "SolverConfig"]
