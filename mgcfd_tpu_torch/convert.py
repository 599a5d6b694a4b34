"""Carry a mesh or a state across from another implementation's objects.

``mesh_from_arrays`` reads the numpy arrays of any MultigridMesh-shaped
object by attribute (``levels``, each with the MeshLevel fields) and its
variant by name, so a mesh built elsewhere (for example by mgcfd_tpu)
reaches the port as identical arrays without this package importing the
other one.
"""
from __future__ import annotations

import numpy as np

from .core.constants import MeshVariant
from .core.types import LEVEL_ARRAYS, MeshLevel, MultigridMesh


def _copy(a):
    return None if a is None else np.array(a, copy=True)


def mesh_from_arrays(obj) -> MultigridMesh:
    levels = []
    for lv in obj.levels:
        kw = {f: _copy(getattr(lv, f)) for f in LEVEL_ARRAYS}
        dims = getattr(lv, "structured_dims", None)
        levels.append(MeshLevel(**kw, structured_dims=None if dims is None
                                else tuple(dims)))
        levels[-1].validate()
    variant = obj.variant
    return MultigridMesh(levels=levels,
                         variant=MeshVariant[getattr(variant, "name",
                                                     variant)],
                         problem_size=getattr(obj, "problem_size", 1),
                         name=getattr(obj, "name", "synthetic"))


def state_from_arrays(variables, residuals) -> dict:
    """Per-level node-major (N, 5) arrays -> the state dict that
    MGCFDSolver.load_state takes (float64 copies)."""
    return {"variables": [np.array(v, np.float64) for v in variables],
            "residuals": [np.array(r, np.float64) for r in residuals]}
