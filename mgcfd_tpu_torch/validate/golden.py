"""Golden-comparison tolerances of the reference (validation.cpp:140-199)."""
from __future__ import annotations

import numpy as np

from ..core.constants import MeshVariant


class ValidationError(AssertionError):
    pass


def identify_differences(test_values: np.ndarray,
                         master_values: np.ndarray,
                         variant: MeshVariant,
                         raise_on_fail: bool = True) -> int:
    """Elementwise: relative 10.0e-9 with absolute floor 3.0e-19, relaxed
    to 1.0e-15 for FVCORR. Returns the violation count."""
    rel = 10.0e-9
    abs_floor = 1.0e-15 if variant is MeshVariant.FVCORR else 3.0e-19
    acceptable = np.maximum(np.abs(master_values) * rel, abs_floor)
    bad = np.abs(test_values - master_values) > acceptable
    count = int(bad.sum())
    if count and raise_on_fail:
        idx = tuple(np.argwhere(bad)[0])
        raise ValidationError(
            f"{count} values exceed tolerance; first at {idx}: "
            f"test={test_values[idx]!r} master={master_values[idx]!r}")
    return count
