"""Residual, RMS and the invalid-state count."""
from __future__ import annotations

import torch

from ..core.constants import NVAR, VAR_DENSITY, VAR_DENSITY_ENERGY


def residual(old_variables, variables):
    """variables - old_variables (validation.cpp:77-89)."""
    return variables - old_variables


def calc_rms(residuals, num_nodes: int | None = None):
    """sqrt(sum(r^2) / nel), where the reference divides by the NODE count,
    not nel * NVAR (validation.cpp:91-105). Accepts (N, 5) or (5, N)."""
    nel = num_nodes if num_nodes is not None else residuals.numel() // NVAR
    return torch.sqrt(torch.sum(residuals * residuals) / nel)


def invalid_variables_count(variables):
    """NaN/Inf anywhere plus negative density or density-energy, node-major
    (check_for_invalid_variables, validation.cpp:107-138)."""
    bad = ~torch.isfinite(variables)
    return (bad.sum() + (variables[:, VAR_DENSITY] < 0).sum()
            + (variables[:, VAR_DENSITY_ENERGY] < 0).sum())
