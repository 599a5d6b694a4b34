from .physics import primitive_quantities, flux_tensor
from .flux import (internal_edge_flux, boundary_edge_flux, wall_edge_flux,
                   internal_edge_flux_crippled, indirect_rw_edge_values,
                   accumulate_flux)
from .stepping import cbrt_volumes, compute_step_factor, \
    compute_step_factor_legacy, time_step
from .mg import mg_restrict, prolong_residuals_interpolate
from .validation import residual, calc_rms, invalid_variables_count

__all__ = [
    "primitive_quantities", "flux_tensor",
    "internal_edge_flux", "boundary_edge_flux", "wall_edge_flux",
    "internal_edge_flux_crippled", "indirect_rw_edge_values",
    "accumulate_flux",
    "cbrt_volumes", "compute_step_factor", "compute_step_factor_legacy",
    "time_step",
    "mg_restrict", "prolong_residuals_interpolate",
    "residual", "calc_rms", "invalid_variables_count",
]
