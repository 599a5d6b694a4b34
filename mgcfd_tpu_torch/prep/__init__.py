from .csr import (CSRPlan, build_edge_csr, build_flux_csr,
                  build_restrict_csr, build_prolong_csr)
from .shift import ShiftPlan, build_shift_plan

__all__ = ["CSRPlan", "build_edge_csr", "build_flux_csr",
           "build_restrict_csr", "build_prolong_csr", "ShiftPlan",
           "build_shift_plan"]
