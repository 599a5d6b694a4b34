from .csr import (CSRPlan, build_edge_csr, build_flux_csr,
                  build_restrict_csr, build_prolong_csr)
from .renumber import (apply_node_order, locality_stats, rcm_order,
                       renumber_hierarchy)
from .shift import ShiftPlan, build_shift_plan

__all__ = ["CSRPlan", "build_edge_csr", "build_flux_csr",
           "build_restrict_csr", "build_prolong_csr", "apply_node_order",
           "locality_stats", "rcm_order", "renumber_hierarchy", "ShiftPlan",
           "build_shift_plan"]
