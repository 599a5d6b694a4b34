from .csr import (CSRPlan, build_flux_csr, build_restrict_csr,
                  build_prolong_csr)

__all__ = ["CSRPlan", "build_flux_csr", "build_restrict_csr",
           "build_prolong_csr"]
