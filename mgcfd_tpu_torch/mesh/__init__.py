from .build import apply_ewt_conditioning
from .generate import generate_box_mesh, generate_multigrid_box
from .unstructured import generate_unstructured_hierarchy

__all__ = ["apply_ewt_conditioning", "generate_box_mesh",
           "generate_multigrid_box", "generate_unstructured_hierarchy"]
