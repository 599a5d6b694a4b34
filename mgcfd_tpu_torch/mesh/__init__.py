from .build import apply_ewt_conditioning, build_edges_from_adjacency
from .cache import load_mesh_cached
from .duplicate import duplicate_mesh
from .generate import generate_box_mesh, generate_multigrid_box
from .io_dat import (MeshFormatError, load_multigrid_mesh, read_grid_dat,
                     read_input_dat, read_mg_connectivity, write_grid_dat,
                     write_input_dat, write_mg_connectivity,
                     write_multigrid_mesh)
from .unstructured import (dual_closure_error, generate_unstructured_hierarchy,
                           generate_unstructured_mesh)

__all__ = ["apply_ewt_conditioning", "build_edges_from_adjacency",
           "load_mesh_cached", "duplicate_mesh", "generate_box_mesh",
           "generate_multigrid_box", "MeshFormatError", "load_multigrid_mesh",
           "read_grid_dat", "read_input_dat", "read_mg_connectivity",
           "write_grid_dat", "write_input_dat", "write_mg_connectivity",
           "write_multigrid_mesh", "dual_closure_error",
           "generate_unstructured_hierarchy", "generate_unstructured_mesh"]
