from .golden import (ValidationError, dump_edge_fluxes, dump_scalars,
                     dump_variables, identify_differences, output_filepath,
                     read_solution, solution_filepath)

__all__ = ["ValidationError", "dump_edge_fluxes", "dump_scalars",
           "dump_variables", "identify_differences", "output_filepath",
           "read_solution", "solution_filepath"]
