"""The plain reference: the reference app's multigrid Euler V-cycle in
plain PyTorch at float64, from the mesh files (read by cfdbench.inputs)
and an initial state the benchmark makes. It imports nothing of the port
and takes nothing the port made: it conditions the edge weights, takes
the cube roots and walks the edges itself."""
from .euler import ReferenceSolver

__all__ = ["ReferenceSolver"]
