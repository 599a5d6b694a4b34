from .solver import MGCFDSolver, prepare_device_mesh, resolve_device

__all__ = ["MGCFDSolver", "prepare_device_mesh", "resolve_device"]
