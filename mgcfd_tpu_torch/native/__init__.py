"""The native mesh parser: mesh_parser.cpp, built with g++ at first use
into build/mgcfd_tpu_torch/, and its ctypes bindings (loader.py)."""
from .loader import native_available, parse_dat_native, parse_mg_native

__all__ = ["native_available", "parse_dat_native", "parse_mg_native"]
