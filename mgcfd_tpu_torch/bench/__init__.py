from .flagship import FLAGSHIP_SPEC, FlagshipSpec, flagship_mesh

__all__ = ["FLAGSHIP_SPEC", "FlagshipSpec", "flagship_mesh"]
