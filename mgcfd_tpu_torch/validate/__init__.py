from .golden import ValidationError, identify_differences

__all__ = ["ValidationError", "identify_differences"]
