from .checkpoint import load_carry, save_carry
from .profiling import StageTimer, annotate, trace

__all__ = ["save_carry", "load_carry", "StageTimer", "annotate", "trace"]
