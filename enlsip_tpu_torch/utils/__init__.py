from .checkpoint import load_carry, save_carry
from .profiling import align, annotate, enable, enabled, span, spans, trace

__all__ = ["save_carry", "load_carry", "span", "annotate", "enable",
           "enabled", "spans", "align", "trace"]
