"""Tracing + metrics for the LU pipeline (DESIGN.md §12); a copy of
``repro.obs``, so the port runs without the JAX package.  Disabled (the
default) every instrumentation site is a module-level boolean check."""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import MetricsRegistry, ProgressMeter, registry
from repro_torch.obs.trace import (
    SpanSummary, Tracer, disable, enable, ensure, span, tracer, tracing,
)

__all__ = [
    "metrics", "trace", "MetricsRegistry", "ProgressMeter", "registry",
    "SpanSummary", "Tracer", "disable", "enable", "ensure", "span",
    "tracer", "tracing",
]
