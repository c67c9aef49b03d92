"""Observability of the port.  So far the virtual clock (``tracer``) and
the recompile detector over the captured steps (``recompile``); the
tracer, metrics, SLO, flight recorder and incident capture come with the
observability slice (ROADMAP.md §1, observability)."""
from repro_torch.serve.obs.recompile import RecompileDetector

__all__ = ["RecompileDetector"]
