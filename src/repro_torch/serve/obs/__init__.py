"""Observability of the port.  Only the virtual clock is here so far; the
tracer, metrics, SLO, flight recorder and incident capture come with the
observability slice (ROADMAP.md §1 item 13)."""
