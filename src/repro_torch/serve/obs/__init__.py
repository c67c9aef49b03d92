"""Serving-wide observability: tracing, metrics, health verdicts, exporters.

The port of the reference's ``repro.serve.obs``.  Every module but the
cost model is the reference's own code (the tracer, metrics, SLO engine,
flight recorder, critical path, exporters and incident bundles run on the
host); the cost model counts FLOPs and bytes from the stages' shapes where
the reference asks XLA.  Instrumentation for the frame gateway, the prompt
gateway, the slot batcher and the paged KV adapter:

  tracer.py     per-request lifecycle spans over the virtual serving clock
                (arrival -> queue wait -> prefill chunks -> decode ticks ->
                completion), each completion carrying a stage-attributed
                energy breakdown that sums *bitwise* to the conserved
                telemetry ledger; spans over device work close after a
                synchronize.
  metrics.py    named counters / gauges / histograms (capped reservoir
                retention, explicit ``n_dropped``) with periodic interval
                snapshots.
  slo.py        SLO policy + multi-window burn-rate engine: ok/warn/critical
                health state machine over the serving clock, trace instants
                at transitions, burn-rate series columns, and the
                subscribable ``PressureSignal`` the prompt gateway's
                backpressure consumes.
  costmodel.py  per-stage roofline attribution: analytic FLOPs/bytes over
                the ``cost_args()`` registries, joined with measured span
                durations into achieved rates and compute- vs memory-bound
                verdicts, cross-checked against the energy ledger.
  export.py     Chrome trace-event (Perfetto-loadable) JSON export with
                bounded ``max_events``, an incremental JSONL span-stream
                writer, a JSONL metrics dump, an OpenMetrics text
                exposition, and structural validators for all of them.
  recompile.py  captured keys per captured step; flags steady-state
                captures as a metric.
  flight.py     always-on bounded ring buffer over the trace stream
                (reservoir-sampled spans, exact instant/counter/sample
                tails) — the recorder incident bundles snapshot.
  critpath.py   per-request critical-path attribution: the request span
                split exactly (float-equal re-fold) into its stage
                segments and a residual, aggregated into a
                which-stage-dominates-p99 ranking.
  incident.py   trigger -> bundle forensics: SLO warn->critical, drop
                bursts, recompile leaks, energy-conservation breaks and
                explicit captures snapshot the flight ring + gateway debug
                state into schema-validated, size-bounded JSON bundles,
                inspectable offline via
                ``python -m repro_torch.serve.obs.incident``.

The contract every instrumented hot path keeps: **disabled observability
costs zero Python-level callbacks** — call sites guard on ``is None`` and
the module-level :func:`callback_count` (which every obs entry point
charges) lets tests pin that the guards really short-circuit
(tests/test_torch_obs.py, tests/test_torch_slo.py).
"""
from repro_torch.serve.obs import critpath
from repro_torch.serve.obs.costmodel import (DEFAULT_RIDGE, analyze,
                                             attribute, span_for,
                                             stage_energy)
from repro_torch.serve.obs.critpath import (aggregate_critical_paths,
                                            analyze_critical_paths)
from repro_torch.serve.obs.export import (SpanStreamWriter, chrome_trace,
                                          openmetrics_text, read_span_stream,
                                          validate_chrome_trace,
                                          validate_openmetrics,
                                          write_chrome_trace,
                                          write_metrics_jsonl,
                                          write_openmetrics)
from repro_torch.serve.obs.flight import FlightRecorder
from repro_torch.serve.obs.metrics import MetricsRegistry
from repro_torch.serve.obs.recompile import RecompileDetector
from repro_torch.serve.obs.slo import (BurnWindow, PressureEvent,
                                       PressureSignal, SLObjective,
                                       SLOMonitor, SLOPolicy)
from repro_torch.serve.obs.tracer import (ENGINE_PID, REQUESTS_PID,
                                          SimClock, Tracer, callback_count)

# incident.py is also the CLI module
# (`python -m repro_torch.serve.obs.incident`); importing it eagerly here
# would load it twice under -m (runpy warns), so its names resolve lazily
# on first attribute access (PEP 562)
_INCIDENT_NAMES = ("IncidentCapture", "load_incident_bundle",
                   "validate_incident_bundle", "write_incident_bundle")


def __getattr__(name: str):
    if name in _INCIDENT_NAMES:
        from repro_torch.serve.obs import incident
        return getattr(incident, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ENGINE_PID", "MetricsRegistry", "RecompileDetector", "REQUESTS_PID",
    "SimClock", "Tracer", "callback_count",
    "BurnWindow", "PressureEvent", "PressureSignal", "SLObjective",
    "SLOMonitor", "SLOPolicy",
    "DEFAULT_RIDGE", "analyze", "attribute", "span_for", "stage_energy",
    "SpanStreamWriter", "chrome_trace", "openmetrics_text",
    "read_span_stream", "validate_chrome_trace", "validate_openmetrics",
    "write_chrome_trace", "write_metrics_jsonl", "write_openmetrics",
    "FlightRecorder", "critpath",
    "aggregate_critical_paths", "analyze_critical_paths",
    "IncidentCapture", "load_incident_bundle", "validate_incident_bundle",
    "write_incident_bundle",
]
