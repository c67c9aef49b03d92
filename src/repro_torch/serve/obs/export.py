"""Exporters: Chrome trace JSON, span-stream JSONL, metrics JSONL, OpenMetrics.

The trace format is the Chrome trace-event *JSON object format*
(``{"traceEvents": [...]}``) with complete-duration events (``ph: "X"``),
instants (``"i"``), counters (``"C"``), and process-name metadata
(``"M"``) — the subset Perfetto's legacy-trace importer accepts, so
``chrome://tracing`` and https://ui.perfetto.dev open the file directly.
Timestamps convert from the tracer's sim-clock seconds to the format's
microseconds.  Long runs can bound the export with ``max_events``; the cut
is never silent — a ``trace_truncated`` instant carrying the drop count is
appended where the stream was cut.  For runs too long to hold in memory at
all, :class:`SpanStreamWriter` plugs into ``Tracer(sink=...)`` and streams
each finished event to JSONL as it is recorded.

:func:`validate_chrome_trace` is the schema gate CI runs over exported
traces: structural errors (missing fields, bad phases, negative durations,
non-numeric timestamps) are returned as a list so the pipeline fails
loudly instead of shipping a trace Perfetto would silently drop events
from.  The span-stream writer validates each event against the same
per-event checks at write time.

:func:`openmetrics_text` renders a finished run's metrics registry (and,
optionally, the SLO monitor's burn state) in the OpenMetrics text
exposition format — counters as ``_total`` samples, gauges, histogram
summaries with quantile labels — terminated by ``# EOF``, so a run's
health surface scrapes like a production server's ``/metrics`` endpoint.
:func:`validate_openmetrics` is its structural gate.
"""
from __future__ import annotations

import json
import re

_VALID_PHASES = {"X", "i", "C", "M"}


def _validate_event(e, where: str) -> list[str]:
    """Per-event structural checks, shared by the whole-trace validator
    and the incremental span-stream writer."""
    if not isinstance(e, dict):
        return [f"{where}: not an object"]
    errs: list[str] = []
    for field in ("name", "ph", "pid", "tid", "ts"):
        if field not in e:
            errs.append(f"{where}: missing '{field}'")
    ph = e.get("ph")
    if ph not in _VALID_PHASES:
        errs.append(f"{where}: unknown phase {ph!r}")
    if not isinstance(e.get("ts"), (int, float)) or \
            isinstance(e.get("ts"), bool):
        errs.append(f"{where}: non-numeric ts {e.get('ts')!r}")
    if ph == "X":
        dur = e.get("dur")
        if not isinstance(dur, (int, float)) or isinstance(dur, bool):
            errs.append(f"{where}: X event missing numeric dur")
        elif dur < 0:
            errs.append(f"{where}: negative dur {dur}")
    if ph == "C" and not isinstance(e.get("args"), dict):
        errs.append(f"{where}: counter event without args dict")
    if "args" in e and not isinstance(e["args"], dict):
        errs.append(f"{where}: args is not an object")
    return errs


def chrome_trace(tracer, metrics=None,
                 process_names: dict[int, str] | None = None,
                 max_events: int | None = None) -> dict:
    """Assemble the Chrome trace-event object from a finished tracer
    (and, optionally, a metrics registry whose interval snapshots become
    counter tracks — occupancy curves right inside the trace UI).

    ``max_events`` bounds how many tracer events are exported (the
    chronological prefix is kept); the cut is marked by an explicit
    ``trace_truncated`` instant carrying the drop count — truncation is
    visible in the trace itself, never silent.  Metadata and metric
    counter tracks ride outside the cap.
    """
    evs: list[dict] = []
    pids = set()
    src = tracer.events
    dropped = 0
    if max_events is not None and len(src) > max_events:
        dropped = len(src) - max_events
        src = src[:max_events]
    for e in src:
        ev = {"name": e["name"], "ph": e["ph"], "pid": e["pid"],
              "tid": e["tid"], "ts": e["ts"] * 1e6, "args": e["args"]}
        if e["ph"] == "X":
            ev["dur"] = e["dur"] * 1e6
        if e["ph"] == "i":
            ev["s"] = e.get("s", "t")
        evs.append(ev)
        pids.add(e["pid"])
    if dropped:
        t_cut = evs[-1]["ts"] if evs else 0.0
        evs.append({"name": "trace_truncated", "ph": "i", "pid": 1,
                    "tid": 0, "ts": t_cut, "s": "t",
                    "args": {"dropped_events": dropped,
                             "max_events": max_events}})
        pids.add(1)
    if metrics is not None:
        for snap in metrics.samples:
            args = {k: v for k, v in snap.items() if k != "t"}
            if args:
                evs.append({"name": "metrics", "ph": "C", "pid": 1,
                            "tid": 0, "ts": snap["t"] * 1e6, "args": args})
                pids.add(1)
    names = {0: "requests", 1: "engine"}
    if process_names:
        names.update(process_names)
    for pid in sorted(pids):
        evs.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "ts": 0.0,
                    "args": {"name": names.get(pid, f"slice{pid - 1}")}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer, metrics=None,
                       process_names: dict[int, str] | None = None,
                       max_events: int | None = None) -> dict:
    """Export + write; returns the trace object (already validated —
    writing an invalid trace is a bug, not an artifact)."""
    obj = chrome_trace(tracer, metrics, process_names, max_events)
    errs = validate_chrome_trace(obj)
    if errs:
        raise AssertionError("refusing to write invalid trace: "
                             + "; ".join(errs[:5]))
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Structural schema check for the trace-event object format.
    Returns the (possibly empty) list of violations."""
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing/invalid 'traceEvents' array"]
    errs: list[str] = [] if evs else ["empty traceEvents"]
    for i, e in enumerate(evs):
        errs.extend(_validate_event(e, f"traceEvents[{i}]"))
    return errs


class SpanStreamWriter:
    """Incremental JSONL span stream: one finished event per line.

    Plugs into ``Tracer(sink=writer)``: the tracer calls the writer with
    each finished span/instant/counter as it is recorded, so arbitrarily
    long runs stream to disk instead of relying on the in-memory event
    list.  Events are written in tracer-native form (sim-clock *seconds*,
    same fields the Chrome exporter reads) and each is checked against the
    structural validator before it hits the file — an instrumentation bug
    fails at record time, not at scrape time.

    Use as a context manager, or call :meth:`close` when the run ends.
    """

    def __init__(self, path: str, validate: bool = True):
        self.path = path
        self.validate = validate
        self.n_written = 0
        self._f = open(path, "w")

    def __call__(self, event: dict) -> None:
        if self.validate:
            errs = _validate_event(event, f"span_stream[{self.n_written}]")
            if errs:
                self._f.close()
                raise AssertionError("invalid event in span stream: "
                                     + "; ".join(errs))
        self._f.write(json.dumps(event) + "\n")
        self.n_written += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SpanStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_span_stream(path: str) -> list[dict]:
    """Load a :class:`SpanStreamWriter` JSONL file back into event dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_metrics_jsonl(path: str, registry) -> int:
    """One JSON line per interval snapshot (a benchmark harness consumes this).
    Returns the number of lines written."""
    with open(path, "w") as f:
        for snap in registry.samples:
            f.write(json.dumps(snap) + "\n")
    return len(registry.samples)


# -- OpenMetrics text exposition ---------------------------------------------

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                     r"(\{[^{}]*\})?"
                     r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"
                     r"|Inf)|NaN|\+Inf)$")


def _metric_name(raw: str) -> str:
    """Sanitize an internal metric name into the OpenMetrics charset."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", raw)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    return repr(float(v))


def openmetrics_text(metrics=None, slo=None, prefix: str = "repro") -> str:
    """Render the run's health surface in the OpenMetrics text format.

    ``metrics`` contributes counters (``<prefix>_<name>_total``), pushed
    and pulled gauges, and histogram summaries (quantile-labelled samples
    + ``_count``, with the retention cap's evictions surfaced as an
    explicit ``_dropped_total`` counter — no silent truncation on the
    scrape surface either).  ``slo`` contributes the health state gauge,
    per-objective burn-rate gauges, and good/bad event totals.  Terminated
    by ``# EOF`` per the spec; :func:`validate_openmetrics` checks the
    result structurally.
    """
    lines: list[str] = []
    seen: set[str] = set()

    def family(name: str, kind: str) -> str | None:
        # one family per name: the SLO monitor's burn gauges also live in
        # the metrics registry (series columns), so skip re-declaration
        if name in seen:
            return None
        seen.add(name)
        lines.append(f"# TYPE {name} {kind}")
        return name

    if metrics is not None:
        for raw, v in sorted(metrics.counters.items()):
            base = _metric_name(f"{prefix}_{raw}")
            base = base[:-6] if base.endswith("_total") else base
            if family(base, "counter"):
                lines.append(f"{base}_total {_fmt(v)}")
        gauges = dict(metrics.gauges)
        for raw, fn in metrics._sources.items():
            gauges[raw] = fn()                  # pulled at scrape time
        for raw, v in sorted(gauges.items()):
            name = family(_metric_name(f"{prefix}_{raw}"), "gauge")
            if name:
                lines.append(f"{name} {_fmt(v)}")
        for raw in sorted(metrics.hists):
            name = family(_metric_name(f"{prefix}_{raw}"), "summary")
            if not name:
                continue
            pct = metrics.percentiles(raw, qs=(50, 90, 99))
            for q in (50, 90, 99):
                if f"p{q}" in pct:
                    lines.append(f'{name}{{quantile="{q / 100}"}} '
                                 f"{_fmt(pct[f'p{q}'])}")
            lines.append(f"{name}_count {_fmt(pct['n'])}")
            if family(name + "_dropped", "counter"):
                lines.append(f"{name}_dropped_total "
                             f"{_fmt(pct['n_dropped'])}")
    if slo is not None:
        from repro_torch.serve.obs.slo import STATES
        name = family(f"{prefix}_slo_state", "gauge")
        if name:
            lines.append(f"{name} {_fmt(STATES.index(slo.state))}")
        for obj, burn in sorted(slo.last_burns.items()):
            # same family the monitor pushes as a metrics gauge — when both
            # surfaces are scraped the declaration above wins
            name = family(_metric_name(f"{prefix}_burn_{obj}"), "gauge")
            if name:
                lines.append(f"{name} {_fmt(burn)}")
        rep = slo.report()
        for obj, st in sorted(rep["objectives"].items()):
            base = _metric_name(f"{prefix}_slo_{obj}_bad")
            if family(base, "counter"):
                lines.append(f"{base}_total {_fmt(st['bad'])}")
            base = _metric_name(f"{prefix}_slo_{obj}_events")
            if family(base, "counter"):
                lines.append(f"{base}_total {_fmt(st['good'] + st['bad'])}")
        name = family(f"{prefix}_slo_transitions", "counter")
        if name:
            lines.append(f"{name}_total {_fmt(len(rep['transitions']))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_openmetrics(path: str, metrics=None, slo=None,
                      prefix: str = "repro",
                      require: list[str] | None = None) -> str:
    """Render + write; validated before it hits disk, like the trace.
    ``require`` names metric families the exposition must declare —
    the disaggregated gateway passes its per-role families so a scrape
    missing them fails here rather than in the dashboard."""
    text = openmetrics_text(metrics, slo, prefix)
    errs = validate_openmetrics(text, require=require)
    if errs:
        raise AssertionError("refusing to write invalid OpenMetrics: "
                             + "; ".join(errs[:5]))
    with open(path, "w") as f:
        f.write(text)
    return text


def validate_openmetrics(text, require: list[str] | None = None
                         ) -> list[str]:
    """Structural check of an OpenMetrics text exposition.  Verifies the
    ``# EOF`` terminator, comment/sample line grammar, metric-name
    charset, numeric sample values, that every sample's family was
    declared by a preceding ``# TYPE`` line, and that counter samples use
    the ``_total`` suffix.  ``require`` lists family names that must be
    declared (each missing one is a violation).  Returns the (possibly
    empty) violation list.
    """
    if not isinstance(text, str):
        return ["exposition is not a string"]
    errs: list[str] = []
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1]
    else:
        errs.append("exposition must end with a newline")
    if not lines or lines[-1] != "# EOF":
        errs.append("missing '# EOF' terminator")
    types: dict[str, str] = {}
    for i, line in enumerate(lines):
        where = f"line {i + 1}"
        if line == "# EOF":
            if i != len(lines) - 1:
                errs.append(f"{where}: '# EOF' before end of exposition")
            continue
        if line.startswith("#"):
            parts = line.split(" ")
            if len(parts) >= 4 and parts[1] == "TYPE":
                name, kind = parts[2], parts[3]
                if not _NAME_OK.match(name):
                    errs.append(f"{where}: bad metric name {name!r}")
                if kind not in ("counter", "gauge", "summary", "histogram",
                                "info", "unknown"):
                    errs.append(f"{where}: unknown metric type {kind!r}")
                if name in types:
                    errs.append(f"{where}: duplicate family {name!r}")
                types[name] = kind
            elif len(parts) >= 3 and parts[1] in ("HELP", "UNIT"):
                pass
            else:
                errs.append(f"{where}: malformed comment {line!r}")
            continue
        m = _SAMPLE.match(line)
        if not m:
            errs.append(f"{where}: malformed sample {line!r}")
            continue
        name = m.group(1)
        base = name
        for suffix in ("_total", "_count", "_sum", "_bucket", "_created"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        if base not in types:
            errs.append(f"{where}: sample {name!r} has no '# TYPE' family")
        elif types[base] == "counter" and not name.endswith(
                ("_total", "_created")):
            errs.append(f"{where}: counter sample {name!r} must end "
                        f"in '_total'")
    for name in require or ():
        if name not in types:
            errs.append(f"required family {name!r} not declared")
    return errs
