"""Always-on flight recorder: a bounded ring buffer over the trace stream.

The tracer is opt-in and forward-only — when an incident finally
happens, the spans that explain it were either never recorded or live in an
unbounded list nobody can afford to keep on a long-running gateway.  The
:class:`FlightRecorder` closes that gap: it attaches as a :class:`Tracer`
sink (``Tracer(sink=flight)`` — the same hook the span-stream writer uses)
and keeps a *bounded*, statistically honest picture of the recent past:

  spans ("X")     seeded reservoir (algorithm R, the same scheme the
                  metrics histograms use): every span ever emitted has an
                  equal chance of surviving, so a post-hoc critical-path
                  ranking over the ring is unbiased — a plain tail would
                  only ever show the last tick.
  instants ("i")  exact tail (deque): drops, SLO transitions and
                  prefix-resume markers are rare and the *most recent* ones
                  are exactly what an incident bundle needs verbatim.
  counters ("C")  exact tail.
  metadata ("M")  kept in full up to a small cap (process/track names).
  samples         exact tail of interval metric snapshots, fed by
                  ``MetricsRegistry(sink=flight.observe_sample)``.

The fast path allocates nothing per event: the tracer's own finished-event
dicts are stored by reference (a flight-only run uses
``Tracer(retain=False)`` so the recorder's ring is the *only* retention),
and an event past capacity costs one RNG draw plus at most one list store.
Every entry point charges the module callback counter, so the
zero-cost-when-disabled pin covers the recorder too.

``snapshot()`` returns a plain-JSON view (spans sorted by start time,
accounting fields making any loss explicit) — the incident bundle embeds it
verbatim and ``shrink()`` lets the bundle writer halve the ring until the
bundle fits its size bound.
"""
from __future__ import annotations

import random
from collections import deque

from repro_torch.serve.obs.tracer import _bump


class FlightRecorder:
    """Bounded ring buffer of trace events + metric samples.

    Parameters
    ----------
    span_cap, instant_cap, counter_cap, sample_cap, meta_cap:
        retention bounds per stream.  Spans use reservoir sampling; the
        other streams keep an exact tail.
    seed:
        reservoir RNG seed — two recorders over the same event stream keep
        the same spans.
    """

    def __init__(self, *, span_cap: int = 512, instant_cap: int = 256,
                 counter_cap: int = 256, sample_cap: int = 128,
                 meta_cap: int = 64, seed: int = 0):
        if min(span_cap, instant_cap, counter_cap, sample_cap, meta_cap) < 1:
            raise ValueError("flight recorder capacities must be >= 1")
        self.span_cap = span_cap
        self._rng = random.Random(seed)
        self._seed = seed
        self.spans: list[dict] = []         # reservoir, insertion order
        self.instants: deque = deque(maxlen=instant_cap)
        self.counters: deque = deque(maxlen=counter_cap)
        self.meta: list[dict] = []
        self.meta_cap = meta_cap
        self.samples: deque = deque(maxlen=sample_cap)
        # accounting: seen counts make any loss explicit in the snapshot
        self.spans_seen = 0
        self.instants_seen = 0
        self.counters_seen = 0
        self.samples_seen = 0

    # -- ingest (tracer sink + metrics sink) --------------------------------

    def __call__(self, event: dict) -> None:
        """Tracer sink: one finished span/instant/counter/metadata event.
        Stores the tracer's dict by reference — no copy on the hot path."""
        _bump()
        ph = event["ph"]
        if ph == "X":
            self.spans_seen += 1
            if len(self.spans) < self.span_cap:
                self.spans.append(event)
            else:
                # algorithm R: keep each of the n seen so far with
                # probability cap/n — uniform over the whole run
                j = self._rng.randrange(self.spans_seen)
                if j < self.span_cap:
                    self.spans[j] = event
        elif ph == "i":
            self.instants_seen += 1
            self.instants.append(event)
        elif ph == "C":
            self.counters_seen += 1
            self.counters.append(event)
        elif len(self.meta) < self.meta_cap:
            self.meta.append(event)

    def observe_sample(self, snap: dict) -> None:
        """Metrics sink: one interval snapshot (``MetricsRegistry(sink=)``)."""
        _bump()
        self.samples_seen += 1
        self.samples.append(snap)

    # -- views --------------------------------------------------------------

    @property
    def spans_dropped(self) -> int:
        return self.spans_seen - len(self.spans)

    def snapshot(self) -> dict:
        """Plain-JSON view of the ring: the incident bundle's ``flight``
        section.  Spans come out sorted by start time (the reservoir holds
        them in replacement order); accounting fields state exactly what
        was lost to the bounds."""
        _bump()
        return {
            "spans": sorted(self.spans, key=lambda e: (e["ts"], e["tid"])),
            "instants": list(self.instants),
            "counters": list(self.counters),
            "meta": list(self.meta),
            "samples": list(self.samples),
            "accounting": {
                "spans_seen": self.spans_seen,
                "spans_kept": len(self.spans),
                "spans_dropped": self.spans_dropped,
                "instants_seen": self.instants_seen,
                "instants_kept": len(self.instants),
                "counters_seen": self.counters_seen,
                "counters_kept": len(self.counters),
                "samples_seen": self.samples_seen,
                "samples_kept": len(self.samples),
            },
            "config": {"span_cap": self.span_cap,
                       "instant_cap": self.instants.maxlen,
                       "counter_cap": self.counters.maxlen,
                       "sample_cap": self.samples.maxlen,
                       "seed": self._seed},
        }

    @staticmethod
    def shrink(snap: dict) -> dict:
        """Halve a snapshot's retained content (oldest entries first for the
        tails, tail of the reservoir for spans), preserving the accounting.
        The incident writer calls this until the bundle fits its size
        bound; ``*_kept`` fields track the shrink so a validator can tell a
        deliberately-shrunk bundle from a truncated file."""
        out = {k: v for k, v in snap.items()}
        acct = dict(snap["accounting"])
        for key in ("spans", "instants", "counters", "samples"):
            kept = snap[key]
            keep = max(1, len(kept) // 2) if kept else 0
            out[key] = kept[-keep:] if keep else []
            acct[f"{key}_kept"] = len(out[key])
        acct["spans_dropped"] = acct["spans_seen"] - acct["spans_kept"]
        out["accounting"] = acct
        return out
