"""Named time-series metrics with periodic interval snapshots.

Replaces end-of-run aggregate dicts with counters, gauges, and histograms
sampled on a configurable virtual-time tick: the serving loops call
:meth:`MetricsRegistry.maybe_sample` every iteration, and the registry
snapshots at most once per ``interval_s`` of sim time — so a run yields
occupancy-over-time *curves* (pool blocks in use, queue depth, per-slice
load, migration/spill totals) instead of a single high-water mark.

Three instrument kinds:

  counter    monotone cumulative float (``inc``); snapshots carry the
             running value, so interval rates are first differences.
  gauge      instantaneous value; either pushed (``set_gauge``) or pulled —
             ``register(name, fn)`` samples ``fn()`` at snapshot time,
             which is how pool occupancy and queue depth are wired without
             the pool knowing the registry exists.
  histogram  value stream (``observe``); ``percentiles`` summarizes with
             the sample count attached (tiny-sample p99s are reported, but
             ``n`` rides along so gates can demand minimum counts).
             Retention is **capped** at ``hist_cap`` observations per
             histogram: beyond the cap, new values enter a uniform
             reservoir (Vitter's algorithm R, deterministic rng) so the
             percentile summary stays an unbiased estimate over the whole
             stream with bounded memory on long runs.  Truncation is never
             silent — ``percentiles`` carries ``n`` (everything observed)
             and ``n_dropped`` (observations no longer retained), and below
             the cap summaries are exact.

Snapshots are plain dicts (``{"t": ..., name: value, ...}``) so they drop
straight into ``Telemetry.record_series`` / the JSONL exporter.
"""
from __future__ import annotations

import numpy as np


class MetricsRegistry:
    """Counters / gauges / histograms + interval snapshot sampler."""

    def __init__(self, interval_s: float = 0.05, hist_cap: int = 4096,
                 seed: int = 0, sink=None):
        assert interval_s > 0, "snapshot interval must be positive"
        assert hist_cap > 0, "histogram retention cap must be positive"
        self.interval_s = interval_s
        self.hist_cap = hist_cap
        # optional per-snapshot sink (flight.FlightRecorder.observe_sample):
        # each interval record is delivered as it is taken, so a bounded
        # ring can keep the recent tail without re-walking ``samples``
        self.sink = sink
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, list[float]] = {}
        self.hist_counts: dict[str, int] = {}     # everything ever observed
        self._sources: dict[str, object] = {}     # pulled gauges: name -> fn
        self.samples: list[dict] = []
        self._next_t: float | None = None
        # reservoir replacement draws are deterministic (seeded) so capped
        # summaries are reproducible run to run
        self._rng = np.random.default_rng(seed)

    # -- instruments ---------------------------------------------------------

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + v

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def register(self, name: str, fn) -> None:
        """Pull-mode gauge: ``fn()`` is read at each snapshot."""
        self._sources[name] = fn

    def observe(self, name: str, v: float) -> None:
        """Record one histogram observation.  The first ``hist_cap`` values
        are retained exactly; past the cap the retained set becomes a
        uniform reservoir (each of the ``n`` observations so far kept with
        probability ``hist_cap / n``), so memory stays bounded on long
        runs while percentiles remain unbiased over the whole stream."""
        vals = self.hists.setdefault(name, [])
        n = self.hist_counts.get(name, 0) + 1
        self.hist_counts[name] = n
        if len(vals) < self.hist_cap:
            vals.append(float(v))
        else:
            j = int(self._rng.integers(0, n))     # algorithm R
            if j < self.hist_cap:
                vals[j] = float(v)

    def hist_dropped(self, name: str) -> int:
        """Observations of ``name`` no longer retained under ``hist_cap``
        (0 while the stream fits — truncation is explicit, not silent)."""
        return self.hist_counts.get(name, 0) - len(self.hists.get(name, []))

    # -- sampling ------------------------------------------------------------

    def snapshot(self, t: float) -> dict:
        """One interval record: sim time + every counter, pushed gauge,
        and pulled source value."""
        rec: dict = {"t": t}
        rec.update(self.counters)
        rec.update(self.gauges)
        for name, fn in self._sources.items():
            rec[name] = fn()
        self.samples.append(rec)
        if self.sink is not None:
            self.sink(rec)
        return rec

    def maybe_sample(self, t: float) -> bool:
        """Snapshot iff ``interval_s`` of sim time has passed since the
        last snapshot (the first call snapshots immediately, anchoring the
        series at the run's start).  Returns whether a sample was taken."""
        if self._next_t is not None and t < self._next_t:
            return False
        self.snapshot(t)
        self._next_t = t + self.interval_s
        return True

    # -- summaries -----------------------------------------------------------

    def series(self, name: str) -> tuple[list[float], list[float]]:
        """(t, value) arrays for one metric across the snapshots taken
        (snapshots missing the metric — taken before it was registered —
        are skipped)."""
        ts, vs = [], []
        for s in self.samples:
            if name in s:
                ts.append(s["t"])
                vs.append(s[name])
        return ts, vs

    def percentiles(self, name: str, qs=(50, 99)) -> dict:
        """Histogram summary with the sample counts attached — small-n
        percentiles are noise, and ``n`` lets consumers gate on it.  ``n``
        counts every observation ever made; ``n_dropped`` is how many of
        those the retention cap evicted from the reservoir (0 = the
        summary is exact, >0 = it is a uniform-sample estimate)."""
        vals = self.hists.get(name, [])
        out = {"n": self.hist_counts.get(name, 0),
               "n_dropped": self.hist_dropped(name)}
        if vals:
            a = np.asarray(vals)
            for q in qs:
                out[f"p{q}"] = float(np.percentile(a, q))
        return out
