"""Recompile detection: captured keys per step (a copy of the reference's
``repro.serve.obs.recompile``, reading :class:`serve.capture.CapturedStep`
where the reference reads ``jax.jit`` wrappers).

The serving stack's steady-state contract is *no recompiles*: every hot
path runs fixed-shape steps captured at warmup (the per-bucket gateway
stages, the flat decode tick, one cascade tick per metadata bucket).  A
shape leak (a stray dimension, a new padding bucket) shows up as a capture
in steady state, which costs an eager run and a graph instantiation.  This
detector turns it into a metric:

    det = RecompileDetector()
    det.track("gateway", gw.jit_fns())        # anything with _cache_size()
    gw.warmup(...); det.snapshot()            # steady state begins here
    gw.run(traffic)
    det.steady_state_recompiles()             # 0, or the leak count

``jit_fns()`` surfaces are provided by the paged slot adapter, the
micro-batch gateway and the prompt gateway.
"""
from __future__ import annotations


class RecompileDetector:
    """Tracks named captured steps and diffs their key counts against a
    steady-state baseline snapshot."""

    def __init__(self):
        self._fns: dict[str, object] = {}
        self._baseline: dict[str, int] | None = None

    def track(self, prefix: str, fns: dict[str, object]) -> None:
        """Register named steps (anything exposing ``_cache_size()``)."""
        for name, fn in fns.items():
            if not hasattr(fn, "_cache_size"):
                raise TypeError(f"{prefix}.{name} is not a captured step")
            self._fns[f"{prefix}.{name}"] = fn

    def counts(self) -> dict[str, int]:
        """Current captured keys per tracked step."""
        return {name: fn._cache_size() for name, fn in self._fns.items()}

    def snapshot(self) -> dict[str, int]:
        """Mark the steady state: captures after this point count as
        recompiles."""
        self._baseline = self.counts()
        return dict(self._baseline)

    def deltas(self) -> dict[str, int]:
        """Per-step key growth since the snapshot (only growth: keys are
        never dropped, and a negative delta would mean the tracked step was
        swapped out from under us)."""
        if self._baseline is None:
            raise RuntimeError("snapshot() the steady state first")
        cur = self.counts()
        return {name: cur[name] - self._baseline.get(name, 0)
                for name in cur}

    def steady_state_recompiles(self) -> int:
        """Total captures since the steady-state snapshot: the metric
        (zero in a healthy serving loop)."""
        return sum(max(0, d) for d in self.deltas().values())

    def report(self) -> dict:
        """Metric payload: per-step counts, deltas, and the flag."""
        deltas = self.deltas()
        return {
            "tracked_executables": len(self._fns),
            "cache_entries": self.counts(),
            "recompiles_by_fn": {k: v for k, v in deltas.items() if v > 0},
            "steady_state_recompiles": sum(max(0, d)
                                           for d in deltas.values()),
        }
