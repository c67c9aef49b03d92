"""Incident forensics: auto-captured, schema-validated debug bundles.

When the gateway degrades — the SLO engine crosses ``warn -> critical``, a
drop burst hits the admission door, the recompile detector sees a shape
leak, the energy ledger stops conserving, or an operator calls
``gateway.capture_incident(reason=...)`` — :class:`IncidentCapture`
snapshots everything a post-hoc debugger needs into one size-bounded JSON
**incident bundle**:

  flight        the :class:`~repro_torch.serve.obs.flight.FlightRecorder` ring
                (recent spans/instants/counters/metric samples, with loss
                accounting), shrunk as needed to fit ``max_bytes``.
  slo           the burn-rate engine's full report: state, transition log,
                burn snapshot, per-objective totals, pressure events.
  state         the gateway's ``debug_state()``: resolved ServeSpec,
                pool/radix snapshots (stats, shared-chain summary,
                protected set), per-slice routing/handoff/cascade
                counters, jit-cache sizes, queue/slot occupancy.
  recompile     the detector's per-executable report, when one is armed.

Writes go through :func:`validate_incident_bundle` and **refuse on
invalid** — the same stance as the Chrome trace exporter: a malformed
bundle on disk is worse than a loud failure at capture time.

``python -m repro_torch.serve.obs.incident inspect|diff|critpath <bundle>``
inspects a bundle without the live process (summary, two-bundle diff, or a
critical-path ranking over the captured spans — see
:mod:`repro_torch.serve.obs.critpath`).
"""
from __future__ import annotations

import dataclasses
import json
import numbers
import pathlib
from collections import deque

from repro_torch.serve.obs import critpath
from repro_torch.serve.obs.export import _validate_event
from repro_torch.serve.obs.flight import FlightRecorder
from repro_torch.serve.obs.tracer import _bump

SCHEMA = "repro.incident.v1"

# automatic triggers (the explicit ``gateway.capture_incident(reason=...)``
# path may pass any other reason string)
TRIGGERS = ("slo_critical", "drop_burst", "recompile_leak",
            "energy_mismatch")


def _jsonify(obj):
    """Best-effort JSON coercion for bundle leaves: dataclasses (ServeSpec,
    PressureEvent), numpy scalars, sets, and anything else by repr."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, (set, frozenset)):
        return sorted(map(_jsonify, obj))
    if isinstance(obj, numbers.Integral):
        return int(obj)
    if isinstance(obj, numbers.Real):
        return float(obj)
    return repr(obj)


class IncidentCapture:
    """Trigger -> bundle pipeline.  Attach via ``ServeSpec(incident_dir=)``
    or construct directly and pass to a gateway (``incident=``).

    Parameters
    ----------
    out_dir:       bundle directory (created on first capture).
    flight:        FlightRecorder whose ring each bundle embeds.
    slo:           SLOMonitor; subscribing to its pressure signal arms the
                   ``warn -> critical`` trigger.  Because the signal fires
                   *synchronously inside* ``slo.evaluate`` — which the
                   serving loops run before the next admission pass — the
                   bundle exists before the first shed drop lands.
    detector:      RecompileDetector (snapshot taken); ``poll`` arms the
                   shape-leak trigger.
    drop_burst / drop_window_s:
                   >= drop_burst drops inside a drop_window_s sim-time
                   window trips the burst trigger.
    cooldown_s:    minimum sim time between *automatic* captures (explicit
                   captures always fire).
    max_bytes:     bundle size bound; the flight section is halved until
                   the serialized bundle fits.
    tag:           filename tag, for multiple capture pipelines sharing a
                   directory.
    """

    def __init__(self, out_dir: str = ".", *, flight: FlightRecorder | None
                 = None, slo=None, metrics=None, detector=None,
                 drop_burst: int = 8, drop_window_s: float = 0.25,
                 cooldown_s: float = 0.5, max_bytes: int = 256 * 1024,
                 tag: str = ""):
        self.out_dir = pathlib.Path(out_dir)
        self.flight = flight
        self.slo = slo
        self.metrics = metrics
        self.detector = detector
        self.drop_burst = drop_burst
        self.drop_window_s = drop_window_s
        self.cooldown_s = cooldown_s
        self.max_bytes = max_bytes
        self.tag = tag
        self.captures: list[dict] = []     # {"path", "reason", "t", "seq"}
        self.context_fn = None             # gateway.debug_state, when wired
        self._drops: deque = deque()
        self._recompiles_seen = 0
        self._last_auto_t: float | None = None
        self._t = 0.0                      # latest sim time observed
        if slo is not None:
            slo.pressure.subscribe(self._on_pressure)

    # -- triggers -----------------------------------------------------------

    def _on_pressure(self, event) -> None:
        self._t = max(self._t, event.t)
        if event.state == "critical":
            self._capture_auto("slo_critical", event.t,
                               extra={"from": event.prev,
                                      "objective": event.worst})

    def observe_drop(self, t: float) -> None:
        """One admission drop at sim time ``t`` (the serving loops call
        this next to ``Telemetry.drop``)."""
        _bump()
        self._t = max(self._t, t)
        self._drops.append(t)
        while self._drops and self._drops[0] < t - self.drop_window_s:
            self._drops.popleft()
        if len(self._drops) >= self.drop_burst:
            if self._capture_auto("drop_burst", t,
                                  extra={"drops_in_window":
                                         len(self._drops),
                                         "window_s": self.drop_window_s}):
                self._drops.clear()

    def poll(self, t: float) -> None:
        """Per-tick trigger check: recompile leaks (when a snapshot-armed
        detector is attached)."""
        _bump()
        self._t = max(self._t, t)
        if self.detector is None or self.detector._baseline is None:
            return
        cur = self.detector.steady_state_recompiles()
        if cur > self._recompiles_seen:
            leaked = self._capture_auto(
                "recompile_leak", t,
                extra={"recompiles": cur,
                       "by_fn": {k: v for k, v in
                                 self.detector.deltas().items() if v > 0}})
            if leaked:
                self._recompiles_seen = cur

    def check_energy(self, telemetry, t: float | None = None) -> bool:
        """End-of-run conservation check: a ledger that no longer folds to
        the fleet total captures an ``energy_mismatch`` bundle.  Returns
        True when conservation held."""
        _bump()
        try:
            telemetry.assert_conserved()
            return True
        except AssertionError as e:
            self._capture_auto("energy_mismatch",
                               self._t if t is None else t,
                               extra={"error": str(e)})
            return False

    # -- capture ------------------------------------------------------------

    def _capture_auto(self, reason: str, t: float, extra=None) -> bool:
        if self._last_auto_t is not None and \
                t < self._last_auto_t + self.cooldown_s:
            return False
        self.capture(reason, t=t, extra=extra)
        self._last_auto_t = t
        return True

    def capture(self, reason: str, *, t: float | None = None,
                extra=None) -> str:
        """Snapshot everything into a validated bundle file; returns its
        path.  Explicit captures bypass the cooldown."""
        _bump()
        t = self._t if t is None else t
        bundle = {
            "schema": SCHEMA,
            "reason": reason,
            "t": t,
            "seq": len(self.captures),
            "trigger_detail": extra or {},
            "flight": self.flight.snapshot()
            if self.flight is not None else None,
            "slo": self.slo.report() if self.slo is not None else None,
            "state": self.context_fn() if self.context_fn is not None
            else {},
            "recompile": self.detector.report()
            if self.detector is not None
            and self.detector._baseline is not None else None,
        }
        self.out_dir.mkdir(parents=True, exist_ok=True)
        name = f"incident_{self.tag + '_' if self.tag else ''}" \
               f"{bundle['seq']:03d}_{reason}.json"
        path = self.out_dir / name
        write_incident_bundle(str(path), bundle,
                              max_bytes=self.max_bytes)
        self.captures.append({"path": str(path), "reason": reason,
                              "t": t, "seq": bundle["seq"]})
        return str(path)


# ==========================================================================
# Bundle schema + refuse-on-invalid writer (the Chrome-exporter stance).
# ==========================================================================

_TOP_FIELDS = {"schema": str, "reason": str, "t": numbers.Real,
               "seq": numbers.Integral, "trigger_detail": dict,
               "state": dict}
_FLIGHT_LISTS = ("spans", "instants", "counters", "meta", "samples")
_ACCT_PAIRS = (("spans_seen", "spans_kept"),
               ("instants_seen", "instants_kept"),
               ("counters_seen", "counters_kept"),
               ("samples_seen", "samples_kept"))


def validate_incident_bundle(bundle) -> list[str]:
    """Structural schema check; [] means valid.  Mirrors
    ``validate_chrome_trace``: every violation is named, and the writer
    refuses to put an invalid bundle on disk."""
    errs: list[str] = []
    if not isinstance(bundle, dict):
        return ["bundle: not an object"]
    for name, typ in _TOP_FIELDS.items():
        if name not in bundle:
            errs.append(f"bundle: missing field '{name}'")
        elif not isinstance(bundle[name], typ) or \
                isinstance(bundle[name], bool):
            errs.append(f"bundle: field '{name}' is "
                        f"{type(bundle[name]).__name__}")
    if "schema" in bundle and bundle["schema"] != SCHEMA:
        errs.append(f"bundle: schema {bundle.get('schema')!r} != {SCHEMA!r}")
    if not bundle.get("reason"):
        errs.append("bundle: empty reason")
    for key in ("flight", "slo", "recompile"):
        if key not in bundle:
            errs.append(f"bundle: missing field '{key}' (may be null)")
    fl = bundle.get("flight")
    if fl is not None:
        if not isinstance(fl, dict):
            errs.append("flight: not an object")
        else:
            for key in _FLIGHT_LISTS:
                if not isinstance(fl.get(key), list):
                    errs.append(f"flight: '{key}' missing or not a list")
            acct = fl.get("accounting")
            if not isinstance(acct, dict):
                errs.append("flight: missing accounting")
            else:
                for seen, kept in _ACCT_PAIRS:
                    if not isinstance(acct.get(seen), numbers.Integral) or \
                            not isinstance(acct.get(kept),
                                           numbers.Integral):
                        errs.append(f"flight: accounting {seen}/{kept} "
                                    f"missing or non-integral")
                    elif acct[seen] < acct[kept]:
                        errs.append(f"flight: accounting {seen} "
                                    f"({acct[seen]}) < {kept} "
                                    f"({acct[kept]})")
            for stream in ("spans", "instants", "counters"):
                for i, e in enumerate(fl.get(stream) or []):
                    errs += _validate_event(e, f"flight.{stream}[{i}]")
    slo = bundle.get("slo")
    if slo is not None:
        if not isinstance(slo, dict) or "state" not in slo \
                or "transitions" not in slo:
            errs.append("slo: missing state/transitions")
    return errs


def write_incident_bundle(path: str, bundle: dict, *,
                          max_bytes: int | None = None) -> int:
    """Validate, size-bound (shrinking the flight section), and write.
    Raises ``ValueError`` on an invalid bundle — never writes one.
    Returns the byte size written."""
    errs = validate_incident_bundle(bundle)
    if errs:
        raise ValueError(
            f"refusing to write invalid incident bundle {path}: "
            + "; ".join(errs[:5]))
    text = json.dumps(bundle, indent=1, default=_jsonify)
    if max_bytes is not None:
        while len(text) > max_bytes and bundle.get("flight") is not None:
            fl = bundle["flight"]
            shrunk = FlightRecorder.shrink(fl)
            if sum(len(shrunk[k]) for k in _FLIGHT_LISTS) == \
                    sum(len(fl[k]) for k in _FLIGHT_LISTS):
                # nothing left to halve: drop the ring, keep accounting
                shrunk = {"accounting": fl["accounting"],
                          "config": fl.get("config", {}),
                          **{k: [] for k in _FLIGHT_LISTS}}
                bundle = {**bundle, "flight": shrunk}
                text = json.dumps(bundle, indent=1, default=_jsonify)
                break
            bundle = {**bundle, "flight": shrunk}
            text = json.dumps(bundle, indent=1, default=_jsonify)
        if len(text) > max_bytes:
            raise ValueError(
                f"incident bundle {path} cannot fit max_bytes="
                f"{max_bytes} even with an empty flight ring "
                f"({len(text)} bytes)")
    errs = validate_incident_bundle(json.loads(text))
    if errs:
        raise ValueError(
            f"refusing to write invalid incident bundle {path}: "
            + "; ".join(errs[:5]))
    with open(path, "w") as f:
        f.write(text)
    return len(text)


def load_incident_bundle(path: str) -> dict:
    """Read + validate a bundle; raises ``ValueError`` (with the schema
    errors, or the JSON parse failure for a truncated file) on anything
    invalid."""
    try:
        with open(path) as f:
            bundle = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable incident bundle ({e})")
    errs = validate_incident_bundle(bundle)
    if errs:
        raise ValueError(f"{path}: invalid incident bundle: "
                         + "; ".join(errs[:8]))
    return bundle


# ==========================================================================
# CLI inspector: debug a bundle without the live process.
# ==========================================================================

def _fmt_acct(acct: dict) -> str:
    return ", ".join(f"{seen.split('_')[0]} {acct[kept]}/{acct[seen]}"
                     for seen, kept in _ACCT_PAIRS)


def _inspect(bundle: dict) -> None:
    print(f"incident: reason={bundle['reason']}  t={bundle['t']:.3f}s  "
          f"seq={bundle['seq']}  schema={bundle['schema']}")
    if bundle.get("trigger_detail"):
        print(f"  trigger: {bundle['trigger_detail']}")
    fl = bundle.get("flight")
    if fl:
        print(f"  flight: {_fmt_acct(fl['accounting'])} (kept/seen)")
        for e in fl["instants"][-5:]:
            print(f"    instant t={e['ts']:.4f} {e['name']} "
                  f"{e.get('args', {})}")
    slo = bundle.get("slo")
    if slo:
        burns = "  ".join(f"burn_{k}={v:.2f}"
                          for k, v in sorted(slo.get("burns", {}).items()))
        print(f"  slo: state={slo['state']}  "
              f"transitions={len(slo['transitions'])}  {burns}")
        for tr in slo["transitions"]:
            print(f"    t={tr['t']:.3f}s {tr['from']} -> {tr['to']} "
                  f"(worst: {tr['objective']})")
    rc = bundle.get("recompile")
    if rc:
        print(f"  recompile: {rc['steady_state_recompiles']} steady-state "
              f"over {rc['tracked_executables']} executables"
              + (f"  leaks={rc['recompiles_by_fn']}"
                 if rc.get("recompiles_by_fn") else ""))
    state = bundle.get("state") or {}
    for key in sorted(state):
        v = state[key]
        if isinstance(v, dict):
            flat = {k: v[k] for k in sorted(v)
                    if isinstance(v[k], (int, float, str, bool))}
            print(f"  state.{key}: {flat}" if flat
                  else f"  state.{key}: [{len(v)} entries]")
        else:
            print(f"  state.{key}: {v}")


def _num_leaves(obj, prefix="") -> dict[str, float]:
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k in obj:
            out.update(_num_leaves(obj[k], f"{prefix}.{k}" if prefix
                                   else str(k)))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = float(obj)
    return out


def _diff(a: dict, b: dict) -> None:
    print(f"A: reason={a['reason']} t={a['t']:.3f}s   "
          f"B: reason={b['reason']} t={b['t']:.3f}s")
    sa = (a.get("slo") or {}).get("state")
    sb = (b.get("slo") or {}).get("state")
    if sa != sb:
        print(f"  slo.state: {sa} -> {sb}")
    la = _num_leaves({"state": a.get("state"),
                      "flight": (a.get("flight") or {}).get("accounting")})
    lb = _num_leaves({"state": b.get("state"),
                      "flight": (b.get("flight") or {}).get("accounting")})
    changed = sorted(k for k in la.keys() | lb.keys()
                     if la.get(k) != lb.get(k))
    for k in changed:
        print(f"  {k}: {la.get(k)} -> {lb.get(k)}")
    if not changed and sa == sb:
        print("  no numeric differences")


def _critpath(bundle: dict) -> None:
    fl = bundle.get("flight") or {}
    cps = critpath.analyze(fl.get("spans") or [])
    roles = bool((bundle.get("state") or {}).get("roles"))
    agg = critpath.aggregate(cps, roles=roles)
    print(f"critical path over {agg['requests']} captured request(s) "
          f"(exact re-fold: {agg['exact']})")
    for stage in agg.get("ranking", []):
        rec = agg["stages"][stage]
        print(f"  {stage:14s} {rec['share']:6.1%}  "
              f"{rec['total_s'] * 1e3:9.3f} ms  "
              f"dominates {rec['requests_dominated']} request(s)")
    if agg["requests"]:
        print(f"  p{int(agg['p'] * 100)} tail ({agg['p_dur'] * 1e3:.3f} ms)"
              f" dominated by: {agg['p_dominant']}")
    for role, rec in sorted(agg.get("by_role", {}).items()):
        print(f"  role {role:9s} {rec['share']:6.1%}  "
              f"stages: {', '.join(rec['stages'])}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.obs.incident",
        description="Inspect incident bundles without the live process.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ins = sub.add_parser("inspect", help="summarize one bundle")
    p_ins.add_argument("bundle")
    p_diff = sub.add_parser("diff", help="numeric diff of two bundles")
    p_diff.add_argument("bundle_a")
    p_diff.add_argument("bundle_b")
    p_cp = sub.add_parser("critpath",
                          help="critical-path ranking over captured spans")
    p_cp.add_argument("bundle")
    args = ap.parse_args(argv)
    try:
        if args.cmd == "inspect":
            _inspect(load_incident_bundle(args.bundle))
        elif args.cmd == "diff":
            _diff(load_incident_bundle(args.bundle_a),
                  load_incident_bundle(args.bundle_b))
        else:
            _critpath(load_incident_bundle(args.bundle))
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
