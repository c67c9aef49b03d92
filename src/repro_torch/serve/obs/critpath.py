"""Request critical-path attribution over the span stream.

Per completed request, split the end-to-end ``request`` span exactly into
attributed segments — ``queue_wait`` / ``prefill`` (chunked folds) /
``handoff`` / ``decode`` ticks / ``migrate`` — plus one explicit
``unattributed`` residual (scheduler gaps between stages, e.g. a prefilled
lane parked awaiting a decode-slice handoff slot).  The contract mirrors
the span stream's energy re-fold: a left-fold of a request's segment durations
reproduces the request span's ``dur`` with **float equality**, not a
tolerance — the residual is constructed against the same fold order the
verifier uses, so "the segments explain the whole latency" is a checkable
invariant, not a rounding hope.

``aggregate`` turns per-request attributions into a serving critical-path
ranking: which stage dominates total latency, which stage dominates the
slowest (p99) requests, and — under a disaggregated ``RolePlan`` — the same
shares grouped by the role that executes each stage (queue/prefill work on
the prefill tier, ticks/migrations on the decode tier, handoffs on the
boundary between them).

Works on any event list shaped like the tracer's: the live
``Tracer.events``, a flight-recorder snapshot's ``spans`` (reservoir
sampling may have dropped children — the residual absorbs them and
``complete`` is marked accordingly), or an incident bundle.
"""
from __future__ import annotations

from repro_torch.serve.obs.tracer import REQUESTS_PID, _bump

# child span name -> critical-path stage
STAGES = ("queue_wait", "prefill", "handoff", "decode", "migrate",
          "sensor_link", "service", "unattributed")

# stage -> executing role under a disaggregated RolePlan (sharded
# serving, not ported yet): queue and chunked prefill run on the prefill
# tier, ticks and migrations on the decode tier, the handoff copy on the
# boundary between them; the frame path's stages and the residual belong
# to neither tier
STAGE_ROLE = {"queue_wait": "prefill", "prefill": "prefill",
              "handoff": "boundary", "decode": "decode",
              "migrate": "decode", "sensor_link": "frontend",
              "service": "frontend", "unattributed": "overhead"}


def fold(durs) -> float:
    """The canonical left-fold — the verifier and the residual constructor
    must agree on association order for float equality to be meaningful."""
    total = 0.0
    for d in durs:
        total += d
    return total


def _exact_residual(total: float, durs: list[float]) -> float | None:
    """Residual ``r`` such that ``fold(durs + [r]) == total`` exactly.
    One Newton-style correction converges in a step or two for IEEE
    doubles; None if it doesn't (caller falls back to a single segment)."""
    r = total - fold(durs)
    for _ in range(8):
        f = fold(durs + [r])
        if f == total:
            return r
        r += total - f
    return None


def attribute_request(request: dict, children: list[dict]) -> dict:
    """Split one ``request`` span into exactly-folding segments.

    ``children`` are the finished spans on the request's lane (any depth);
    nesting is reconstructed here so a ``migrate`` inside ``decode`` is
    charged to migration, not double-counted.
    """
    dur = request["dur"]
    inner = [c for c in children
             if c is not request and c["name"] != "request"
             and c["ts"] >= request["ts"] - 1e-12
             and c["ts"] + c["dur"] <= request["ts"] + dur + 1e-9]
    # parents precede children under (start asc, dur desc); a span's direct
    # parent is the innermost still-open interval containing it
    inner.sort(key=lambda e: (e["ts"], -e["dur"]))
    segments: list[list] = []          # [stage, dur] in lane order
    stack: list[tuple[dict, int]] = []  # (span, its segment index)
    for c in inner:
        while stack and c["ts"] >= stack[-1][0]["ts"] \
                + stack[-1][0]["dur"] - 1e-12:
            stack.pop()
        stage = c["name"] if c["name"] in STAGE_ROLE else None
        if stage is None:              # prefill_chunk etc.: stays inside
            continue                   # its parent's segment
        if stack:
            # nested stage (migrate/handoff inside decode): carve it out
            # of the parent's segment so time is attributed once
            p_seg = segments[stack[-1][1]]
            p_seg[1] = p_seg[1] - c["dur"]
        segments.append([stage, c["dur"]])
        stack.append((c, len(segments) - 1))
    durs = [d for _, d in segments]
    residual = _exact_residual(dur, durs)
    if residual is None:               # pathological floats: stay exact
        segments, residual = [], dur
    segments = segments + [["unattributed", residual]]
    cp = {
        "uid": request["tid"],
        "dur": dur,
        "ts": request["ts"],
        "segments": [(s, d) for s, d in segments],
        "late_open": bool(request["args"].get("late_open")),
    }
    by_stage: dict[str, float] = {}
    for s, d in cp["segments"]:
        by_stage[s] = by_stage.get(s, 0.0) + d
    cp["by_stage"] = by_stage
    attributed = {s: v for s, v in by_stage.items() if s != "unattributed"}
    cp["dominant"] = max(attributed, key=attributed.get) \
        if attributed and max(attributed.values()) > 0.0 else "unattributed"
    return cp


def verify(cp: dict) -> bool:
    """The float-equality contract: the left-fold of a request's segment
    durations reproduces the request span duration bitwise."""
    return fold([d for _, d in cp["segments"]]) == cp["dur"]


def analyze(events: list[dict]) -> list[dict]:
    """Per-request critical paths for every completed ``request`` span in
    an event list (tracer stream, flight snapshot, or incident bundle)."""
    _bump()
    lanes: dict[int, list[dict]] = {}
    requests: list[dict] = []
    for e in events:
        if e.get("ph") != "X" or e.get("pid") != REQUESTS_PID:
            continue
        lanes.setdefault(e["tid"], []).append(e)
        if e["name"] == "request":
            requests.append(e)
    return [attribute_request(r, lanes[r["tid"]]) for r in requests]


def aggregate(cps: list[dict], *, roles: bool = False,
              p: float = 0.99) -> dict:
    """Serving critical-path ranking over per-request attributions.

    Returns stage totals/shares ranked by total time, the dominant stage
    among the slowest ``p``-tail requests (which stage to fix to move
    p99), and — with ``roles=True`` (a RolePlan was active) — the same
    shares grouped by executing role."""
    _bump()
    out: dict = {"requests": len(cps), "exact": all(map(verify, cps)),
                 "stages": {}, "p": p}
    if not cps:
        out.update(p_dur=0.0, p_dominant=None, ranking=[])
        if roles:
            out["by_role"] = {}
        return out
    totals: dict[str, float] = {}
    dominated: dict[str, int] = {}
    for cp in cps:
        for s, d in cp["by_stage"].items():
            totals[s] = totals.get(s, 0.0) + d
        dominated[cp["dominant"]] = dominated.get(cp["dominant"], 0) + 1
    grand = fold(sorted(totals.values()))
    out["stages"] = {
        s: {"total_s": t,
            "share": (t / grand) if grand > 0.0 else 0.0,
            "requests_dominated": dominated.get(s, 0)}
        for s, t in totals.items()}
    out["ranking"] = sorted(totals, key=totals.get, reverse=True)
    # tail: the dominant stage among requests at/above the p-quantile
    # duration is the lever that moves p99
    durs = sorted(cp["dur"] for cp in cps)
    k = min(len(durs) - 1, max(0, int(p * len(durs))))
    p_dur = durs[k]
    tail = [cp for cp in cps if cp["dur"] >= p_dur]
    tail_tot: dict[str, float] = {}
    for cp in tail:
        for s, d in cp["by_stage"].items():
            if s != "unattributed":
                tail_tot[s] = tail_tot.get(s, 0.0) + d
    out["p_dur"] = p_dur
    out["p_dominant"] = max(tail_tot, key=tail_tot.get) if tail_tot \
        and max(tail_tot.values()) > 0.0 else "unattributed"
    if roles:
        by_role: dict[str, dict] = {}
        for s, t in totals.items():
            role = STAGE_ROLE.get(s, "overhead")
            rec = by_role.setdefault(role, {"total_s": 0.0, "stages": []})
            rec["total_s"] += t
            rec["stages"].append(s)
        for rec in by_role.values():
            rec["share"] = (rec["total_s"] / grand) if grand > 0.0 else 0.0
            rec["stages"].sort()
        out["by_role"] = by_role
    return out


# package-level names (obs.analyze is already the costmodel's roofline
# entry point, so these carry their full meaning in their names)
analyze_critical_paths = analyze
aggregate_critical_paths = aggregate
