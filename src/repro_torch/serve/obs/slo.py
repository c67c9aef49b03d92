"""SLO health evaluation: multi-window burn-rate alerting + pressure signal.

Turns the raw telemetry the serving loops produce (per-request SLO timestamps, drop
ledger, interval metric series) into *verdicts*: a Google-SRE-style
multi-window burn-rate engine evaluates an :class:`SLOPolicy` online over
the serving loop's virtual clock and drives an ok → warn → critical health
state machine.

Burn rate, per objective, is the classic SRE quantity: the fraction of
recent events that violated the objective (a completion over the TTFT
target, a dropped admission) divided by the objective's error *budget*
(the violation fraction the SLO tolerates).  Burn 1.0 consumes the budget
exactly at the sustainable rate; burn 14.4 over a 30-day SLO exhausts it
in ~2 days.  Each :class:`BurnWindow` pairs a **long** window (evidence —
enough events that the rate is real) with a **short** window (recency —
the problem is still happening *now*): the pair trips only when *both*
windows exceed the threshold, the standard construction that pages fast on
real incidents without flapping on noise, and resets quickly once the
burn actually stops.  Window lengths are virtual-time seconds scaled to
the serving run (``SLOPolicy.default(period_s=...)`` applies the SRE
workbook's canonical window/threshold ratios to any period).

Outputs, all riding existing telemetry surfaces:

  - health state + transition log (:meth:`SLOMonitor.report`);
  - trace instants at every transition (``slo_transition`` on the engine
    track) when a tracer is attached;
  - burn-rate series columns: at each evaluation the monitor pushes
    ``slo_state`` and per-objective ``burn_<name>`` gauges into the
    attached :class:`~repro_torch.serve.obs.metrics.MetricsRegistry`, so the
    burn curves land in ``Telemetry.report()["series"]`` and the
    OpenMetrics exposition next to the occupancy curves;
  - a subscribable :class:`PressureSignal` that fires on every state
    transition — the hook the gateway's backpressure path consumes today
    (shed earlier under critical burn instead of waiting for the queue
    bound) and the planned closed-loop bit-width degradation controller
    (step endpoints down the 8→4→2 stochastic bitstream ladder
    under pressure instead of dropping) will consume tomorrow.

Zero-cost-when-disabled: the serving loops only call into this module when
an ``slo`` monitor was explicitly attached, and every public entry point
charges the process-wide obs callback counter, so the pinned
"disabled == zero obs callbacks" contract covers the SLO path too.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.serve.obs.tracer import ENGINE_PID, _bump

# health states, in escalation order (indices double as series values)
STATES = ("ok", "warn", "critical")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One objective: observations over ``target`` are budget burn.

    ``target`` is in the observation's own unit (seconds for the latency
    objectives; drop-rate observations are booleans and ignore it).
    ``budget`` is the tolerated violation fraction — the SLO is
    "at most ``budget`` of events exceed ``target``".
    """
    name: str                 # "ttft" | "tpot" | "queue_wait" | "drop_rate"
    target: float = 0.0
    budget: float = 0.01

    def __post_init__(self):
        assert 0.0 < self.budget <= 1.0, "budget is a fraction of events"


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """A (long, short) window pair with its burn threshold + severity.
    Trips only when the burn rate exceeds ``threshold`` over *both*
    windows — long for evidence, short for recency."""
    long_s: float
    short_s: float
    threshold: float
    severity: str             # "warn" | "critical"

    def __post_init__(self):
        assert 0.0 < self.short_s <= self.long_s
        assert self.severity in ("warn", "critical")


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Objectives + the multi-window burn ladder evaluating them."""
    objectives: tuple[SLObjective, ...]
    windows: tuple[BurnWindow, ...]

    @classmethod
    def default(cls, *, period_s: float, ttft_s: float | None = None,
                tpot_s: float | None = None,
                queue_wait_s: float | None = None,
                drop_budget: float | None = 0.01,
                budget: float = 0.01) -> "SLOPolicy":
        """The SRE workbook's canonical alert ladder, rescaled from the
        30-day period to ``period_s`` of virtual serving time: critical at
        burn 14.4 over (1h, 5m)/30d, warn at burn 6 over (6h, 30m)/30d and
        at burn 1 over (3d, 6h)/30d.  Pass a target to enable an
        objective; None leaves it out."""
        objectives = []
        for name, tgt in (("ttft", ttft_s), ("tpot", tpot_s),
                          ("queue_wait", queue_wait_s)):
            if tgt is not None:
                objectives.append(SLObjective(name, tgt, budget))
        if drop_budget is not None:
            objectives.append(SLObjective("drop_rate", 0.0, drop_budget))
        assert objectives, "policy needs at least one objective"
        month = 30 * 24 * 3600.0
        scale = period_s / month

        def w(long_h, short_h, thr, sev):
            return BurnWindow(long_h * 3600 * scale, short_h * 3600 * scale,
                              thr, sev)
        return cls(tuple(objectives),
                   (w(1, 1 / 12, 14.4, "critical"),
                    w(6, 0.5, 6.0, "warn"),
                    w(72, 6, 1.0, "warn")))

    def __post_init__(self):
        assert self.objectives and self.windows
        names = [o.name for o in self.objectives]
        assert len(set(names)) == len(names), f"duplicate objectives {names}"

    def objective(self, name: str) -> SLObjective | None:
        for o in self.objectives:
            if o.name == name:
                return o
        return None


@dataclasses.dataclass(frozen=True)
class PressureEvent:
    """One health transition, as delivered to pressure subscribers."""
    t: float
    prev: str                 # state left
    state: str                # state entered
    worst: str | None         # objective with the highest burn (None: ok)
    burns: dict               # objective -> max burn over the long windows


class PressureSignal:
    """Subscribable health-transition feed.

    Consumers register a callable; every state transition delivers a
    :class:`PressureEvent` synchronously, in virtual-time order.  This is
    deliberately the *whole* API — the future bit-width degradation
    controller subscribes here and walks the 8→4→2 stream-length ladder on
    warn/critical; today the prompt gateways subscribe their backpressure
    shedding (docs/serving.md).
    """

    def __init__(self):
        self._subs: list = []
        self.events: list[PressureEvent] = []

    @property
    def last(self) -> PressureEvent | None:
        return self.events[-1] if self.events else None

    def subscribe(self, fn) -> None:
        _bump()
        self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        _bump()
        self._subs.remove(fn)

    def fire(self, event: PressureEvent) -> None:
        _bump()
        self.events.append(event)
        for fn in list(self._subs):
            fn(event)


class SLOMonitor:
    """The burn-rate engine: event windows + state machine + outputs.

    The serving loops feed it observations as virtual time advances
    (:meth:`observe_record` at each completion, :meth:`observe_event` at
    each admission decision) and call :meth:`evaluate` once per tick; the
    monitor keeps per-objective event windows no longer than the policy's
    longest window, computes burn rates, walks the health state machine,
    and emits the transition outputs (trace instant, burn gauges,
    pressure event).
    """

    def __init__(self, policy: SLOPolicy, tracer=None, metrics=None):
        self.policy = policy
        self.tracer = tracer
        self.metrics = metrics
        self.pressure = PressureSignal()
        self.state = "ok"
        self.transitions: list[tuple[float, str, str, str | None]] = []
        self._events: dict[str, deque] = {
            o.name: deque() for o in policy.objectives}
        self._counts: dict[str, list[int]] = {
            o.name: [0, 0] for o in policy.objectives}   # [good, bad] ever
        self._horizon = max(w.long_s for w in policy.windows)
        self.last_burns: dict[str, float] = {
            o.name: 0.0 for o in policy.objectives}

    # -- observations --------------------------------------------------------

    def observe(self, name: str, t: float, value: float) -> None:
        """One measured observation for objective ``name`` (seconds for the
        latency objectives); burns budget iff it exceeds the target."""
        _bump()
        obj = self.policy.objective(name)
        if obj is None:
            return
        self._push(name, t, value > obj.target)

    def observe_event(self, name: str, t: float, bad: bool) -> None:
        """One boolean observation — how drop_rate is fed: every admission
        decision is an event, a rejection is a bad one."""
        _bump()
        if name in self._events:
            self._push(name, t, bad)

    def observe_record(self, rec, t: float | None = None) -> None:
        """Derive the latency observations from one completed
        :class:`~repro_torch.serve.gateway.telemetry.RequestRecord` — TTFT
        (arrival → first token), TPOT (per generated token), queue wait
        (arrival → dequeue) — stamped at the completion's virtual time."""
        _bump()
        t = rec.t_done if t is None else t
        if rec.t_admit >= 0:
            self.observe("ttft", t, rec.t_admit - rec.t_arrival)
            self.observe("tpot", t, (rec.t_done - rec.t_admit)
                         / max(1, rec.tokens_out - 1))
        if rec.t_dequeue >= 0:
            self.observe("queue_wait", t, rec.t_dequeue - rec.t_arrival)
        elif rec.kind == "frame":
            # frames have no slot admission; their queue wait is the whole
            # pre-service latency net of the (fixed) sensor+link offset
            self.observe("queue_wait", t, rec.latency_s)

    def _push(self, name: str, t: float, bad: bool) -> None:
        dq = self._events[name]
        dq.append((t, bad))
        self._counts[name][1 if bad else 0] += 1
        cutoff = t - self._horizon
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    # -- burn math -----------------------------------------------------------

    def burn_rate(self, name: str, window_s: float, t: float) -> float:
        """bad fraction over ``(t - window_s, t]``, divided by the
        objective's budget.  No events in the window -> 0 (no evidence is
        not an incident)."""
        _bump()
        obj = self.policy.objective(name)
        dq = self._events.get(name)
        if obj is None or not dq:
            return 0.0
        lo = t - window_s
        n = bad = 0
        for ts, b in reversed(dq):
            if ts <= lo:
                break
            n += 1
            bad += b
        return (bad / n) / obj.budget if n else 0.0

    # -- the state machine ---------------------------------------------------

    def evaluate(self, t: float) -> str:
        """Evaluate every (objective, window-pair) at virtual time ``t``,
        update the health state, and emit the transition outputs.  Returns
        the current state."""
        _bump()
        severity = 0
        burns: dict[str, float] = {}
        for obj in self.policy.objectives:
            peak = 0.0
            for w in self.policy.windows:
                b_long = self.burn_rate(obj.name, w.long_s, t)
                peak = max(peak, b_long)
                if b_long >= w.threshold and \
                        self.burn_rate(obj.name, w.short_s, t) >= w.threshold:
                    severity = max(severity, STATES.index(w.severity))
            burns[obj.name] = peak
        self.last_burns = burns
        new = STATES[severity]
        if self.metrics is not None:
            self.metrics.set_gauge("slo_state", severity)
            for name, b in burns.items():
                self.metrics.set_gauge(f"burn_{name}", b)
        if new != self.state:
            worst = max(burns, key=burns.get) if severity else None
            self.transitions.append((t, self.state, new, worst))
            if self.tracer is not None:
                self.tracer.instant(
                    "slo_transition", pid=ENGINE_PID, tid=0, t=t,
                    args={"from": self.state, "to": new, "objective": worst,
                          **{f"burn_{k}": v for k, v in burns.items()}})
            prev, self.state = self.state, new
            self.pressure.fire(PressureEvent(t, prev, new, worst, burns))
        return self.state

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """End-of-run health verdict: final state, the transition log, the
        last burn snapshot, and per-objective totals."""
        _bump()
        return {
            "state": self.state,
            "transitions": [
                {"t": t, "from": a, "to": b, "objective": o}
                for t, a, b, o in self.transitions],
            "burns": dict(self.last_burns),
            "objectives": {
                o.name: {"target": o.target, "budget": o.budget,
                         "good": self._counts[o.name][0],
                         "bad": self._counts[o.name][1]}
                for o in self.policy.objectives},
            "pressure_events": len(self.pressure.events),
        }
