"""Span/event tracer over the serving stack's virtual clock.

Timestamps are **sim-clock** seconds: the discrete-event serving loops
(``gateway.drive_prompt_loop``, ``MicroBatchGateway.run``) advance a
:class:`SimClock` as virtual time progresses, and events stamped *inside* a
decode tick interpolate with the measured wall offset from the tick's start
(``anchor``/``release``), so sub-tick spans (per-chunk prefill folds,
migrations) land between the tick's virtual endpoints instead of collapsing
onto one instant.

Span discipline is strict per lane ``(pid, tid)``: ``end`` must close the
innermost open span of that lane with the same name, or it raises — the
nesting invariant is enforced at record time, not post-hoc.  Lanes:

  pid 0           request lifecycle tracks, one tid per request uid:
                  ``request`` > ``queue_wait`` / ``prefill`` (with
                  ``prefill_chunk`` children, prefix hits marked) /
                  ``decode`` (with ``migrate`` children).
  pid 1 + slice   engine tracks: one ``tick`` / ``batch`` span per batched
                  step, args carrying the lane/bucket occupancy.

Energy attribution: each completed request span ends with an
``energy_parts`` dict (frontend prefill/decode, link, migration — the same
addends, in the same order, that the telemetry ledger folded into the
request's ``energy_nj``), so :meth:`Tracer.assert_energy_conserved` can
check the span stream against ``Telemetry.fleet_energy_nj`` **bitwise**.

Zero-cost-when-disabled contract: nothing in the serving stack calls into
this module unless a tracer was explicitly attached; every public method
bumps a module-level counter (:func:`callback_count`) so the test suite can
pin "disabled tracing == zero Python-level callbacks" exactly.

On a CUDA device the host runs ahead of the card: a span closed right
after a launch would measure its issue, not its work.  So the serving
stack, when (and only when) a tracer is attached, synchronizes the device
before it closes a span that covers device work (the paged adapter's
``prefill_chunk``, the batcher's ``tick``; the frame gateway's stages
synchronize in any case).  No obs call runs inside a captured step
(``serve/capture.py``): a call there would run once, at capture, and never
on a replay, so spans wrap the steps from outside.
"""
from __future__ import annotations

import time

REQUESTS_PID = 0          # request lifecycle tracks (tid = request uid)
ENGINE_PID = 1            # engine track of slice 0 (1 + slice_idx generally)

# every public Tracer entry point increments this; tests assert a run with
# tracing disabled leaves it untouched (the hot paths' `if tracer is None`
# guards really do short-circuit all instrumentation)
_N_CALLBACKS = 0


def callback_count() -> int:
    """Python-level tracer callbacks made process-wide so far."""
    return _N_CALLBACKS


def _bump() -> None:
    """Count one obs callback.  Every public entry point of the obs layer
    (tracer, SLO monitor, pressure signal, cost attributor) charges itself
    here, so the zero-cost-when-disabled pin covers the *whole* obs
    surface: a run with no tracer/monitor attached must leave
    :func:`callback_count` untouched."""
    global _N_CALLBACKS
    _N_CALLBACKS += 1


class SimClock:
    """Monotone virtual-time clock shared by loop, batcher, and tracer."""

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = t

    def advance(self, t: float) -> None:
        if t > self.t:
            self.t = t


class Tracer:
    """Strictly-nested span recorder with sim-clock timestamps."""

    def __init__(self, clock: SimClock | None = None, sink=None,
                 retain: bool = True):
        self.clock = clock if clock is not None else SimClock()
        self.events: list[dict] = []      # finished spans/instants, append order
        self._stacks: dict[tuple, list[dict]] = {}   # lane -> open spans
        self._ctx: tuple[int, int] = (REQUESTS_PID, 0)
        self._anchor_wall: float | None = None
        self._anchor_sim = 0.0
        # optional incremental event sink (obs.export.SpanStreamWriter, or
        # a flight.FlightRecorder ring): called with each finished event as
        # it is recorded, so long runs can stream spans to disk — or keep a
        # bounded ring — instead of holding only the in-memory list.
        # ``retain=False`` makes the sink the *only* retention (always-on
        # flight mode on a long-running gateway must not grow an unbounded
        # event list); post-hoc checks that re-fold the full stream
        # (assert_nested / assert_energy_conserved) need retain=True.
        self.sink = sink
        self.retain = retain

    def _emit(self, event: dict) -> None:
        if self.retain:
            self.events.append(event)
        if self.sink is not None:
            self.sink(event)

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Current trace time: the sim clock, plus the measured wall offset
        when inside an anchored tick (see :meth:`anchor`)."""
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        if self._anchor_wall is not None:
            return self._anchor_sim + (time.perf_counter()
                                       - self._anchor_wall)
        return self.clock.t

    def anchor(self) -> None:
        """Start a measured window at the clock's current virtual time:
        until :meth:`release`, stamps are ``clock.t + wall_offset`` — the
        event loop brackets each ``step()`` with anchor/release so sub-tick
        events spread over the tick's (measured) virtual extent."""
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        self._anchor_sim = self.clock.t
        self._anchor_wall = time.perf_counter()

    def release(self) -> None:
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        self._anchor_wall = None

    # -- lane context --------------------------------------------------------

    def set_ctx(self, tid: int, pid: int = REQUESTS_PID) -> None:
        """Default lane for events that omit pid/tid — the batcher points
        this at the request being admitted so the paged adapter's chunk
        spans land on the right request track without threading uids
        through every fold call."""
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        self._ctx = (pid, tid)

    def _lane(self, pid, tid) -> tuple[int, int]:
        return (self._ctx[0] if pid is None else pid,
                self._ctx[1] if tid is None else tid)

    # -- spans ---------------------------------------------------------------

    def begin(self, name: str, *, pid: int | None = None,
              tid: int | None = None, t: float | None = None,
              args: dict | None = None) -> None:
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        lane = self._lane(pid, tid)
        span = {"name": name, "ph": "X", "pid": lane[0], "tid": lane[1],
                "ts": self.now() if t is None else t,
                "args": dict(args) if args else {}}
        self._stacks.setdefault(lane, []).append(span)

    def end(self, name: str, *, pid: int | None = None,
            tid: int | None = None, t: float | None = None,
            args: dict | None = None) -> dict:
        """Close the innermost open span of the lane; it must carry
        ``name`` (strict nesting, enforced here).  ``args`` merge into the
        span's args; the finished span joins the event stream."""
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        lane = self._lane(pid, tid)
        stack = self._stacks.get(lane)
        if not stack:
            raise AssertionError(f"end('{name}') on lane {lane} with no "
                                 f"open span")
        span = stack.pop()
        if span["name"] != name:
            stack.append(span)
            raise AssertionError(
                f"end('{name}') on lane {lane} but innermost open span is "
                f"'{span['name']}' — spans must nest")
        t_end = self.now() if t is None else t
        # a child stamped by a wall offset can overrun the loop's virtual
        # endpoint by scheduler noise; clamp so durations stay non-negative
        span["dur"] = max(0.0, t_end - span["ts"])
        if args:
            span["args"].update(args)
        self._emit(span)
        return span

    def instant(self, name: str, *, pid: int | None = None,
                tid: int | None = None, t: float | None = None,
                args: dict | None = None) -> None:
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        lane = self._lane(pid, tid)
        self._emit({
            "name": name, "ph": "i", "pid": lane[0], "tid": lane[1],
            "ts": self.now() if t is None else t, "s": "t",
            "args": dict(args) if args else {}})

    def counter(self, name: str, values: dict, *, pid: int = ENGINE_PID,
                t: float | None = None) -> None:
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        self._emit({
            "name": name, "ph": "C", "pid": pid, "tid": 0,
            "ts": self.now() if t is None else t, "args": dict(values)})

    def innermost(self, *, pid: int | None = None,
                  tid: int | None = None) -> str | None:
        """Name of the lane's innermost open span (None when the lane is
        empty).  The serving instrumentation uses this to heal partially
        traced lifecycles — a request admitted before the tracer was wired
        has no open ``queue_wait``/``decode`` to close, and closing blind
        would (correctly) raise."""
        global _N_CALLBACKS
        _N_CALLBACKS += 1
        stack = self._stacks.get(self._lane(pid, tid))
        return stack[-1]["name"] if stack else None

    # -- inspection ----------------------------------------------------------

    def open_spans(self) -> list[dict]:
        return [s for stack in self._stacks.values() for s in stack]

    def spans(self, name: str | None = None) -> list[dict]:
        return [e for e in self.events if e["ph"] == "X"
                and (name is None or e["name"] == name)]

    def request_spans(self) -> dict[int, dict]:
        """uid -> completed ``request`` span (requests pid only)."""
        return {e["tid"]: e for e in self.spans("request")
                if e["pid"] == REQUESTS_PID}

    def assert_nested(self) -> None:
        """Every lane's finished spans form a proper nesting (children
        inside parents, siblings disjoint up to clamp rounding) and no
        span is left open.  ``end``'s stack discipline makes violations
        impossible to *record*; this re-checks the resulting intervals."""
        if self.open_spans():
            raise AssertionError(f"open spans at trace end: "
                                 f"{[s['name'] for s in self.open_spans()]}")
        lanes: dict[tuple, list[dict]] = {}
        for e in self.spans():
            lanes.setdefault((e["pid"], e["tid"]), []).append(e)
        for lane, evs in lanes.items():
            # sort by start asc, duration desc: parents precede children
            evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
            stack: list[dict] = []
            for e in evs:
                while stack and e["ts"] >= stack[-1]["ts"] \
                        + stack[-1]["dur"] - 1e-12:
                    stack.pop()
                if stack and e["ts"] + e["dur"] > stack[-1]["ts"] \
                        + stack[-1]["dur"] + 1e-9:
                    raise AssertionError(
                        f"lane {lane}: span '{e['name']}' "
                        f"[{e['ts']}, {e['ts'] + e['dur']}] overlaps "
                        f"parent '{stack[-1]['name']}' boundary")
                stack.append(e)

    def assert_energy_conserved(self, telemetry) -> None:
        """The span stream's stage-attributed energies sum **bitwise** to
        the telemetry ledger's conserved fleet total.

        Request spans end in completion-record order and their
        ``energy_parts`` hold the exact addends (same values, same fold
        order) the ledger summed into each record's ``energy_nj`` — so a
        left-fold here reproduces ``fleet_energy_nj`` with float equality,
        not a tolerance.  Any drift means an instrumentation path charged
        energy the ledger never saw (or vice versa).
        """
        total = 0.0
        n = 0
        for e in self.events:               # append order == record order
            if e["ph"] != "X" or e["name"] != "request":
                continue
            parts = e["args"].get("energy_parts")
            if parts is None:
                raise AssertionError(
                    f"request span uid={e['tid']} carries no energy_parts")
            span_e = 0.0
            for v in parts.values():
                span_e += v
            if span_e != e["args"].get("energy_nj"):
                raise AssertionError(
                    f"request span uid={e['tid']}: parts sum {span_e} != "
                    f"span energy_nj {e['args'].get('energy_nj')}")
            total += span_e
            n += 1
        if n != len(telemetry.records):
            raise AssertionError(
                f"{n} request spans vs {len(telemetry.records)} ledger "
                f"records — span coverage is incomplete")
        if total != telemetry.fleet_energy_nj:
            raise AssertionError(
                f"span energy sum {total!r} != fleet ledger total "
                f"{telemetry.fleet_energy_nj!r} (must match bitwise)")
