"""Micro-batching front door over virtual time: the frame path.

A small fixed set of padded batch shapes ("buckets"), a discrete-event loop
over virtual time that is deterministic given a trace, and service times
either measured on the device (``service_model="measured"``) or pinned
(``service_model="fixed"``) for tests.  Per tick the gateway:

  1. admits arrivals into a bounded queue (beyond ``max_queue`` a request is
     rejected and counted);
  2. flushes a batch when the largest bucket fills or the oldest queued
     request hits its ``max_delay_s`` deadline, padding up to the smallest
     bucket that fits;
  3. runs the two pipeline stages (the at-sensor stage feeds the link; the
     host stage occupies the server) and charges per-request telemetry.

Each bucket's two stages are captured steps (``serve/capture.py``), the
reference's per-bucket jitted entry points: :meth:`MicroBatchGateway.warmup`
captures them all, and a batch refills and replays them.

The admission, flush and charging order is the reference's
(``repro.serve.gateway.gateway.MicroBatchGateway``), so on a shared trace
with a fixed service time both ledgers agree field for field.

The prompt path (``PromptGateway``) fronts the continuous slot batcher the
same way: arrivals are submitted as virtual time reaches them, one batched
decode tick per step, each step's measured wall time charged to the
virtual clock (``drive_prompt_loop``), and every completion priced by
``record_prompt_completion`` exactly as the reference prices it.

Both paths take the reference's observability attachments (``tracer``,
``metrics``, ``slo``, ``flight``, ``incident``; ``serve/obs/``) and record
the same spans, samples, SLO transitions and incident bundles for the same
trace.  Every call site is guarded on ``is None``, so a run with nothing
attached makes no obs call; no obs call runs inside a captured step, and a
span over device work closes after a synchronize.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.models import lenet
from repro_torch.serve import capture
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, Request
from repro_torch.serve.gateway.telemetry import RequestRecord, Telemetry
from repro_torch.serve.obs import costmodel
from repro_torch.serve.obs.tracer import SimClock, Tracer


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    bucket_sizes: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    max_queue: int = 128             # admission control bound
    max_delay_s: float = 0.02        # oldest-request flush deadline
    link_mbps: float = 32.0          # sensor->host link bandwidth (Mbit/s)
    service_model: str = "measured"  # "measured" | "fixed"
    fixed_service_s: float = 0.0     # per-batch service time for "fixed"

    def __post_init__(self):
        if tuple(sorted(self.bucket_sizes)) != tuple(self.bucket_sizes):
            raise ValueError("bucket_sizes must be sorted ascending")


def wire_flight(flight, tracer, metrics):
    """Hang a flight recorder on a run's tracer and metrics; returns the
    tracer the run records through.  Always-on flight mode: with a
    ``flight`` recorder but no tracer, spans still flow, through a
    retention-free tracer whose only sink is the bounded ring."""
    if flight is None:
        return tracer
    if tracer is None:
        tracer = Tracer(retain=False, sink=flight)
    elif tracer.sink is None:
        tracer.sink = flight
    if metrics is not None and metrics.sink is None:
        metrics.sink = flight.observe_sample
    return tracer


class MicroBatchGateway:
    """The frame path: sensor fleet -> buckets -> frontend offload -> tail."""

    def __init__(self, cfg: GatewayConfig, spec: fe.FrontendSpec,
                 params=None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.params = params if params is not None else \
            lenet.init(seed, spec.lenet, device=self.device)
        # one captured step per bucket and stage (the reference's jitted
        # entry points), all on one graph memory pool: a stage's outputs
        # are read before the next stage replays
        pool = capture.GraphPool(self.device)
        self._sensor_fns = {
            bs: capture.CapturedStep(
                lambda x, _p=self.params, _s=spec: fe.sensor_stage(_p, x, _s),
                self.device, pool)
            for bs in cfg.bucket_sizes}
        self._gateway_fns = {
            bs: capture.CapturedStep(
                lambda x, _p=self.params, _s=spec: fe.gateway_stage(_p, x,
                                                                    _s),
                self.device, pool)
            for bs in cfg.bucket_sizes}
        self._frame_energy_nj = fe.frame_energy_nj(spec)
        self._link_bytes = fe.link_bytes_per_frame(spec)
        self._sensor_lat = fe.sensor_latency_s(spec)
        self._link_lat = self._link_bytes * 8 / (cfg.link_mbps * 1e6)

    def warmup(self) -> None:
        """Capture every bucket's two stages up front (the first call of a
        step runs it eagerly, then captures it), so steady state never
        captures and kernel builds never land in a measured service
        time."""
        ln = self.spec.lenet
        for bs in self.cfg.bucket_sizes:
            x = np.zeros((bs, ln.image_size, ln.image_size, ln.channels),
                         np.uint8)
            self._gateway_fns[bs](self._sensor_fns[bs](x))
        synchronize(self.device)

    def compile_counts(self) -> dict[int, int]:
        """Captured keys per bucket, sensor and gateway stage together (2
        after :meth:`warmup`, and no traffic adds one)."""
        return {bs: self._sensor_fns[bs]._cache_size()
                + self._gateway_fns[bs]._cache_size()
                for bs in self.cfg.bucket_sizes}

    def jit_fns(self) -> dict[str, capture.CapturedStep]:
        """Named captured steps, for ``obs.RecompileDetector.track`` (the
        reference's names)."""
        fns: dict[str, capture.CapturedStep] = {}
        for bs in self.cfg.bucket_sizes:
            fns[f"sensor_b{bs}"] = self._sensor_fns[bs]
            fns[f"gateway_b{bs}"] = self._gateway_fns[bs]
        return fns

    def cost_args(self) -> dict[str, tuple]:
        """``jit_fns``' stages paired with their analytic counts, for
        ``obs.costmodel`` roofline attribution: ``(count, args)``, where
        ``count(*args)`` gives the stage's FLOPs and bytes per call."""
        out: dict[str, tuple] = {}
        for bs in self.cfg.bucket_sizes:
            out[f"sensor_b{bs}"] = (costmodel.frame_sensor_cost,
                                    (self.spec, bs))
            out[f"gateway_b{bs}"] = (costmodel.frame_gateway_cost,
                                     (self.spec, bs))
        return out

    def _bucket_for(self, n: int) -> int:
        for bs in self.cfg.bucket_sizes:
            if bs >= n:
                return bs
        return self.cfg.bucket_sizes[-1]

    def _serve_batch(self, frames: np.ndarray) -> tuple[np.ndarray, float]:
        """Returns (predictions, host_service_seconds)."""
        bs = frames.shape[0]
        payload = self._sensor_fns[bs](frames)                # at-sensor
        synchronize(self.device)
        t0 = time.perf_counter()
        logits = self._gateway_fns[bs](payload)
        synchronize(self.device)
        svc = time.perf_counter() - t0
        if self.cfg.service_model == "fixed":
            svc = self.cfg.fixed_service_s
        return logits.argmax(-1).cpu().numpy(), svc

    def run(self, arrivals: list[Arrival],
            telemetry: Telemetry | None = None, *,
            tracer=None, metrics=None, slo=None, flight=None,
            incident=None) -> Telemetry:
        tracer = wire_flight(flight, tracer, metrics)
        if incident is not None and incident.context_fn is None:
            incident.context_fn = self.debug_state
        tel = telemetry if telemetry is not None else Telemetry()
        arrivals = [a for a in arrivals if a.kind == "frame"]
        # payload hits the gateway queue after at-sensor compute + link time
        offset = self._sensor_lat + self._link_lat
        queue: deque[Arrival] = deque()
        max_bs = self.cfg.bucket_sizes[-1]
        now, i, n = 0.0, 0, len(arrivals)
        if metrics is not None:
            metrics.register("queue_depth", lambda: len(queue))
        # the reference's per-request energy: these addends, folded in
        # order; request spans carry the dict so obs can check conservation
        # bitwise
        parts = {"frontend_nj": self._frame_energy_nj,
                 "link_nj": fe.link_energy_nj(self._link_bytes)}
        energy_nj = 0.0
        for v in parts.values():
            energy_nj += v

        def admit_until(t: float):
            nonlocal i
            while i < n and arrivals[i].t + offset <= t:
                a = arrivals[i]
                i += 1
                rejected = len(queue) >= self.cfg.max_queue
                if rejected:
                    tel.drop(a.uid, "frame", "queue_full", a.t + offset)
                    if tracer is not None:
                        tracer.instant("drop", tid=a.uid, t=a.t + offset,
                                       args={"reason": "queue_full"})
                    if incident is not None:
                        incident.observe_drop(a.t + offset)
                else:
                    queue.append(a)
                if slo is not None:
                    # every admission decision is a drop_rate event
                    slo.observe_event("drop_rate", a.t + offset, rejected)

        while i < n or queue:
            if not queue:
                now = max(now, arrivals[i].t + offset)
            admit_until(now)
            if not queue:
                continue
            # wait (in virtual time) for a full bucket or the deadline
            deadline = queue[0].t + offset + self.cfg.max_delay_s
            while len(queue) < max_bs and i < n and \
                    arrivals[i].t + offset <= deadline:
                now = max(now, arrivals[i].t + offset)
                admit_until(now)
            if len(queue) < max_bs:
                now = max(now, deadline)
            batch = [queue.popleft()
                     for _ in range(min(len(queue), max_bs))]
            bs = self._bucket_for(len(batch))
            frames = np.zeros((bs,) + batch[0].payload.shape, np.uint8)
            for j, a in enumerate(batch):
                frames[j] = a.payload
            t_serve = now
            preds, svc = self._serve_batch(frames)
            now += svc
            if tracer is not None:
                # the stages ran (and synchronized) above, outside the
                # captured steps; the span is stamped on the virtual clock
                tracer.clock.advance(now)
                tracer.begin("batch", pid=1, tid=0, t=t_serve,
                             args={"bucket": bs, "n": len(batch)})
                tracer.end("batch", pid=1, tid=0, t=now)
            for j, a in enumerate(batch):
                if tracer is not None:
                    # the loop is virtual time, so the lifecycle is traced
                    # at completion with exact stamps
                    tracer.begin("request", tid=a.uid, t=a.t,
                                 args={"endpoint": a.endpoint})
                    tracer.begin("sensor_link", tid=a.uid, t=a.t)
                    tracer.end("sensor_link", tid=a.uid, t=a.t + offset)
                    tracer.begin("queue_wait", tid=a.uid, t=a.t + offset)
                    tracer.end("queue_wait", tid=a.uid, t=t_serve)
                    tracer.begin("serve", tid=a.uid, t=t_serve)
                    tracer.end("serve", tid=a.uid, t=now)
                    tracer.end("request", tid=a.uid, t=now,
                               args={"energy_parts": parts,
                                     "energy_nj": energy_nj})
                rec = RequestRecord(
                    uid=a.uid, endpoint=a.endpoint, kind="frame",
                    t_arrival=a.t, t_done=now, energy_nj=energy_nj,
                    link_bytes=self._link_bytes, output=int(preds[j]))
                tel.record(rec)
                if slo is not None:
                    slo.observe_record(rec)
            if slo is not None:
                slo.evaluate(now)
            if incident is not None:
                incident.poll(now)
            if metrics is not None:
                metrics.inc("frames_completed", len(batch))
                metrics.maybe_sample(now)
        if metrics is not None and metrics.samples:
            tel.record_series(metrics.samples)
        if incident is not None:
            incident.check_energy(tel, now)
        return tel

    def debug_state(self) -> dict:
        """Incident-bundle context: configuration and captured keys per
        step (the frame path keeps no cross-run queue state)."""
        return {
            "kind": "frame_gateway",
            "config": dataclasses.asdict(self.cfg),
            "frontend": {"mode": self.spec.mode, "bits": self.spec.bits},
            "jit_cache_sizes": {name: fn._cache_size()
                                for name, fn in self.jit_fns().items()},
        }


def drive_prompt_loop(arrivals, tel: Telemetry, *, busy, queue_depth,
                      max_queue, submit, step, record,
                      clock: SimClock | None = None, tracer=None,
                      metrics=None, slo=None, step_cost=None,
                      incident=None) -> None:
    """The prompt path's virtual-time event loop: drain arrivals into
    ``submit`` as virtual time reaches them (dropping, with accounting,
    beyond ``max_queue`` queued requests), charge each ``step``'s measured
    wall time to the virtual clock, and ``record(req, now)`` every
    completion.

    ``max_queue`` may be a callable returning the current bound: the
    SLO-driven backpressure shrinks it under critical burn.  ``clock``,
    when given, is advanced with the loop so the batcher can stamp
    dequeue/admit times.  ``tracer``: request/queue_wait spans open at
    submit, and each ``step`` runs inside an ``anchor``/``release`` window
    so sub-tick spans interpolate between the tick's virtual endpoints.
    ``metrics``: an interval snapshot after every tick.  ``slo``: admission
    decisions feed the drop_rate objective, and the burn engine evaluates
    once per tick.  ``incident``: observes every admission drop and is
    polled once per tick; its SLO trigger fires inside ``slo.evaluate``,
    before the next admission pass.  All default to None, and the loop
    makes no obs call then.

    ``step_cost`` (optional, ``fn(wall_seconds) -> virtual_seconds``)
    re-prices a step before it is charged to the clock: the sharded router
    charges a round the slowest slice's tick plus its own serial work, as
    slices on disjoint devices tick at once.  It excludes ``tracer``,
    whose sub-tick spans interpolate real wall offsets inside each tick
    (``ValueError`` where the reference asserts)."""
    if step_cost is not None and tracer is not None:
        raise ValueError("step_cost re-pricing and wall-anchored tracing "
                         "are exclusive")
    if tracer is not None and clock is None:
        clock = tracer.clock
    now, i, n = 0.0, 0, len(arrivals)
    while i < n or busy():
        if not busy():
            now = max(now, arrivals[i].t)
            if clock is not None:
                clock.advance(now)
        while i < n and arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            mq = max_queue() if callable(max_queue) else max_queue
            rejected = queue_depth() >= mq
            if slo is not None:
                slo.observe_event("drop_rate", now, rejected)
            if rejected:
                tel.drop(a.uid, "prompt", "queue_full", now)
                if tracer is not None:
                    tracer.instant("drop", tid=a.uid, t=now,
                                   args={"reason": "queue_full"})
                if incident is not None:
                    incident.observe_drop(now)
                continue
            if tracer is not None:
                # the lifecycle opens at arrival (the request waited from
                # a.t even if the loop reached it later)
                tracer.begin("request", tid=a.uid, t=a.t,
                             args={"endpoint": a.endpoint})
                tracer.begin("queue_wait", tid=a.uid, t=a.t)
            submit(a)
        if tracer is not None:
            tracer.anchor()
        t0 = time.perf_counter()
        finished = step()
        dt = time.perf_counter() - t0
        if step_cost is not None:
            dt = step_cost(dt)
        now += dt
        if clock is not None:
            clock.advance(now)
        if tracer is not None:
            tracer.release()
        for req in finished:
            record(req, now)
        # evaluate before sampling so the burn/state gauges the evaluation
        # pushes land in this tick's snapshot
        if slo is not None:
            slo.evaluate(now)
        if incident is not None:
            incident.poll(now)
        if metrics is not None:
            metrics.maybe_sample(now)


def record_prompt_completion(tel: Telemetry, req: Request, now: float,
                             t_arrival: float, endpoint: int,
                             token_energy_nj: float,
                             bytes_per_token: int, *,
                             energy_spec: fe.FrontendSpec | None = None,
                             tracer=None, slo=None) -> None:
    """Charge one finished prompt request into the ledger, as the reference
    does: per processed token the first-projection energy (prefix-cache
    resumes skip the shared prompt tokens; the link still carries every
    token), plus the link energy, plus the bytes a request moved between
    slices priced by :func:`frontend.migration_energy_nj` (with an
    ``energy_spec``), folded left to right.  With a ``tracer``
    the parts close the request span (opened late, at arrival, for a
    request whose life predates the tracer), so the span stream re-folds
    to the ledger bitwise; an ``slo`` monitor observes the record."""
    n_tokens = len(req.prompt) + len(req.generated)
    processed = n_tokens - req.prefill_tokens_skipped
    link = bytes_per_token * n_tokens
    # tokens the batched decode tick produced vs tokens the prefill pass
    # processed (the first generated token comes out of prefill)
    decode_tok = max(0, len(req.generated) - 1)
    parts = {"frontend_prefill_nj": token_energy_nj
             * (processed - decode_tok),
             "frontend_decode_nj": token_energy_nj * decode_tok,
             "link_nj": fe.link_energy_nj(link)}
    if req.migration_bytes and energy_spec is not None:
        parts["migration_nj"] = fe.migration_energy_nj(energy_spec,
                                                       req.migration_bytes)
    energy_nj = 0.0
    for v in parts.values():
        energy_nj += v
    rec = RequestRecord(
        uid=req.uid, endpoint=endpoint, kind="prompt",
        t_arrival=t_arrival, t_done=now, energy_nj=energy_nj,
        link_bytes=link, output=req.generated[-1],
        kv_blocks=req.kv_blocks,
        prefix_hit_blocks=req.prefix_hit_blocks,
        prefill_tokens_skipped=req.prefill_tokens_skipped,
        energy_saved_nj=token_energy_nj * req.prefill_tokens_skipped,
        migration_bytes=req.migration_bytes, migrations=req.migrations,
        t_dequeue=req.t_dequeue, t_admit=req.t_admit,
        tokens_out=len(req.generated))
    tel.record(rec)
    if slo is not None:
        slo.observe_record(rec)
    if tracer is not None:
        if tracer.innermost(tid=req.uid) != "request":
            tracer.begin("request", tid=req.uid, t=t_arrival,
                         args={"late_open": True})
        tracer.end("request", tid=req.uid, t=now,
                   args={"energy_parts": parts, "energy_nj": energy_nj,
                         "tokens_out": len(req.generated)})


class PromptGateway:
    """The LM path: prompt arrivals -> continuous slot batcher, virtual time.

    ``warmup`` drives one dummy request per prompt length through the
    batcher, so kernel builds and one-time library set-up never land in the
    virtual clock, and admission is bounded by ``max_queue`` (excess prompts
    are rejected and counted).  Each request is charged energy per
    processed token (``frontend.lm_token_energy_nj``) plus link energy; the
    paged pool's counters are recorded into the telemetry at drain.

    Observability (``serve/obs/``): ``tracer``, ``metrics`` and ``slo`` are
    wired into the batcher and adapter only for the length of :meth:`run`,
    so ``warmup`` stays untraced.  With a ``flight`` recorder and no tracer,
    ``run`` records through a retention-free tracer whose only sink is the
    ring; an ``incident`` capture snapshots the ring and
    :meth:`debug_state` on its triggers and on :meth:`capture_incident`.
    Under a critical SLO burn the admission bound shrinks by
    ``shed_factor`` (the monitor's pressure signal)."""

    def __init__(self, batcher: ContinuousBatcher, max_new_tokens: int = 16,
                 bytes_per_token: int = 4, max_queue: int = 64,
                 energy_spec: fe.FrontendSpec | None = None,
                 tracer=None, metrics=None, slo=None,
                 shed_factor: int = 4, flight=None, incident=None):
        self.batcher = batcher
        self.max_new_tokens = max_new_tokens
        self.bytes_per_token = bytes_per_token
        self.max_queue = max_queue
        self.energy_spec = energy_spec if energy_spec is not None \
            else fe.FrontendSpec()
        self._token_energy_nj = fe.lm_token_energy_nj(
            self.energy_spec, batcher.adapter.cfg.d_model)
        self.tracer = tracer
        self.metrics = metrics
        self.slo = slo
        self.flight = flight
        self.incident = incident
        if incident is not None and incident.context_fn is None:
            incident.context_fn = self.debug_state
        self.shed_factor = shed_factor
        self._shedding = False
        if slo is not None:
            slo.pressure.subscribe(self._on_pressure)

    def _on_pressure(self, event) -> None:
        self._shedding = event.state == "critical"

    def _admit_bound(self) -> int:
        if self._shedding:
            return max(1, self.max_queue // self.shed_factor)
        return self.max_queue

    def jit_fns(self) -> dict:
        """The adapter's named captured steps, for
        ``obs.RecompileDetector.track``."""
        fns = getattr(self.batcher.adapter, "jit_fns", None)
        return fns() if fns is not None else {}

    def cost_args(self) -> dict[str, tuple]:
        """The adapter's stages with their analytic counts, for
        ``obs.costmodel`` roofline attribution."""
        fns = getattr(self.batcher.adapter, "cost_args", None)
        return fns() if fns is not None else {}

    def warmup(self, prompt_lens: tuple[int, ...], vocab: int = 2) -> None:
        """Drain one all-zero request per prompt length through the batcher
        (max_new_tokens=2 forces at least one decode tick); adapters clear
        slot state on retire, so real traffic is unaffected."""
        for j, n in enumerate(prompt_lens):
            self.batcher.submit(Request(
                uid=-1 - j, prompt=np.zeros((n,), np.int32),
                max_new_tokens=2))
        self.batcher.run()

    def _register_metrics(self, m) -> None:
        m.register("queue_depth", lambda: len(self.batcher.pending))
        m.register("active_slots", lambda: self.batcher.last_active)
        ad = self.batcher.adapter
        pool = getattr(ad, "pool", None)
        if pool is not None:
            for name in pool.gauges():
                m.register(name, lambda n=name: pool.gauges()[n])
        if getattr(ad, "backend", None) == "cascade":
            # cascade_* gauges -> repro_cascade_* OpenMetrics families
            for key in ("groups", "grouped_lanes", "prefix_rows",
                        "prefix_rows_flat"):
                m.register(f"cascade_{key}",
                           lambda k=key: ad.cascade_stats()[k])

    def run(self, arrivals: list[Arrival],
            telemetry: Telemetry | None = None) -> Telemetry:
        tel = telemetry if telemetry is not None else Telemetry()
        arrivals = [a for a in arrivals if a.kind == "prompt"]
        arr_t = {a.uid: a.t for a in arrivals}
        arr_ep = {a.uid: a.endpoint for a in arrivals}
        pool_stats = getattr(self.batcher.adapter, "pool_stats", None)
        self.tracer = wire_flight(self.flight, self.tracer, self.metrics)
        # the t_dequeue/t_admit stamps need a shared virtual clock even
        # when no tracer is attached
        clock = self.tracer.clock if self.tracer is not None else SimClock()
        if self.metrics is not None:
            self._register_metrics(self.metrics)
        ad = self.batcher.adapter
        self.batcher.clock = clock
        self.batcher.tracer = self.tracer
        ad.tracer = self.tracer
        try:
            drive_prompt_loop(
                arrivals, tel,
                busy=lambda: self.batcher.busy,
                queue_depth=lambda: len(self.batcher.pending),
                max_queue=self._admit_bound,
                submit=lambda a: self.batcher.submit(Request(
                    uid=a.uid, prompt=np.asarray(a.payload, np.int32),
                    max_new_tokens=self.max_new_tokens)),
                step=self.batcher.step,
                record=lambda req, now: record_prompt_completion(
                    tel, req, now, arr_t[req.uid], arr_ep[req.uid],
                    self._token_energy_nj, self.bytes_per_token,
                    energy_spec=self.energy_spec, tracer=self.tracer,
                    slo=self.slo),
                clock=clock, tracer=self.tracer, metrics=self.metrics,
                slo=self.slo, incident=self.incident)
        finally:
            self.batcher.clock = None
            self.batcher.tracer = None
            ad.tracer = None
        if pool_stats is not None:
            tel.record_pool(pool_stats())
        if self.metrics is not None and self.metrics.samples:
            tel.record_series(self.metrics.samples)
        if self.incident is not None:
            self.incident.check_energy(tel, clock.t)
        return tel

    def debug_state(self) -> dict:
        """Forensic gateway state for incident bundles: batcher occupancy,
        the pool's debug snapshot, cascade grouping, captured keys per step
        (aggregate state only, no request payloads)."""
        ad = self.batcher.adapter
        state: dict = {
            "kind": "prompt_gateway",
            "max_new_tokens": self.max_new_tokens,
            "max_queue": self.max_queue,
            "admit_bound": self._admit_bound(),
            "shedding": self._shedding,
            "batcher": self.batcher.debug_state(),
            "jit_cache_sizes": {name: fn._cache_size()
                                for name, fn in self.jit_fns().items()},
        }
        pool = getattr(ad, "pool", None)
        if pool is not None:
            state["pool"] = pool.debug_snapshot()
        backend = getattr(ad, "backend", None)
        if backend is not None:
            state["backend"] = backend
        if backend == "cascade":
            state["cascade"] = ad.cascade_stats()
        return state

    def capture_incident(self, reason: str, *, extra: dict | None = None):
        """Explicit forensic capture: snapshot the flight ring and the
        debug state into a bundle now.  Needs an IncidentCapture attached
        at construction."""
        if self.incident is None:
            raise RuntimeError(
                "capture_incident() needs an IncidentCapture attached "
                "(PromptGateway(..., incident=...) or "
                "ServeSpec(incident_dir=...))")
        return self.incident.capture(reason, extra=extra)
