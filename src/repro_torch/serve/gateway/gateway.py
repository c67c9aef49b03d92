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
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lenet
from repro_torch.serve import capture
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, Request
from repro_torch.serve.gateway.telemetry import RequestRecord, Telemetry
from repro_torch.serve.obs.tracer import SimClock


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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        self._sync()

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

    def _bucket_for(self, n: int) -> int:
        for bs in self.cfg.bucket_sizes:
            if bs >= n:
                return bs
        return self.cfg.bucket_sizes[-1]

    def _serve_batch(self, frames: np.ndarray) -> tuple[np.ndarray, float]:
        """Returns (predictions, host_service_seconds)."""
        bs = frames.shape[0]
        payload = self._sensor_fns[bs](frames)                # at-sensor
        self._sync()
        t0 = time.perf_counter()
        logits = self._gateway_fns[bs](payload)
        self._sync()
        svc = time.perf_counter() - t0
        if self.cfg.service_model == "fixed":
            svc = self.cfg.fixed_service_s
        return logits.argmax(-1).cpu().numpy(), svc

    def run(self, arrivals: list[Arrival],
            telemetry: Telemetry | None = None) -> Telemetry:
        tel = telemetry if telemetry is not None else Telemetry()
        arrivals = [a for a in arrivals if a.kind == "frame"]
        # payload hits the gateway queue after at-sensor compute + link time
        offset = self._sensor_lat + self._link_lat
        queue: deque[Arrival] = deque()
        max_bs = self.cfg.bucket_sizes[-1]
        now, i, n = 0.0, 0, len(arrivals)
        # the reference's per-request energy: these addends, folded in order
        energy_nj = 0.0
        for v in (self._frame_energy_nj, fe.link_energy_nj(self._link_bytes)):
            energy_nj += v

        def admit_until(t: float):
            nonlocal i
            while i < n and arrivals[i].t + offset <= t:
                a = arrivals[i]
                i += 1
                if len(queue) >= self.cfg.max_queue:
                    tel.drop(a.uid, "frame", "queue_full", a.t + offset)
                else:
                    queue.append(a)

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
            preds, svc = self._serve_batch(frames)
            now += svc
            for j, a in enumerate(batch):
                tel.record(RequestRecord(
                    uid=a.uid, endpoint=a.endpoint, kind="frame",
                    t_arrival=a.t, t_done=now, energy_nj=energy_nj,
                    link_bytes=self._link_bytes, output=int(preds[j])))
        return tel


def drive_prompt_loop(arrivals, tel: Telemetry, *, busy, queue_depth,
                      max_queue, submit, step, record,
                      clock: SimClock | None = None) -> None:
    """The prompt path's virtual-time event loop: drain arrivals into
    ``submit`` as virtual time reaches them (dropping, with accounting,
    beyond ``max_queue`` queued requests), charge each ``step``'s measured
    wall time to the virtual clock, and ``record(req, now)`` every
    completion.  ``clock``, when given, is
    advanced with the loop so the batcher can stamp dequeue/admit times."""
    now, i, n = 0.0, 0, len(arrivals)
    while i < n or busy():
        if not busy():
            now = max(now, arrivals[i].t)
            if clock is not None:
                clock.advance(now)
        while i < n and arrivals[i].t <= now:
            a = arrivals[i]
            i += 1
            if queue_depth() >= max_queue:
                tel.drop(a.uid, "prompt", "queue_full", now)
                continue
            submit(a)
        t0 = time.perf_counter()
        finished = step()
        now += time.perf_counter() - t0
        if clock is not None:
            clock.advance(now)
        for req in finished:
            record(req, now)


def record_prompt_completion(tel: Telemetry, req: Request, now: float,
                             t_arrival: float, endpoint: int,
                             token_energy_nj: float,
                             bytes_per_token: int) -> None:
    """Charge one finished prompt request into the ledger, as the reference
    does: per processed token the first-projection energy (prefix-cache
    resumes skip the shared prompt tokens; the link still carries every
    token), plus the link energy, folded left to right."""
    n_tokens = len(req.prompt) + len(req.generated)
    processed = n_tokens - req.prefill_tokens_skipped
    link = bytes_per_token * n_tokens
    # tokens the batched decode tick produced vs tokens the prefill pass
    # processed (the first generated token comes out of prefill)
    decode_tok = max(0, len(req.generated) - 1)
    parts = (token_energy_nj * (processed - decode_tok),
             token_energy_nj * decode_tok,
             fe.link_energy_nj(link))
    energy_nj = 0.0
    for v in parts:
        energy_nj += v
    tel.record(RequestRecord(
        uid=req.uid, endpoint=endpoint, kind="prompt",
        t_arrival=t_arrival, t_done=now, energy_nj=energy_nj,
        link_bytes=link, output=req.generated[-1],
        kv_blocks=req.kv_blocks,
        prefix_hit_blocks=req.prefix_hit_blocks,
        prefill_tokens_skipped=req.prefill_tokens_skipped,
        energy_saved_nj=token_energy_nj * req.prefill_tokens_skipped,
        migration_bytes=req.migration_bytes, migrations=req.migrations,
        t_dequeue=req.t_dequeue, t_admit=req.t_admit,
        tokens_out=len(req.generated)))


class PromptGateway:
    """The LM path: prompt arrivals -> continuous slot batcher, virtual time.

    ``warmup`` drives one dummy request per prompt length through the
    batcher, so kernel builds and one-time library set-up never land in the
    virtual clock, and admission is bounded by ``max_queue`` (excess prompts
    are rejected and counted).  Each request is charged energy per
    processed token (``frontend.lm_token_energy_nj``) plus link energy; the
    paged pool's counters are recorded into the telemetry at drain.

    The observability attachments (``tracer``, ``metrics``, ``slo``,
    ``flight``, ``incident``) are the reference's arguments; they must be
    None until the observability slice is ported."""

    def __init__(self, batcher: ContinuousBatcher, max_new_tokens: int = 16,
                 bytes_per_token: int = 4, max_queue: int = 64,
                 energy_spec: fe.FrontendSpec | None = None,
                 tracer=None, metrics=None, slo=None, flight=None,
                 incident=None):
        obs = {"tracer": tracer, "metrics": metrics, "slo": slo,
               "flight": flight, "incident": incident}
        if any(v is not None for v in obs.values()):
            raise NotImplementedError(
                f"{[k for k, v in obs.items() if v is not None]}: the "
                "observability hooks are not ported yet (ROADMAP.md §1, "
                "observability)")
        self.batcher = batcher
        self.max_new_tokens = max_new_tokens
        self.bytes_per_token = bytes_per_token
        self.max_queue = max_queue
        self.energy_spec = energy_spec if energy_spec is not None \
            else fe.FrontendSpec()
        self._token_energy_nj = fe.lm_token_energy_nj(
            self.energy_spec, batcher.adapter.cfg.d_model)

    def jit_fns(self) -> dict:
        """The adapter's named captured steps, for
        ``obs.RecompileDetector.track``."""
        fns = getattr(self.batcher.adapter, "jit_fns", None)
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

    def run(self, arrivals: list[Arrival],
            telemetry: Telemetry | None = None) -> Telemetry:
        tel = telemetry if telemetry is not None else Telemetry()
        arrivals = [a for a in arrivals if a.kind == "prompt"]
        arr_t = {a.uid: a.t for a in arrivals}
        arr_ep = {a.uid: a.endpoint for a in arrivals}
        pool_stats = getattr(self.batcher.adapter, "pool_stats", None)
        clock = SimClock()
        self.batcher.clock = clock
        try:
            drive_prompt_loop(
                arrivals, tel,
                busy=lambda: self.batcher.busy,
                queue_depth=lambda: len(self.batcher.pending),
                max_queue=self.max_queue,
                submit=lambda a: self.batcher.submit(Request(
                    uid=a.uid, prompt=np.asarray(a.payload, np.int32),
                    max_new_tokens=self.max_new_tokens)),
                step=self.batcher.step,
                record=lambda req, now: record_prompt_completion(
                    tel, req, now, arr_t[req.uid], arr_ep[req.uid],
                    self._token_energy_nj, self.bytes_per_token),
                clock=clock)
        finally:
            self.batcher.clock = None
        if pool_stats is not None:
            tel.record_pool(pool_stats())
        return tel
