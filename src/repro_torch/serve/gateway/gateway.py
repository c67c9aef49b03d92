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

The admission, flush and charging order is the reference's
(``repro.serve.gateway.gateway.MicroBatchGateway``), so on a shared trace
with a fixed service time both ledgers agree field for field.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lenet
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.telemetry import RequestRecord, Telemetry


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
        self._frame_energy_nj = fe.frame_energy_nj(spec)
        self._link_bytes = fe.link_bytes_per_frame(spec)
        self._sensor_lat = fe.sensor_latency_s(spec)
        self._link_lat = self._link_bytes * 8 / (cfg.link_mbps * 1e6)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run every bucket once, so the kernels are built and loaded and the
        libraries' one-time set-up never lands in a measured service time."""
        ln = self.spec.lenet
        for bs in self.cfg.bucket_sizes:
            x = torch.zeros((bs, ln.image_size, ln.image_size, ln.channels),
                            dtype=torch.uint8, device=self.device)
            fe.gateway_stage(self.params,
                             fe.sensor_stage(self.params, x, self.spec),
                             self.spec)
        self._sync()

    def _bucket_for(self, n: int) -> int:
        for bs in self.cfg.bucket_sizes:
            if bs >= n:
                return bs
        return self.cfg.bucket_sizes[-1]

    def _serve_batch(self, frames: np.ndarray) -> tuple[np.ndarray, float]:
        """Returns (predictions, host_service_seconds)."""
        x = torch.from_numpy(frames).to(self.device)
        payload = fe.sensor_stage(self.params, x, self.spec)  # at-sensor
        self._sync()
        t0 = time.perf_counter()
        logits = fe.gateway_stage(self.params, payload, self.spec)
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
