"""Sensor-fleet workload: deterministic Poisson/bursty arrival streams.

Each endpoint is an independent Markov-modulated Poisson source: it
alternates exponentially-distributed OFF (baseline rate) and ON
(``burst_factor`` x rate) phases, which produces the heavy-tailed arrival
clumps that make micro-batching interesting (a plain Poisson fleet barely
exercises the deadline/backpressure paths).  Everything is a pure function
of ``(seed, endpoint)``, so a trace is exactly reproducible and two runs
with different gateway configs see the *same* offered load.

Two endpoint kinds:
  frame  — 28x28 u8 sensor frames (synthetic digit set), the hybrid LeNet
           path;
  prompt — int32 token prompts for the LM path, lengths drawn from a small
           fixed set so slot-batcher prefill compiles stay bounded.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import mnist_synth


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_endpoints: int = 64
    frame_rate_hz: float = 4.0        # mean per-endpoint baseline rate
    burst_factor: float = 4.0         # ON-phase rate multiplier
    burst_on_s: float = 0.5           # mean ON duration
    burst_off_s: float = 2.0          # mean OFF duration; <=0 disables bursts
    prompt_fraction: float = 0.0      # fraction of endpoints emitting prompts
    prompt_lens: tuple[int, ...] = (8, 12, 16)
    prompt_vocab: int = 256
    image_pool: int = 256             # synthetic frames to cycle through
    seed: int = 0

    @property
    def bursty(self) -> bool:
        return self.burst_off_s > 0 and self.burst_factor > 1


@dataclasses.dataclass(frozen=True)
class Arrival:
    uid: int
    t: float                          # seconds since trace start
    endpoint: int
    kind: str                         # "frame" | "prompt"
    payload: np.ndarray               # (28,28,1) u8 | (S,) int32
    label: int = -1                   # ground-truth digit for frames


def _endpoint_times(rng: np.random.Generator, cfg: FleetConfig,
                    duration: float) -> list[float]:
    ts: list[float] = []
    t, on = 0.0, False
    phase_end = (rng.exponential(cfg.burst_off_s) if cfg.bursty
                 else float("inf"))
    while t < duration:
        rate = cfg.frame_rate_hz * (cfg.burst_factor if on else 1.0)
        dt = rng.exponential(1.0 / rate)
        if t + dt > phase_end:
            t = phase_end
            on = not on
            phase_end = t + rng.exponential(
                cfg.burst_on_s if on else cfg.burst_off_s)
            continue
        t += dt
        if t < duration:
            ts.append(t)
    return ts


class SensorFleet:
    """Generates the merged, time-sorted arrival trace for the fleet."""

    def __init__(self, cfg: FleetConfig = FleetConfig()):
        self.cfg = cfg
        xtr, ytr, _, _ = mnist_synth.dataset(cfg.image_pool, 16, seed=1)
        self._frames = xtr               # (pool, 28, 28, 1) u8
        self._labels = ytr
        n_prompt = int(round(cfg.n_endpoints * cfg.prompt_fraction))
        self._prompt_endpoints = set(range(n_prompt))   # first N are textual

    def events(self, duration: float) -> list[Arrival]:
        cfg = self.cfg
        out: list[Arrival] = []
        for ep in range(cfg.n_endpoints):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, ep]))
            for t in _endpoint_times(rng, cfg, duration):
                if ep in self._prompt_endpoints:
                    n = int(rng.choice(cfg.prompt_lens))
                    payload = rng.integers(0, cfg.prompt_vocab, size=n,
                                           dtype=np.int32)
                    out.append(Arrival(0, t, ep, "prompt", payload))
                else:
                    i = int(rng.integers(len(self._frames)))
                    out.append(Arrival(0, t, ep, "frame", self._frames[i],
                                       int(self._labels[i])))
        out.sort(key=lambda a: a.t)
        return [dataclasses.replace(a, uid=i) for i, a in enumerate(out)]

    def offered_load_hz(self) -> float:
        """Mean fleet arrival rate implied by the config (for reports)."""
        cfg = self.cfg
        if not cfg.bursty:
            return cfg.n_endpoints * cfg.frame_rate_hz
        on = cfg.burst_on_s / (cfg.burst_on_s + cfg.burst_off_s)
        rate = cfg.frame_rate_hz * ((1 - on) + on * cfg.burst_factor)
        return cfg.n_endpoints * rate
