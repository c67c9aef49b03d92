#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one JSON line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     TF32 switched off for matmul and cuDNN;
  2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all started together);
  3. each kernel held bitwise against its plain PyTorch version on the same
     CUDA tensors, and timed at the main path's shapes beside it;
  4. the main path: ``MicroBatchGateway`` serving the full-width LeNet-5
     (conv1 32@5x5, conv2 64@5x5, dense 512) SC frame path at bits 4 and 8
     over a seeded sensor trace, with the kernels' launch counts read around
     each run, one batch's payload held byte for byte against the plain path
     on the card and on the CPU, and its logits within 1e-4.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, and prints no result, without a CUDA device, without the
repository beside it, or when any phase fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# results per clock per SM on sm_90 (CUDA C++ Programming Guide, arithmetic
# instruction throughput): 32-bit integer compare/add, and population count
INT32_PER_CLK_SM = 64
POPC_PER_CLK_SM = 16
KERNELS = ("sng_pack", "sc_dot")
TRACE_SECONDS = 1.0             # ~330 frames from the default 64-sensor fleet


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, inner: int, sleep_cycles: int) -> tuple[float,
                                                                    float]:
    """(device, back-to-back) ms per call, each the median over ``reps`` of
    the CUDA-event time of ``inner`` calls, after two warm-up calls.

    Device: the calls are queued behind a sleep kernel longer than it takes
    the host to issue them, so the events time the kernels alone.
    Back-to-back: nothing is queued ahead, so a call shorter than the host's
    launch overhead is timed at the host's launch rate, which is what the
    frame path pays between synchronizations."""
    import torch
    fn()
    fn()
    out = []
    for sleep in (sleep_cycles, 0):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if sleep:
                torch.cuda._sleep(sleep)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        out.append(statistics.median(times))
    return out[0], out[1]


def host_ms(fn, reps: int = 10) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2

    from repro_torch.core import sng
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import sc_dot as sc_dot_k
    from repro_torch.kernels import sng_pack as sng_pack_k
    from repro_torch.models.lenet import LeNetConfig
    from repro_torch.serve.gateway import frontend as fe
    from repro_torch.serve.gateway.gateway import (GatewayConfig,
                                                   MicroBatchGateway)
    from repro_torch.serve.gateway.sensors import FleetConfig, SensorFleet

    dev = torch.device("cuda")
    wrappers = {"sng_pack": sng_pack_k.sng_pack, "sc_dot": sc_dot_k.sc_dot}

    # -- 1. the card ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    emit({"gpu": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sms": props.multi_processor_count,
          "max_sm_clock_mhz": clock_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    clk_sm = clock_mhz * 1e6 * props.multi_processor_count

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all(KERNELS)
    build_s = time.perf_counter() - t0
    emit({"build_s": build_s, "ptxas": {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()}})

    # -- 3. each kernel against its plain version ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen,
                             dtype=torch.int64, device=dev).to(torch.int32)

    err = {name: 0 for name in KERNELS}
    checks = []
    for N in (4, 16, 32, 256):
        bits = N.bit_length() - 1
        lv = torch.randint(0, N + 1, (3001, 25), generator=gen,
                           dtype=torch.int32, device=dev)
        for codes in sng.codes_tensors("ramp_lowdisc", bits, dev):
            got = sng_pack_k.sng_pack(lv, codes, N)
            want = ref.sng_pack(lv, codes, N)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err["sng_pack"] = max(err["sng_pack"], int(
                (got.long() - want.long()).abs().max()))
            checks.append({"kernel": "sng_pack", "N": N, "bitwise": ok})
    sc_cases = [(1000, K, 37, Wd, mode)
                for K in (2, 32, 64) for Wd in (1, 8)
                for mode in ("zero", "one", "alt", "ideal")]
    sc_cases += [(129, 1024, 40, 8, "alt"), (25088, 32, 64, 1, "alt"),
                 (25088, 32, 64, 8, "alt")]
    for M, K, O, Wd, mode in sc_cases:
        x, w = words(M, K, Wd), words(K, O, Wd)
        s0, adder = ("alt", "ideal") if mode == "ideal" else (mode, "tff")
        got = sc_dot_k.sc_dot(x, w, s0, adder)
        want = ref.sc_dot(x, w, s0, adder)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err["sc_dot"] = max(err["sc_dot"], int((got - want).abs().max()))
        checks.append({"kernel": "sc_dot", "M": M, "K": K, "O": O, "Wd": Wd,
                       "mode": mode, "bitwise": ok})
    bad = [c for c in checks if not c["bitwise"]]

    # timing at the main path's shapes: bucket 32 of the full LeNet-5 conv1
    M, K, Kp, O = 32 * 784, 25, 32, 2 * 32
    sleep = int(0.05 * clock_mhz * 1e6)     # 50 ms of the SM clock
    timing = {}
    for bits in (4, 8):
        N = 1 << bits
        Wd = max(1, N // 32)
        lv = torch.randint(0, N + 1, (M, K), generator=gen, dtype=torch.int32,
                           device=dev)
        codes = sng.codes_tensors("ramp_lowdisc", bits, dev)[0]
        x, w = words(M, Kp, Wd), words(Kp, O, Wd)
        n_lv = M * K
        sng_ms, sng_b2b = time_ms(lambda: sng_pack_k.sng_pack(lv, codes, N),
                                  5, 20, sleep)
        dot_ms, dot_b2b = time_ms(lambda: sc_dot_k.sc_dot(x, w, "alt", "tff"),
                                  5, 20, sleep)
        timing[("sng_pack", bits)] = {
            "shape": f"levels ({M}, {K}), N={N}",
            "ms": sng_ms, "back_to_back_ms": sng_b2b,
            "plain_ms": time_ms(lambda: ref.sng_pack(lv, codes, N), 3, 2,
                                sleep)[0],
            "bytes_ms": (4 * n_lv + 4 * N + 4 * n_lv * Wd)
            / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": n_lv * N / (INT32_PER_CLK_SM * clk_sm) * 1e3}
        timing[("sc_dot", bits)] = {
            "shape": f"x ({M}, {Kp}, {Wd}), w ({Kp}, {O}, {Wd})",
            "ms": dot_ms, "back_to_back_ms": dot_b2b,
            "plain_ms": time_ms(lambda: ref.sc_dot(x, w, "alt", "tff"), 3, 1,
                                sleep)[0],
            "bytes_ms": 4 * (M * Kp * Wd + Kp * O * Wd + M * O)
            / PEAK_BYTES_PER_S * 1e3,
            "ops_ms": M * Kp * O * Wd / (POPC_PER_CLK_SM * clk_sm) * 1e3}
    for t in timing.values():
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
            "operations"
    emit({"phase": "kernel_checks", "checks": len(checks), "failed": bad,
          "max_abs_err": err,
          "timing": [{"kernel": k, "bits": b, **v}
                     for (k, b), v in timing.items()]})
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")

    # -- 4. the main path ---------------------------------------------------
    trace = SensorFleet(FleetConfig(seed=7)).events(TRACE_SECONDS)
    launches = {name: 0 for name in KERNELS}
    for bits in (4, 8):
        spec = fe.FrontendSpec(mode="sc", bits=bits, lenet=LeNetConfig())
        gw = MicroBatchGateway(GatewayConfig(), spec, seed=0, device="cuda")
        gw.warmup()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        tel = gw.run(trace)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in wrappers.items()}
        for name in KERNELS:
            launches[name] += counts[name]
        if not all(counts.values()):
            raise SystemExit(f"bits={bits}: a kernel of the main path never "
                             f"launched: {counts}")
        # every frame is served or dropped, each charged the same frame +
        # link energy and payload bytes as the reference charges
        per_frame = fe.frame_energy_nj(spec) + \
            fe.link_energy_nj(fe.link_bytes_per_frame(spec))
        if len(tel.records) + len(tel.dropped) != len(trace) or any(
                r.energy_nj != per_frame or
                r.link_bytes != fe.link_bytes_per_frame(spec) or
                not 0 <= r.output < spec.lenet.classes for r in tel.records):
            raise SystemExit(f"bits={bits}: telemetry does not account for "
                             "the trace")

        # one batch: kernel path vs plain path on the card vs the CPU
        frames = torch.from_numpy(np.stack([a.payload for a in trace[:32]]))
        x = frames.to(dev)
        payload = fe.sensor_stage(gw.params, x, spec)
        logits = fe.gateway_stage(gw.params, payload, spec)
        with mock.patch.object(sng_pack_k, "sng_pack", ref.sng_pack), \
                mock.patch.object(sc_dot_k, "sc_dot", ref.sc_dot):
            plain_payload = fe.sensor_stage(gw.params, x, spec)
        cpu_params = {k: {n: t.cpu() for n, t in v.items()}
                      for k, v in gw.params.items()}
        cpu_payload = fe.sensor_stage(cpu_params, frames[:8], spec)
        cpu_logits = fe.gateway_stage(cpu_params, cpu_payload, spec)
        torch.cuda.synchronize()
        same_plain = torch.equal(payload, plain_payload)
        same_cpu = torch.equal(payload[:8].cpu(), cpu_payload)
        logit_err = float((logits[:8].cpu() - cpu_logits).abs().max())
        close = torch.allclose(logits[:8].cpu(), cpu_logits, atol=1e-4,
                               rtol=1e-4)
        finite = bool(torch.isfinite(logits).all()) and \
            tuple(logits.shape) == (32, spec.lenet.classes)

        stage_ms = {}
        for bs in gw.cfg.bucket_sizes:
            xb = x[:bs].contiguous()
            pb = fe.sensor_stage(gw.params, xb, spec)
            stage_ms[bs] = {
                "sensor_ms": host_ms(lambda: fe.sensor_stage(gw.params, xb,
                                                             spec)),
                "gateway_ms": host_ms(lambda: fe.gateway_stage(gw.params, pb,
                                                               spec))}
        rep = tel.report(TRACE_SECONDS)
        emit({"phase": "main_path", "bits": bits, "frames": len(trace),
              "served": len(tel.records), "dropped": len(tel.dropped),
              "run_s": run_s, "launches": counts,
              "payload_equal_plain_on_card": same_plain,
              "payload_equal_cpu": same_cpu,
              "logits_max_abs_err_vs_cpu": logit_err,
              "logits_close_1e-4": close, "logits_finite_shape": finite,
              "j_per_frame": rep.get("j_per_inference"),
              "link_bytes_per_frame": rep.get("link_bytes_per_req"),
              "p50_latency_ms": rep.get("p50_latency_ms"),
              "p99_latency_ms": rep.get("p99_latency_ms"),
              "stage_ms_by_bucket": stage_ms})
        if not (same_plain and same_cpu and close and finite):
            raise SystemExit(f"bits={bits}: the served output disagrees with "
                             "the plain path")

    # -- 5. the result ------------------------------------------------------
    sources = {"sng_pack": ("src/repro_torch/kernels/csrc/sng_pack.cu",
                            "src/repro/kernels/sng_pack.py:33"),
               "sc_dot": ("src/repro_torch/kernels/csrc/sc_dot.cu",
                          "src/repro/kernels/sc_dot.py:80")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": err[name], "ms": timing[(name, 4)]["ms"],
         "plain_ms": timing[(name, 4)]["plain_ms"],
         "bound_ms": timing[(name, 4)]["bound_ms"],
         "bound_by": timing[(name, 4)]["bound_by"], "library_ms": None,
         "shape": timing[(name, 4)]["shape"]}
        for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
