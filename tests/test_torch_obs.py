"""The port's observability layer (``repro_torch.serve.obs``) and its hooks
on the frame path and the prompt path, held against the reference on the
CPU.

The reference's behavioural tests (``tests/test_obs.py``: the tracer's
strict nesting, zero callbacks when nothing is attached, bitwise span
energy on both paths, prefix-resume instants, metrics, Chrome trace
export) run on the port below, with helpers of the same names (the port's
stablelm-3b smoke config in float32 with the reference's weights, frame
gateways on the CPU).  Then the parity tests: one seeded event stream
through both packages' ``Tracer``; both frame gateways at
``service_model="fixed"`` with tracer, metrics, SLO, flight and incident
attached (events, samples, transitions, critical paths, flight rings,
bundles, Chrome trace JSON and OpenMetrics text equal, energy re-folded
bit for bit, ``sc`` and ``binary``); and both prompt gateways (the chunked
paged gateway, ``"plain"`` and ``"cascade"``, and the dense ``ServeSpec()``
one) under fake clocks that advance a fixed step per call, with equal
events (span names, nesting, stamps, chunk args, resume instants, ticks)
and samples, and tokens, ledger, pool counters and captured keys bit for
bit the untraced run's."""
import dataclasses
import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.serve import obs as jobs
from repro.serve import spec as jspec
from repro.serve.gateway import frontend as jfe
from repro.serve.gateway import gateway as jgw
from repro.serve.gateway import sensors as jsensors
from repro.serve.obs import tracer as jtracer
from repro_torch.convert import lenet_params_from_jax
from repro_torch.serve import obs
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway import gateway as gw_mod
from repro_torch.serve.gateway.gateway import GatewayConfig, PromptGateway
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, make_adapter
from repro_torch.serve.gateway.telemetry import Telemetry
from repro_torch.serve.obs import tracer as tracer_mod
from test_torch_lm import smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4

_SETUP_CACHE: dict = {}


def _setup(arch="stablelm_3b"):
    """The port's smoke config of ``arch`` in float32 with the reference's
    weights (the reference tests' ``lm.init(jax.random.key(0), ...)``)."""
    if arch not in _SETUP_CACHE:
        _, _, cfg, params = smoke_pair(arch=arch)
        _SETUP_CACHE[arch] = (cfg, params)
    return _SETUP_CACHE[arch]


def MicroBatchGateway(cfg, spec, **kw):
    """The port's frame gateway, on the CPU."""
    return gw_mod.MicroBatchGateway(cfg, spec, device="cpu", **kw)


def make_gateway(cfg, params, spec=None, **kw):
    """The port's ``make_gateway``, on the CPU."""
    return spec_mod.make_gateway(cfg, params, spec, device="cpu", **kw)


class FakeTime:
    """A stand-in for the ``time`` module: ``perf_counter`` advances a
    fixed step per call, so a run's virtual clock depends on its calls
    alone."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def fake_clock(gateway_module, tracer_module):
    """Patch one package's gateway and tracer modules with fresh
    :class:`FakeTime` clocks, one each: the serving loop's virtual time
    then depends on its own calls alone, the same traced and untraced,
    and the tracer's wall offsets inside a step (1 us a call) stay inside
    the step's virtual extent (1 ms a loop call), as a real clock's do."""
    return mock.patch.multiple(gateway_module, time=FakeTime()), \
        mock.patch.multiple(tracer_module, time=FakeTime(1e-6))


def _prompt_arrivals(cfg, n, plen=8, seed=0, dt=0.001):
    rng = np.random.default_rng(seed)
    return [Arrival(t=i * dt, uid=i, endpoint=0, kind="prompt",
                    payload=rng.integers(0, cfg.vocab, plen)
                    .astype(np.int32)) for i in range(n)]


def _frame_arrivals(n, seed=0, dt=0.0005):
    rng = np.random.default_rng(seed)
    return [Arrival(t=i * dt, uid=i, endpoint=0, kind="frame",
                    payload=rng.integers(0, 255, (28, 28, 1))
                    .astype(np.uint8)) for i in range(n)]


def test_tracer_strict_nesting_enforced_at_record_time():
    tr = obs.Tracer()
    tr.clock.advance(1.0)
    tr.begin("a", tid=7)
    tr.clock.advance(2.0)
    tr.begin("b", tid=7)
    with pytest.raises(AssertionError):
        tr.end("a", tid=7)              # b is innermost: a may not close
    tr.clock.advance(3.0)
    tr.end("b", tid=7)
    tr.end("a", tid=7)
    with pytest.raises(AssertionError):
        tr.end("a", tid=7)              # nothing open
    tr.assert_nested()
    spans = {s["name"]: s for s in tr.spans()}
    assert spans["a"]["ts"] == 1.0 and spans["a"]["dur"] == 2.0
    assert spans["b"]["ts"] == 2.0 and spans["b"]["dur"] == 1.0


def test_tracer_open_span_fails_nesting_check():
    tr = obs.Tracer()
    tr.begin("left_open", tid=1)
    with pytest.raises(AssertionError, match="open spans"):
        tr.assert_nested()


def test_sim_clock_is_monotone():
    c = obs.SimClock()
    c.advance(2.0)
    c.advance(1.0)                      # going backwards is a no-op
    assert c.t == 2.0


def test_disabled_tracing_makes_zero_callbacks():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=3)
    gw.warmup((4, 8))
    c0 = obs.callback_count()
    tel = gw.run(_prompt_arrivals(cfg, 4))
    assert tel.report(1.0, "prompt")["completed"] == 4
    # SLO stamps still work without a tracer (bare SimClock path) ...
    assert all(r.t_admit >= 0 for r in tel.records)
    # ... and not one Python-level tracer callback was made
    assert obs.callback_count() == c0


def test_disabled_tracing_frame_path_zero_callbacks():
    spec = fe.FrontendSpec(mode="sc", bits=4)
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 2, 4),
                                         service_model="fixed",
                                         fixed_service_s=0.001), spec)
    gw.warmup()
    c0 = obs.callback_count()
    tel = gw.run(_frame_arrivals(8))
    assert tel.report(1.0, "frame")["completed"] == 8
    assert obs.callback_count() == c0


@pytest.mark.parametrize("mode", ["sc", "binary"])
def test_frame_span_energy_conserved_bitwise(mode):
    spec = fe.FrontendSpec(mode=mode, bits=4)
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 2, 4),
                                         service_model="fixed",
                                         fixed_service_s=0.001), spec)
    gw.warmup()
    tracer = obs.Tracer()
    tel = gw.run(_frame_arrivals(10), tracer=tracer)
    tel.assert_conserved()
    tracer.assert_nested()
    tracer.assert_energy_conserved(tel)     # float equality, not isclose
    spans = tracer.request_spans()
    assert set(spans) == {r.uid for r in tel.records}
    # every lifecycle stage is present and the span covers arrival -> done
    for r in tel.records:
        s = spans[r.uid]
        assert s["ts"] == r.t_arrival
        assert s["ts"] + s["dur"] == pytest.approx(r.t_done, abs=1e-12)
    for name in ("sensor_link", "queue_wait", "serve", "batch"):
        assert tracer.spans(name)


def test_prompt_span_energy_conserved_bitwise_and_slo_stats():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    tracer = obs.Tracer()
    metrics = obs.MetricsRegistry(interval_s=1e-4)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=3,
                       tracer=tracer, metrics=metrics)
    c0 = obs.callback_count()
    gw.warmup((4, 8))
    assert obs.callback_count() == c0       # warmup is never traced
    tel = gw.run(_prompt_arrivals(cfg, 5))
    tel.assert_conserved()
    tracer.assert_nested()
    tracer.assert_energy_conserved(tel)
    assert set(tracer.request_spans()) == {r.uid for r in tel.records}
    assert tracer.spans("prefill") and tracer.spans("decode")
    assert tracer.spans("prefill_chunk")    # paged fold chunks traced
    assert tracer.spans("tick")             # engine track
    rep = tel.report(1.0, "prompt")
    assert rep["n_samples"] == 5 and rep["slo_n_samples"] == 5
    for k in ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
              "queue_wait_p50_ms", "queue_wait_p99_ms"):
        assert rep[k] >= 0.0
    # interval time-series rode into the report (pool occupancy + queue)
    series = rep["series"]
    assert len(series) >= 2
    assert all("pool_blocks_in_use" in s and "queue_depth" in s
               for s in series)


def test_prefix_hit_chunks_marked_in_trace():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=1, max_len=16, paged=True,
                      block_size=BS)
    tracer = obs.Tracer()
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=2,
                       tracer=tracer)
    gw.warmup((4,))
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, 2 * BS).astype(np.int32)
    arrs = [
        Arrival(t=0.0, uid=0, endpoint=0, kind="prompt",
                payload=np.concatenate([prefix, [1, 2]]).astype(np.int32)),
        Arrival(t=10.0, uid=1, endpoint=0, kind="prompt",
                payload=np.concatenate([prefix, [3, 4]]).astype(np.int32)),
    ]
    tel = gw.run(arrs)
    tracer.assert_energy_conserved(tel)
    resumes = [e for e in tracer.events if e["name"] == "prefix_resume"]
    assert len(resumes) == 1                # only the warm request resumed
    assert resumes[0]["args"]["blocks"] == 2
    assert resumes[0]["args"]["tokens_skipped"] == 2 * BS
    assert resumes[0]["tid"] == 1           # on the warm request's track
    # the warm request folded fewer chunks than the cold one
    chunks = tracer.spans("prefill_chunk")
    cold = [c for c in chunks if c["tid"] == 0]
    warm = [c for c in chunks if c["tid"] == 1]
    assert len(warm) < len(cold)
    assert all(c["args"]["prefix_hit"] is False for c in chunks)


def test_drop_reasons_and_legacy_tuple_shape():
    tel = Telemetry()
    tel.drop(7, "frame")                    # legacy 2-arg call still works
    tel.drop(8, "prompt", "queue_full", 1.5)
    assert [d[:2] for d in tel.dropped] == [(7, "frame"), (8, "prompt")]
    rep = tel.report(1.0)
    assert rep["dropped"] == 2
    assert rep["dropped_by_reason"] == {"unspecified": 1, "queue_full": 1}
    assert tel.report(1.0, "prompt")["dropped_by_reason"] == \
        {"queue_full": 1}


def test_gateway_drop_carries_reason_and_time():
    spec = fe.FrontendSpec(mode="sc", bits=4)
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 2),
                                         max_queue=2,
                                         service_model="fixed",
                                         fixed_service_s=1.0), spec)
    gw.warmup()
    tel = gw.run(_frame_arrivals(16, dt=1e-5))
    rep = tel.report(1.0, "frame")
    assert rep["dropped"] > 0
    assert rep["dropped_by_reason"] == {"queue_full": rep["dropped"]}
    assert all(d[2] == "queue_full" and d[3] > 0 for d in tel.dropped)


def test_report_zero_duration_and_tiny_samples_guarded():
    tel = Telemetry()
    rep = tel.report(0.0)                   # must not divide by zero
    assert rep["throughput_hz"] == 0.0 and rep["n_samples"] == 0
    assert "p99_latency_ms" not in rep      # no percentile claims on n=0
    rep = tel.report(-1.0)
    assert rep["throughput_hz"] == 0.0


def test_report_series_passthrough():
    tel = Telemetry()
    tel.record_series([{"t": 0.0, "q": 1}, {"t": 0.1, "q": 2}])
    assert tel.report(1.0)["series"] == [{"t": 0.0, "q": 1},
                                         {"t": 0.1, "q": 2}]


def test_metrics_counters_gauges_sources_and_interval():
    m = obs.MetricsRegistry(interval_s=0.1)
    depth = {"v": 3}
    m.register("queue_depth", lambda: depth["v"])
    m.inc("completed")
    m.inc("completed", 2)
    m.set_gauge("load", 0.5)
    assert m.maybe_sample(0.0)              # first call always samples
    assert not m.maybe_sample(0.05)         # inside the interval
    depth["v"] = 9
    assert m.maybe_sample(0.2)
    assert len(m.samples) == 2
    assert m.samples[0] == {"t": 0.0, "completed": 3.0, "load": 0.5,
                            "queue_depth": 3}
    assert m.samples[1]["queue_depth"] == 9
    ts, vs = m.series("queue_depth")
    assert ts == [0.0, 0.2] and vs == [3, 9]


def test_metrics_percentiles_carry_sample_count():
    m = obs.MetricsRegistry()
    assert m.percentiles("lat") == {"n": 0, "n_dropped": 0}
    for v in (1.0, 2.0, 3.0):
        m.observe("lat", v)
    p = m.percentiles("lat")
    assert p["n"] == 3 and p["p50"] == 2.0
    assert p["n_dropped"] == 0      # under the cap: summary is exact


def test_gateway_jit_fns_zero_steady_state_recompiles():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=3)
    gw.warmup((8,))
    det = obs.RecompileDetector()
    det.track("gateway", gw.jit_fns())
    det.snapshot()
    gw.run(_prompt_arrivals(cfg, 4))
    assert det.steady_state_recompiles() == 0, det.report()


def test_chrome_trace_export_is_valid_and_loadable(tmp_path):
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    tracer = obs.Tracer()
    metrics = obs.MetricsRegistry(interval_s=1e-4)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=2,
                       tracer=tracer, metrics=metrics)
    gw.warmup((8,))
    gw.run(_prompt_arrivals(cfg, 3))
    path = tmp_path / "trace.json"
    obj = obs.write_chrome_trace(str(path), tracer, metrics)
    assert obs.validate_chrome_trace(obj) == []
    with open(path) as f:
        loaded = json.load(f)               # round-trips as plain JSON
    assert obs.validate_chrome_trace(loaded) == []
    names = {e["name"] for e in loaded["traceEvents"]}
    assert {"request", "prefill", "decode", "tick",
            "metrics", "process_name"} <= names
    # counter tracks carry the sampled metrics
    cs = [e for e in loaded["traceEvents"] if e["ph"] == "C"]
    assert cs and all("queue_depth" in e["args"] for e in cs)
    mpath = tmp_path / "metrics.jsonl"
    n = obs.write_metrics_jsonl(str(mpath), metrics)
    assert n == len(metrics.samples) > 0
    lines = [json.loads(ln) for ln in mpath.read_text().splitlines()]
    assert len(lines) == n and all("t" in ln for ln in lines)


def test_chrome_trace_validator_catches_structural_breaks():
    assert obs.validate_chrome_trace([]) == ["trace is not a JSON object"]
    assert obs.validate_chrome_trace({}) == \
        ["missing/invalid 'traceEvents' array"]
    bad = {"traceEvents": [
        {"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": 0.0},
        {"name": "y", "ph": "Z", "pid": 0, "tid": 0, "ts": "no"},
    ]}
    errs = obs.validate_chrome_trace(bad)
    assert any("missing numeric dur" in e for e in errs)
    assert any("unknown phase" in e for e in errs)
    assert any("non-numeric ts" in e for e in errs)
    with pytest.raises(AssertionError, match="invalid trace"):
        obs.write_chrome_trace("/dev/null", obs.Tracer())  # empty events



# ==========================================================================
# Parity with the reference.
# ==========================================================================

def _drive_tracer(o, tmod, seed: int) -> list[dict]:
    """One seeded stream of tracer calls (nested spans on several lanes,
    instants, counters, lane context, anchored stamps under a fake clock)
    through the package ``o``; returns its events."""
    rng = np.random.default_rng(seed)
    with mock.patch.multiple(tmod, time=FakeTime(0.25e-3)):
        tr = o.Tracer()
        open_: dict[int, list[str]] = {}
        for _ in range(400):
            tr.clock.advance(tr.clock.t + float(rng.uniform(0, 1e-3)))
            tid = int(rng.integers(0, 5))
            op = rng.integers(0, 7)
            stack = open_.setdefault(tid, [])
            if op <= 1 and len(stack) < 4:
                name = f"s{int(rng.integers(0, 3))}"
                tr.begin(name, tid=tid, args={"k": int(rng.integers(9))})
                stack.append(name)
            elif op == 2 and stack:
                assert tr.innermost(tid=tid) == stack[-1]
                tr.end(stack.pop(), tid=tid, args={"d": len(stack)})
            elif op == 3:
                tr.instant("mark", tid=tid, args={"x": float(rng.random())})
            elif op == 4:
                tr.counter("c", {"v": int(rng.integers(100))})
            elif op == 5:
                tr.set_ctx(tid)
                tr.instant("ctx")
            else:
                tr.anchor()
                tr.instant("anchored", tid=tid)
                tr.release()
        for tid, stack in open_.items():
            while stack:
                tr.end(stack.pop(), tid=tid)
        tr.assert_nested()
        return tr.events


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_records_the_reference_events(seed):
    assert _drive_tracer(obs, tracer_mod, seed) == \
        _drive_tracer(jobs, jtracer, seed)


def _policy(o, target=0.006):
    return o.SLOPolicy(
        objectives=(o.SLObjective("queue_wait", target=target, budget=0.05),
                    o.SLObjective("drop_rate", budget=0.05)),
        windows=(o.BurnWindow(0.05, 0.01, 8.0, "critical"),
                 o.BurnWindow(0.05, 0.01, 2.0, "warn")))


def _frame_attachments(o, out_dir):
    """Tracer, metrics, SLO monitor, flight recorder and incident capture
    of package ``o``, wired as a user would wire them."""
    tr = o.Tracer()
    m = o.MetricsRegistry(interval_s=0.005)
    mon = o.SLOMonitor(_policy(o), tracer=tr, metrics=m)
    fl = o.FlightRecorder(span_cap=64, seed=5)
    inc = o.IncidentCapture(str(out_dir), flight=fl, slo=mon, metrics=m,
                            cooldown_s=0.0, drop_burst=4,
                            drop_window_s=0.05)
    return dict(tracer=tr, metrics=m, slo=mon, flight=fl, incident=inc)


def _frame_pair(mode):
    """Both frame gateways under an overload (service 2 ms per frame,
    arrivals every 1 ms) on the reference's weights."""
    kw = dict(bucket_sizes=(1,), max_queue=16, max_delay_s=0.0005,
              service_model="fixed", fixed_service_s=0.002)
    ref = jgw.MicroBatchGateway(jgw.GatewayConfig(**kw),
                                jfe.FrontendSpec(mode=mode, bits=4), seed=1)
    params = lenet_params_from_jax(jax.tree.map(np.asarray, ref.params),
                                   "cpu")
    port = MicroBatchGateway(GatewayConfig(**kw),
                             fe.FrontendSpec(mode=mode, bits=4),
                             params=params)
    ref.warmup()
    port.warmup()
    return ref, port


def _arrivals(mod, n):
    rng = np.random.default_rng(0)
    return [mod.Arrival(t=i * 0.001, uid=i, endpoint=i % 3, kind="frame",
                        payload=rng.integers(0, 255, (28, 28, 1))
                        .astype(np.uint8)) for i in range(n)]


@pytest.mark.parametrize("mode", ["sc", "binary"])
def test_frame_path_matches_reference_exactly(mode, tmp_path):
    ref, port = _frame_pair(mode)
    ours = _frame_attachments(obs, tmp_path / "port")
    theirs = _frame_attachments(jobs, tmp_path / "ref")
    tel = port.run(_arrivals(gw_mod, 40), **ours)
    jtel = ref.run(_arrivals(jgw, 40), **theirs)
    for a, b in zip(tel.records, jtel.records, strict=True):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tel.dropped == jtel.dropped and tel.dropped
    tr, jtr = ours["tracer"], theirs["tracer"]
    assert tr.events == jtr.events
    assert ours["metrics"].samples == theirs["metrics"].samples
    mon, jmon = ours["slo"], theirs["slo"]
    assert mon.transitions == jmon.transitions and mon.transitions
    assert mon.report() == jmon.report()
    assert [dataclasses.asdict(e) for e in mon.pressure.events] == \
        [dataclasses.asdict(e) for e in jmon.pressure.events]
    cps = obs.analyze_critical_paths(tr.events)
    assert cps == jobs.analyze_critical_paths(jtr.events)
    assert all(obs.critpath.verify(cp) for cp in cps)
    assert obs.aggregate_critical_paths(cps) == \
        jobs.aggregate_critical_paths(cps)
    assert ours["flight"].snapshot() == theirs["flight"].snapshot()
    # the span stream re-folds to the ledger bit for bit
    tr.assert_nested()
    tr.assert_energy_conserved(tel)
    assert obs.stage_energy(tr, tel)["conserved"] is True
    assert len(tr.request_spans()) == len(tel.records)
    # the bundles, field for field (their paths aside)
    caps, jcaps = ours["incident"].captures, theirs["incident"].captures
    assert [(c["reason"], c["t"], c["seq"]) for c in caps] == \
        [(c["reason"], c["t"], c["seq"]) for c in jcaps]
    assert {c["reason"] for c in caps} >= {"slo_critical", "drop_burst"}
    for c, jc in zip(caps, jcaps):
        assert obs.load_incident_bundle(c["path"]) == \
            jobs.load_incident_bundle(jc["path"])
    # the exporters, byte for byte
    assert json.dumps(obs.chrome_trace(tr, ours["metrics"])) == \
        json.dumps(jobs.chrome_trace(jtr, theirs["metrics"]))
    assert obs.validate_chrome_trace(obs.chrome_trace(tr)) == []
    text = obs.openmetrics_text(ours["metrics"], mon)
    assert text == jobs.openmetrics_text(theirs["metrics"], jmon)
    assert obs.validate_openmetrics(text) == []
    # nothing attached: the same ledger, no obs call
    c0 = obs.callback_count()
    bare = port.run(_arrivals(gw_mod, 40))
    assert obs.callback_count() == c0
    assert [dataclasses.asdict(r) for r in bare.records] == \
        [dataclasses.asdict(r) for r in tel.records]


def _prompt_load(mod, vocab):
    """Six prompts, the first five sharing a 12-token prefix (three full
    blocks), the later ones arriving after the first have indexed it."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 3 * BS)
    out = []
    for i in range(6):
        tail = rng.integers(0, vocab, 2 + i % 3)
        p = np.concatenate([prefix, tail]) if i < 5 else \
            rng.integers(0, vocab, 9)
        out.append(mod.Arrival(t=0.0 if i < 2 else 0.02 + 0.002 * i, uid=i,
                               endpoint=i % 2, kind="prompt",
                               payload=p.astype(np.int32)))
    return out


def _prompt_gateways(kind, o, jo):
    """The port's and the reference's gateway of ``kind`` ("plain" /
    "cascade": chunked paged; "dense": ``ServeSpec()``), with ``o`` /
    ``jo`` (the packages' obs, or None) attached."""
    jcfg, jparams, cfg, params = _PAIR
    kw = dict(n_slots=3, max_len=32, max_new_tokens=4)
    if kind != "dense":
        kw.update(paged=True, block_size=BS)
    ours = theirs = {}
    if o is not None:
        ours = dict(tracer=o.Tracer(), metrics=o.MetricsRegistry(
            interval_s=0.004), slo=o.SLOMonitor(o.SLOPolicy.default(
                period_s=1.0, ttft_s=0.01)))
        theirs = dict(tracer=jo.Tracer(), metrics=jo.MetricsRegistry(
            interval_s=0.004), slo=jo.SLOMonitor(jo.SLOPolicy.default(
                period_s=1.0, ttft_s=0.01)))
    gw = make_gateway(cfg, params, spec_mod.ServeSpec(
        backend={"plain": "plain", "cascade": "cascade"}.get(kind), **kw,
        **ours))
    jg = jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(
        backend={"plain": "xla", "cascade": "cascade"}.get(kind), **kw,
        **theirs))
    return gw, jg


def _run_prompt(g, gateway_module, tracer_module, arrivals):
    """Run ``g`` under a fresh fake clock; returns (telemetry, each
    request's generated tokens)."""
    tokens = {}
    step = g.batcher.step

    def traced():
        fin = step()
        for r in fin:
            tokens[r.uid] = list(r.generated)
        return fin
    g.batcher.step = traced
    p1, p2 = fake_clock(gateway_module, tracer_module)
    with p1, p2:
        tel = g.run(arrivals)
    return tel, tokens


_PAIR = None


@pytest.mark.parametrize("kind", ["plain", "cascade", "dense"])
def test_prompt_path_span_structure_matches_reference(kind):
    global _PAIR
    if _PAIR is None:
        _PAIR = smoke_pair()
    vocab = _PAIR[2].vocab
    gw, jg = _prompt_gateways(kind, obs, jobs)
    tel, toks = _run_prompt(gw, gw_mod, tracer_mod,
                            _prompt_load(gw_mod, vocab))
    jtel, jtoks = _run_prompt(jg, jgw, jtracer, _prompt_load(jgw, vocab))
    tr, jtr = gw.tracer, jg.tracer
    assert toks == jtoks and len(toks) == 6
    assert tel.dropped == jtel.dropped
    # every span (names, nesting, stamps, chunk args), instant and sample
    assert tr.events == jtr.events
    assert gw.metrics.samples == jg.metrics.samples
    assert gw.slo.report() == jg.slo.report()
    assert len(tr.spans("tick")) > 0
    if kind != "dense":
        assert [e for e in tr.events if e["name"] == "prefix_resume"]
        assert len(tr.spans("prefill_chunk")) == \
            gw.batcher.adapter.prefill_chunks_total
    tr.assert_nested()
    tr.assert_energy_conserved(tel)
    assert obs.stage_energy(tr, tel)["conserved"] is True
    # the same load untraced: the same tokens, ledger, pool counters and
    # captured keys, and no obs call
    bare, _ = _prompt_gateways(kind, None, None)
    c0 = obs.callback_count()
    btel, btoks = _run_prompt(bare, gw_mod, tracer_mod,
                              _prompt_load(gw_mod, vocab))
    assert obs.callback_count() == c0
    assert btoks == toks
    strip = ("t_arrival", "t_done", "t_dequeue", "t_admit")
    assert [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in strip} for r in btel.records] == \
        [{k: v for k, v in dataclasses.asdict(r).items()
          if k not in strip} for r in tel.records]
    assert btel.pool == tel.pool
    assert {k: f._cache_size() for k, f in bare.jit_fns().items()} == \
        {k: f._cache_size() for k, f in gw.jit_fns().items()}


def test_late_open_spans_match_reference():
    """A request whose life predates the tracer: the batcher opens its
    ``request`` and ``queue_wait`` spans late at admission, and
    ``record_prompt_completion`` closes it (or opens one late, at
    arrival, when none is open) with its energy parts, as the
    reference's do."""
    global _PAIR
    if _PAIR is None:
        _PAIR = smoke_pair()
    jcfg, jparams, cfg, params = _PAIR
    from repro.serve.gateway import slots as jslots
    from repro_torch.serve.gateway import slots
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, 9)
    events = []
    for o, mod, sl, ad in (
            (obs, gw_mod, slots, make_adapter(cfg, params, 2, 32, paged=True,
                                              block_size=BS)),
            (jobs, jgw, jslots, jslots.make_adapter(
                jcfg, jparams, 2, 32, paged=True, block_size=BS,
                backend="xla"))):
        tr, tel = o.Tracer(), mod.Telemetry()
        b = sl.ContinuousBatcher(ad)
        b.submit(sl.Request(uid=7, prompt=prompt.astype(np.int32),
                            max_new_tokens=3))
        b.tracer = ad.tracer = tr
        done = []
        while b.busy:
            done += b.step()
        req = done[0]
        mod.record_prompt_completion(tel, req, 1.0, 0.0, 0, 2.5, 4,
                                     tracer=tr)
        # a completion with no open span: the request span opens late
        req.uid = 8
        mod.record_prompt_completion(tel, req, 2.0, 0.5, 0, 2.5, 4,
                                     tracer=tr)
        tr.assert_nested()
        tr.assert_energy_conserved(tel)
        events.append(tr.events)
    assert events[0] == events[1]
    late = [e for e in events[0] if e["name"] == "request"]
    assert [e["args"].get("late_open") for e in late] == [True, True]
    assert [e["name"] for e in events[0] if e["tid"] == 7][:3] == \
        ["queue_wait", "prefill_chunk", "prefill_chunk"]
