"""The SLO engine (``repro_torch.serve.obs.slo``), capped histograms and the
exporters, held against the reference on the CPU.

The reference's behavioural tests (``tests/test_slo.py``: burn-rate math,
half-open windows, the two-window gate, the ok -> warn -> critical state
machine, pressure events, the forced overload on the frame gateway,
backpressure at the prompt gateway's door, zero callbacks when nothing is
attached, capped reservoirs, trace bounds, span streams, OpenMetrics) run
on the port below.  Then the parity tests: one seeded observation stream
through both packages' ``SLOMonitor`` (burn rates, transitions, pressure
events, reports, instants and gauges equal), the same registry and
monitor rendered as byte-equal OpenMetrics text, and both prompt
gateways shedding under a forced critical burn with equal admission
bounds and drops."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import obs as jobs
from repro.serve import spec as jspec
from repro.serve.gateway import gateway as jgw
from repro.serve.obs import tracer as jtracer
from repro_torch.serve import obs
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway import gateway as gw_mod
from repro_torch.serve.gateway.gateway import (GatewayConfig, PromptGateway,
                                               drive_prompt_loop)
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, make_adapter
from repro_torch.serve.gateway.telemetry import Telemetry
from repro_torch.serve.obs import tracer as tracer_mod
from test_torch_lm import smoke_pair
from test_torch_obs import MicroBatchGateway, _setup, fake_clock

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4


def _prompt_arrivals(cfg, n, plen=8, seed=0, dt=0.001):
    rng = np.random.default_rng(seed)
    return [Arrival(t=i * dt, uid=i, endpoint=0, kind="prompt",
                    payload=rng.integers(0, cfg.vocab, plen)
                    .astype(np.int32)) for i in range(n)]


def _frame_arrivals(n, dt=0.001, seed=0):
    rng = np.random.default_rng(seed)
    return [Arrival(t=i * dt, uid=i, endpoint=0, kind="frame",
                    payload=rng.integers(0, 255, (28, 28, 1))
                    .astype(np.uint8)) for i in range(n)]


def _policy(objective="ttft", target=0.01, budget=0.01,
            warn_thr=2.0, crit_thr=8.0, long_s=0.05, short_s=0.01):
    """Two-tier ladder over one latency objective + drop_rate, same window
    pair for both tiers so severity order is purely the threshold order."""
    return obs.SLOPolicy(
        objectives=(obs.SLObjective(objective, target=target, budget=budget),
                    obs.SLObjective("drop_rate", budget=budget)),
        windows=(obs.BurnWindow(long_s, short_s, crit_thr, "critical"),
                 obs.BurnWindow(long_s, short_s, warn_thr, "warn")))


def test_burn_rate_is_bad_fraction_over_budget():
    mon = obs.SLOMonitor(_policy(budget=0.1, long_s=1.0))
    # 10 events in (0, 1]: 3 violations -> bad fraction 0.3, burn 3.0
    for i in range(10):
        mon.observe("ttft", 0.1 * (i + 1), 0.02 if i < 3 else 0.001)
    assert mon.burn_rate("ttft", 1.0, 1.0) == pytest.approx(3.0)
    # a shorter window sees only the good tail
    assert mon.burn_rate("ttft", 0.65, 1.0) == 0.0
    # no events in window / unknown objective -> 0, never a crash
    assert mon.burn_rate("ttft", 0.1, 99.0) == 0.0
    assert mon.burn_rate("nope", 1.0, 1.0) == 0.0


def test_burn_rate_window_is_half_open_and_horizon_bounded():
    mon = obs.SLOMonitor(_policy(budget=1.0, long_s=1.0, short_s=0.2))
    mon.observe("ttft", 0.0, 1.0)       # bad, exactly at t - window
    mon.observe("ttft", 0.5, 1.0)       # bad, inside
    # window (0, 1]: the event at exactly t - window is excluded
    assert mon.burn_rate("ttft", 1.0, 1.0) == pytest.approx(1.0)
    # events older than the policy horizon are evicted from the deque
    for t in np.linspace(5.0, 6.0, 20):
        mon.observe("ttft", float(t), 0.001)
    assert all(ts >= 5.0 for ts, _ in mon._events["ttft"])


def test_observe_ignores_unknown_objective():
    mon = obs.SLOMonitor(_policy())
    mon.observe("tpot", 0.1, 99.0)      # not in this policy
    mon.observe_event("tpot", 0.1, True)
    assert mon.evaluate(0.2) == "ok"


def test_default_policy_scales_sre_windows():
    pol = obs.SLOPolicy.default(period_s=30 * 24 * 3600.0, ttft_s=0.1)
    # at the SRE period the canonical pairs come back in hours
    assert pol.windows[0].long_s == pytest.approx(3600.0)
    assert pol.windows[0].short_s == pytest.approx(300.0)
    assert pol.windows[0].threshold == 14.4
    assert {o.name for o in pol.objectives} == {"ttft", "drop_rate"}
    small = obs.SLOPolicy.default(period_s=60.0, ttft_s=0.1)
    assert small.windows[0].long_s == pytest.approx(3600.0 / 43200)
    with pytest.raises(AssertionError):
        obs.SLOPolicy.default(period_s=1.0, drop_budget=None)  # no objectives


def test_policy_rejects_duplicate_objectives_and_bad_windows():
    with pytest.raises(AssertionError):
        obs.SLOPolicy(objectives=(obs.SLObjective("ttft", 0.1),
                                  obs.SLObjective("ttft", 0.2)),
                      windows=(obs.BurnWindow(1.0, 0.1, 2.0, "warn"),))
    with pytest.raises(AssertionError):
        obs.BurnWindow(0.1, 1.0, 2.0, "warn")       # short > long
    with pytest.raises(AssertionError):
        obs.BurnWindow(1.0, 0.1, 2.0, "fatal")      # unknown severity
    with pytest.raises(AssertionError):
        obs.SLObjective("ttft", budget=0.0)         # zero budget


def test_alert_requires_both_windows_to_burn():
    pol = obs.SLOPolicy(
        objectives=(obs.SLObjective("ttft", target=0.01, budget=0.4),),
        windows=(obs.BurnWindow(1.0, 0.2, 1.5, "critical"),))
    mon = obs.SLOMonitor(pol)
    # long window burns (8 bad of 12), but the short window is all good:
    # the incident is over — no alert, no flapping
    for i in range(8):
        mon.observe("ttft", 0.1 * (i + 1), 1.0)
    for t in (0.85, 0.9, 0.95, 1.0):
        mon.observe("ttft", t, 0.001)
    assert mon.burn_rate("ttft", 1.0, 1.0) > 1.5
    assert mon.burn_rate("ttft", 0.2, 1.0) == 0.0
    assert mon.evaluate(1.0) == "ok"
    # make the short window burn too -> now it trips
    for t in (1.05, 1.1, 1.15):
        mon.observe("ttft", t, 1.0)
    assert mon.evaluate(1.15) == "critical"


def test_state_machine_walks_ok_warn_critical_and_recovers():
    mon = obs.SLOMonitor(_policy(budget=0.5, warn_thr=0.8, crit_thr=1.2,
                                 long_s=1.0, short_s=0.2))
    # ramp the violation fraction phase by phase (bad events at each
    # phase's tail so the short window sees them): burn crosses the warn
    # threshold before the critical one
    t = 0.0
    states = []
    for frac in (0.0, 0.25, 0.5, 1.0):
        for i in range(20):
            t += 0.05
            bad = i >= 20 * (1 - frac)
            mon.observe("ttft", t, 0.02 if bad else 0.001)
        states.append(mon.evaluate(t))
    assert states == ["ok", "ok", "warn", "critical"]
    # recovery: a quiet stretch drains both windows back to ok
    for _ in range(40):
        t += 0.05
        mon.observe("ttft", t, 0.001)
    states.append(mon.evaluate(t))
    assert states[-1] == "ok"
    assert [(a, b) for _, a, b, _ in mon.transitions] == \
        [("ok", "warn"), ("warn", "critical"), ("critical", "ok")]
    # transition log and report agree
    rep = mon.report()
    assert rep["state"] == "ok"
    assert [tr["to"] for tr in rep["transitions"]] == \
        ["warn", "critical", "ok"]
    assert rep["objectives"]["ttft"]["bad"] == 35


def test_transitions_emit_trace_instants_and_metric_gauges():
    tr, m = obs.Tracer(), obs.MetricsRegistry(interval_s=0.01)
    mon = obs.SLOMonitor(_policy(budget=0.5, warn_thr=0.4, crit_thr=1.2,
                                 long_s=1.0, short_s=0.2),
                         tracer=tr, metrics=m)
    t = 0.0
    for i in range(40):
        t += 0.05
        mon.observe("ttft", t, 0.02 if i >= 20 else 0.001)
        mon.evaluate(t)
        m.maybe_sample(t)
    inst = [e for e in tr.events if e["name"] == "slo_transition"]
    assert len(inst) == len(mon.transitions) >= 1
    assert inst[0]["args"]["from"] == "ok"
    assert inst[0]["args"]["to"] == "warn"
    assert inst[0]["args"]["objective"] == "ttft"
    assert "burn_ttft" in inst[0]["args"]
    # burn + state gauges landed as series columns
    ts, vs = m.series("burn_ttft")
    assert len(vs) > 0 and max(vs) > 0.4
    _, states = m.series("slo_state")
    assert max(states) >= 1


def test_pressure_signal_subscribe_fire_unsubscribe():
    sig = obs.PressureSignal()
    got = []
    fn = got.append
    sig.subscribe(fn)
    ev = obs.PressureEvent(t=1.0, prev="ok", state="warn", worst="ttft",
                           burns={"ttft": 3.0})
    sig.fire(ev)
    assert got == [ev] and sig.last is ev and len(sig.events) == 1
    sig.unsubscribe(fn)
    sig.fire(dataclasses.replace(ev, t=2.0, state="critical"))
    assert len(got) == 1 and len(sig.events) == 2
    assert sig.last.state == "critical"


def test_pressure_fires_on_every_transition_with_worst_objective():
    mon = obs.SLOMonitor(_policy(budget=0.5, warn_thr=0.4, crit_thr=1.2,
                                 long_s=1.0, short_s=0.2))
    seen = []
    mon.pressure.subscribe(lambda e: seen.append((e.prev, e.state, e.worst)))
    t = 0.0
    for frac in (0.5, 1.0):
        for i in range(20):
            t += 0.05
            bad = i >= 20 * (1 - frac)
            mon.observe("ttft", t, 0.02 if bad else 0.001)
        mon.evaluate(t)
    assert seen == [("ok", "warn", "ttft"), ("warn", "critical", "ttft")]


def test_forced_overload_pressure_fires_before_first_drop():
    spec = fe.FrontendSpec(mode="sc", bits=4)
    # service 2x slower than arrivals: queue wait ramps ~1ms per frame, so
    # the burn engine sees the degradation long before the queue bound
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1,), max_queue=16,
                                         max_delay_s=0.0005,
                                         service_model="fixed",
                                         fixed_service_s=0.002), spec)
    gw.warmup()
    pol = _policy("queue_wait", target=0.006, budget=0.05,
                  warn_thr=2.0, crit_thr=8.0, long_s=0.05, short_s=0.01)
    tr, m = obs.Tracer(), obs.MetricsRegistry(interval_s=0.005)
    mon = obs.SLOMonitor(pol, tracer=tr, metrics=m)
    tel = gw.run(_frame_arrivals(60), tracer=tr, metrics=m, slo=mon)

    assert [(a, b) for _, a, b, _ in mon.transitions] == \
        [("ok", "warn"), ("warn", "critical")]
    drops = tel.dropped
    assert drops, "overload must eventually hit the queue bound"
    # the whole point of the signal: pressure fired while dropping was
    # still avoidable
    assert mon.pressure.events[0].t < drops[0][3]
    assert mon.pressure.events[0].state == "warn"
    # burn series columns rode into the metrics snapshots
    ts, vs = m.series("burn_queue_wait")
    assert len(vs) > 3 and max(vs) >= 8.0
    # drop_rate burn observed every rejection too
    assert mon.report()["objectives"]["drop_rate"]["bad"] == len(drops)
    # the instrumented overload run still keeps every integrity pin
    tel.assert_conserved()
    tr.assert_nested()
    tr.assert_energy_conserved(tel)


def test_prompt_gateway_backpressure_shrinks_admission_bound():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    mon = obs.SLOMonitor(_policy())
    gw = PromptGateway(ContinuousBatcher(ad), max_queue=64, slo=mon,
                       shed_factor=4)
    assert gw._admit_bound() == 64
    mon.pressure.fire(obs.PressureEvent(0.1, "ok", "critical", "ttft", {}))
    assert gw._shedding and gw._admit_bound() == 16
    # recovery restores the configured bound
    mon.pressure.fire(obs.PressureEvent(0.2, "critical", "ok", None, {}))
    assert not gw._shedding and gw._admit_bound() == 64
    # the bound never collapses to zero, however aggressive the factor
    gw2 = PromptGateway(ContinuousBatcher(ad), max_queue=8,
                        slo=obs.SLOMonitor(_policy()), shed_factor=1000)
    gw2._on_pressure(obs.PressureEvent(0.1, "ok", "critical", "ttft", {}))
    assert gw2._admit_bound() == 1


def test_drive_loop_sheds_at_admission_under_critical_burn():
    # deterministic fake engine: one batch in service per tick, every
    # completion violates its queue-wait target, so the monitor goes
    # critical after the first completion and the (callable) admission
    # bound collapses — every later arrival is shed at the door
    mon = obs.SLOMonitor(_policy("queue_wait", target=0.001, budget=0.5,
                                 warn_thr=0.1, crit_thr=0.2,
                                 long_s=10.0, short_s=10.0))
    shed = {"on": False}
    mon.pressure.subscribe(
        lambda e: shed.update(on=(e.state == "critical")))
    tel = Telemetry()
    queue: list = []

    def step():
        done, queue[:] = list(queue), []
        return done

    drive_prompt_loop(
        _frame_arrivals(30), tel,
        busy=lambda: bool(queue),
        queue_depth=lambda: len(queue),
        max_queue=lambda: 0 if shed["on"] else 100,
        submit=queue.append,
        step=step,
        record=lambda a, now: mon.observe("queue_wait", now, 1.0),
        slo=mon)

    assert mon.state == "critical"
    t_crit, _, to, worst = mon.transitions[0]
    assert to == "critical" and worst == "queue_wait"
    # first arrival served; all 29 later ones shed by the pressure hook
    # (the nominal bound of 100 was never the limit)
    assert len(tel.dropped) == 29
    assert all(t > t_crit for _, _, _, t in tel.dropped)
    assert all(reason == "queue_full" for _, _, reason, _ in tel.dropped)
    assert mon.report()["objectives"]["drop_rate"]["bad"] == 29


def test_disabled_slo_makes_zero_obs_callbacks():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=16, paged=True,
                      block_size=BS)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=3)
    gw.warmup((8,))
    spec = fe.FrontendSpec(mode="sc", bits=4)
    fgw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 2),
                                          service_model="fixed",
                                          fixed_service_s=0.001), spec)
    fgw.warmup()
    c0 = obs.callback_count()
    gw.run(_prompt_arrivals(cfg, 4))
    fgw.run(_frame_arrivals(6))
    assert obs.callback_count() == c0


def test_slo_entry_points_charge_the_callback_counter():
    mon = obs.SLOMonitor(_policy())
    c0 = obs.callback_count()
    mon.observe("ttft", 0.1, 0.001)
    mon.observe_event("drop_rate", 0.1, False)
    mon.evaluate(0.2)
    mon.pressure.subscribe(lambda e: None)
    mon.report()
    assert obs.callback_count() > c0


def test_hist_under_cap_is_exact_with_zero_dropped():
    m = obs.MetricsRegistry(hist_cap=64)
    vals = list(np.random.default_rng(1).normal(size=64))
    for v in vals:
        m.observe("lat", v)
    assert sorted(m.hists["lat"]) == sorted(float(v) for v in vals)
    p = m.percentiles("lat")
    assert p["n"] == 64 and p["n_dropped"] == 0
    assert p["p50"] == pytest.approx(float(np.percentile(vals, 50)))


def test_hist_over_cap_bounds_memory_and_reports_dropped():
    m = obs.MetricsRegistry(hist_cap=100)
    for i in range(10_000):
        m.observe("lat", float(i))
    assert len(m.hists["lat"]) == 100            # bounded retention
    assert m.hist_dropped("lat") == 9_900        # explicit, not silent
    p = m.percentiles("lat")
    assert p["n"] == 10_000 and p["n_dropped"] == 9_900
    # the reservoir is a uniform sample over the whole stream: its median
    # estimates the stream median, not the tail of whatever arrived last
    assert 2_000 < p["p50"] < 8_000
    assert all(0 <= v < 10_000 for v in m.hists["lat"])


def test_hist_reservoir_is_deterministic_per_seed():
    def fill(seed):
        m = obs.MetricsRegistry(hist_cap=32, seed=seed)
        for i in range(1000):
            m.observe("x", float(i))
        return m.hists["x"]
    assert fill(7) == fill(7)
    assert fill(7) != fill(8)


def _small_trace():
    tr = obs.Tracer()
    for i in range(10):
        tr.clock.advance(float(i))
        tr.begin("work", tid=i)
        tr.clock.advance(i + 0.5)
        tr.end("work", tid=i)
    return tr


def test_chrome_trace_max_events_marks_truncation(tmp_path):
    tr = _small_trace()
    full = obs.chrome_trace(tr)
    cut = obs.chrome_trace(tr, max_events=4)
    names = [e["name"] for e in cut["traceEvents"]]
    assert names.count("work") == 4
    marker = next(e for e in cut["traceEvents"]
                  if e["name"] == "trace_truncated")
    assert marker["args"] == {"dropped_events": 6, "max_events": 4}
    assert obs.validate_chrome_trace(cut) == []
    # no cap -> every event, no marker
    full_names = [e["name"] for e in full["traceEvents"]]
    assert full_names.count("work") == 10
    assert "trace_truncated" not in full_names
    obs.write_chrome_trace(str(tmp_path / "t.json"), tr, max_events=4)


def test_span_stream_writer_streams_every_event(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    with obs.SpanStreamWriter(path) as sink:
        tr = obs.Tracer(sink=sink)
        for i in range(5):
            tr.clock.advance(float(i))
            tr.begin("work", tid=i)
            tr.instant("mark", tid=i)
            tr.clock.advance(i + 0.5)
            tr.end("work", tid=i)
        assert sink.n_written == len(tr.events) == 10
    back = obs.read_span_stream(path)
    assert back == tr.events             # lossless, in record order


def test_span_stream_writer_validates_at_write_time(tmp_path):
    sink = obs.SpanStreamWriter(str(tmp_path / "bad.jsonl"))
    with pytest.raises(AssertionError, match="invalid event"):
        sink({"name": "x", "ph": "Z", "pid": 0, "tid": 0, "ts": 0.0})


def test_openmetrics_round_trip_is_valid(tmp_path):
    m = obs.MetricsRegistry(hist_cap=8)
    m.inc("frames_completed", 5)
    m.set_gauge("queue_depth", 3)
    m.register("pool_blocks", lambda: 17)
    for v in range(20):
        m.observe("ttft_s", v * 0.001)
    mon = obs.SLOMonitor(_policy())
    mon.observe("ttft", 0.1, 0.001)
    mon.evaluate(0.1)
    text = obs.write_openmetrics(str(tmp_path / "m.txt"), m, mon)
    assert obs.validate_openmetrics(text) == []
    assert text.endswith("# EOF\n")
    assert "repro_frames_completed_total 5.0" in text
    assert "repro_queue_depth 3.0" in text
    assert "repro_pool_blocks 17.0" in text          # pulled at scrape time
    assert 'repro_ttft_s{quantile="0.5"}' in text
    assert "repro_ttft_s_count 20.0" in text
    assert "repro_ttft_s_dropped_total 12.0" in text  # cap surfaced
    assert "repro_slo_state 0.0" in text
    assert "repro_burn_ttft" in text


def test_openmetrics_validator_rejects_malformed():
    assert obs.validate_openmetrics("foo 1\n# EOF\n")       # no TYPE family
    assert obs.validate_openmetrics("# TYPE a gauge\na 1\n")  # no EOF
    assert obs.validate_openmetrics(
        "# TYPE a counter\na 1\n# EOF\n")               # counter w/o _total
    assert obs.validate_openmetrics(
        "# TYPE a gauge\n# TYPE a gauge\na 1\n# EOF\n")  # duplicate family
    assert obs.validate_openmetrics(
        "# TYPE a gauge\na one\n# EOF\n")               # non-numeric value
    assert obs.validate_openmetrics(42) == ["exposition is not a string"]



# ==========================================================================
# Parity with the reference.
# ==========================================================================

def _monitor_run(o, seed: int):
    """One seeded stream of TTFT, queue-wait and admission observations,
    evaluated every tenth event, through package ``o``'s monitor with a
    tracer and metrics attached."""
    pol = o.SLOPolicy(
        objectives=(o.SLObjective("ttft", target=0.01, budget=0.1),
                    o.SLObjective("queue_wait", target=0.005, budget=0.2),
                    o.SLObjective("drop_rate", budget=0.05)),
        windows=(o.BurnWindow(0.5, 0.1, 4.0, "critical"),
                 o.BurnWindow(1.0, 0.2, 1.5, "warn")))
    tr, m = o.Tracer(), o.MetricsRegistry(interval_s=0.02, hist_cap=16,
                                          seed=seed)
    mon = o.SLOMonitor(pol, tracer=tr, metrics=m)
    rng = np.random.default_rng(seed)
    t, burns = 0.0, []
    for i in range(600):
        t += float(rng.exponential(0.005))
        phase = (i // 150) % 2           # calm, then degraded, then calm
        mon.observe("ttft", t, float(rng.exponential(0.004 + 0.02 * phase)))
        mon.observe("queue_wait", t, float(rng.exponential(0.003)))
        mon.observe_event("drop_rate", t, bool(rng.random() < 0.1 * phase))
        m.observe("ttft_s", float(rng.random()))
        if i % 10 == 9:
            mon.evaluate(t)
            m.maybe_sample(t)
            burns.append([mon.burn_rate(n, w, t) for n in
                          ("ttft", "queue_wait", "drop_rate")
                          for w in (0.1, 0.5, 1.0)])
    return mon, tr, m, burns


@pytest.mark.parametrize("seed", [0, 3])
def test_monitor_matches_reference(seed):
    mon, tr, m, burns = _monitor_run(obs, seed)
    jmon, jtr, jm, jburns = _monitor_run(jobs, seed)
    assert burns == jburns
    assert mon.transitions == jmon.transitions
    assert {to for _, _, to, _ in mon.transitions} == {"warn", "critical",
                                                       "ok"}
    assert [dataclasses.asdict(e) for e in mon.pressure.events] == \
        [dataclasses.asdict(e) for e in jmon.pressure.events]
    assert mon.report() == jmon.report()
    assert tr.events == jtr.events
    assert m.samples == jm.samples
    assert m.hists == jm.hists          # the same seeded reservoir
    assert m.percentiles("ttft_s") == jm.percentiles("ttft_s")


def test_openmetrics_text_is_the_reference_bytes():
    mon, _, m, _ = _monitor_run(obs, 1)
    jmon, _, jm, _ = _monitor_run(jobs, 1)
    m.register("pool_blocks", lambda: 17)
    jm.register("pool_blocks", lambda: 17)
    text = obs.openmetrics_text(m, mon)
    assert text == jobs.openmetrics_text(jm, jmon)
    assert obs.validate_openmetrics(text) == []
    assert obs.openmetrics_text(m, mon, prefix="edge") == \
        jobs.openmetrics_text(jm, jmon, prefix="edge")


def _shed_gateway(make, ServeSpec, o, cfg, params, **kw):
    """A chunked paged gateway whose monitor goes critical on the first
    completion: every completion misses a 1 us queue-wait target."""
    mon = o.SLOMonitor(o.SLOPolicy(
        objectives=(o.SLObjective("queue_wait", target=1e-6, budget=0.5),
                    o.SLObjective("drop_rate", budget=0.5)),
        windows=(o.BurnWindow(10.0, 10.0, 0.2, "critical"),
                 o.BurnWindow(10.0, 10.0, 0.1, "warn"))))
    return make(cfg, params, ServeSpec(
        n_slots=2, max_len=32, paged=True, block_size=BS, max_new_tokens=3,
        max_queue=12, shed_factor=4, slo=mon, **kw))


def _burst(mod, vocab):
    rng = np.random.default_rng(5)
    return [mod.Arrival(t=0.004 * (i // 8), uid=i, endpoint=0,
                        kind="prompt",
                        payload=rng.integers(0, vocab, 6).astype(np.int32))
            for i in range(40)]


def test_shedding_under_critical_burn_matches_reference():
    jcfg, jparams, cfg, params = smoke_pair()
    gw = _shed_gateway(lambda *a: spec_mod.make_gateway(*a, device="cpu"),
                       spec_mod.ServeSpec, obs, cfg, params, backend="plain")
    jg = _shed_gateway(jspec.make_gateway, jspec.ServeSpec, jobs, jcfg,
                       jparams, backend="xla")
    bounds = {}
    for g, tag in ((gw, "port"), (jg, "ref")):
        g.slo.pressure.subscribe(
            lambda e, g=g, tag=tag: bounds.setdefault(tag, []).append(
                (e.state, g._admit_bound())))
    p1, p2 = fake_clock(gw_mod, tracer_mod)
    with p1, p2:
        tel = gw.run(_burst(gw_mod, cfg.vocab))
    p1, p2 = fake_clock(jgw, jtracer)
    with p1, p2:
        jtel = jg.run(_burst(jgw, cfg.vocab))
    assert bounds["port"] == bounds["ref"]
    assert ("critical", 3) in bounds["port"]      # 12 // shed_factor 4
    assert gw._shedding == jg._shedding
    assert tel.dropped == jtel.dropped
    assert len(tel.dropped) > 0
    assert [r.uid for r in tel.records] == [r.uid for r in jtel.records]
    assert gw.slo.report() == jg.slo.report()
