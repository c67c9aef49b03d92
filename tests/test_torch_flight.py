"""The flight recorder (``repro_torch.serve.obs.flight``) and critical-path
attribution (``critpath``), held against the reference on the CPU.

The reference's behavioural tests (``tests/test_flight.py``: the seeded
reservoir, exact tails, the metrics sink, ring-only retention, zero
callbacks when nothing is attached, shrink, the float-equal segment
re-fold with nested carving, the p-tail ranking, per-role aggregation,
and live gateways feeding the ring) run on the port below.  Then the
parity tests: one seeded event stream through both packages' recorders
keeps the same spans, tails and accounting, shrinks alike, and re-folds
to the same critical paths and rankings."""
import numpy as np
import pytest

from repro.serve import obs as jobs
from repro_torch.serve import obs
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.gateway import GatewayConfig, PromptGateway
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, make_adapter
from repro_torch.serve.obs import critpath
from repro_torch.serve.obs.tracer import REQUESTS_PID
from test_torch_obs import MicroBatchGateway, _setup


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


def _span(name, ts, dur, *, tid=0, pid=REQUESTS_PID, args=None):
    return {"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args or {}}


def test_reservoir_is_seeded_deterministic_and_bounded():
    a = obs.FlightRecorder(span_cap=32, seed=7)
    b = obs.FlightRecorder(span_cap=32, seed=7)
    c = obs.FlightRecorder(span_cap=32, seed=8)
    events = [_span("decode", i * 1e-3, 1e-4, tid=i % 5)
              for i in range(2000)]
    for e in events:
        a(e), b(e), c(e)
    sa, sb, sc = a.snapshot(), b.snapshot(), c.snapshot()
    # same seed, same stream -> the exact same surviving spans, sorted
    assert sa["spans"] == sb["spans"] and len(sa["spans"]) == 32
    assert sa["spans"] != sc["spans"]          # different seed, different keep
    acct = sa["accounting"]
    assert acct["spans_seen"] == 2000 and acct["spans_kept"] == 32
    assert acct["spans_dropped"] == 1968
    # the reservoir is uniform over the run, not a tail: a plain tail would
    # only hold the last 32 events
    assert min(e["ts"] for e in sa["spans"]) < events[-32]["ts"]


def test_instants_and_counters_keep_exact_tail():
    fl = obs.FlightRecorder(instant_cap=4, counter_cap=3)
    for i in range(10):
        fl({"name": "drop", "ph": "i", "pid": 0, "tid": i, "ts": float(i),
            "args": {}})
        fl({"name": "queue", "ph": "C", "pid": 1, "tid": 0, "ts": float(i),
            "args": {"depth": i}})
    snap = fl.snapshot()
    assert [e["tid"] for e in snap["instants"]] == [6, 7, 8, 9]
    assert [e["args"]["depth"] for e in snap["counters"]] == [7, 8, 9]
    assert snap["accounting"]["instants_seen"] == 10
    assert snap["accounting"]["instants_kept"] == 4


def test_metrics_sink_feeds_sample_tail():
    fl = obs.FlightRecorder(sample_cap=2)
    m = obs.MetricsRegistry(interval_s=0.01, sink=fl.observe_sample)
    for i in range(5):
        m.observe("ttft", 1e-3)
        m.snapshot(i * 0.011)
    snap = fl.snapshot()
    assert snap["samples"] and len(snap["samples"]) <= 2
    assert snap["accounting"]["samples_seen"] >= len(snap["samples"])


def test_retain_false_makes_the_ring_the_only_retention():
    fl = obs.FlightRecorder()
    tr = obs.Tracer(retain=False, sink=fl)
    tr.begin("request", tid=3)
    tr.clock.advance(0.5)
    tr.end("request", tid=3)
    tr.instant("drop", tid=4)
    assert tr.events == []                     # always-on mode: no growth
    snap = fl.snapshot()
    assert [e["name"] for e in snap["spans"]] == ["request"]
    assert [e["name"] for e in snap["instants"]] == ["drop"]


def test_flight_disabled_run_charges_zero_callbacks():
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 4)),
                           fe.FrontendSpec(mode="sc", bits=4))
    gw.warmup()
    c0 = obs.callback_count()
    gw.run(_frame_arrivals(8))
    assert obs.callback_count() == c0
    fl = obs.FlightRecorder()
    gw.run(_frame_arrivals(8), flight=fl)
    assert obs.callback_count() > c0 and fl.spans_seen > 0


def test_shrink_halves_content_and_recomputes_accounting():
    fl = obs.FlightRecorder(span_cap=16, instant_cap=8)
    for i in range(40):
        fl(_span("decode", i * 1e-3, 1e-4))
        fl({"name": "drop", "ph": "i", "pid": 0, "tid": i, "ts": float(i),
            "args": {}})
    snap = fl.snapshot()
    half = obs.FlightRecorder.shrink(snap)
    assert len(half["spans"]) == 8 and len(half["instants"]) == 4
    acct = half["accounting"]
    assert acct["spans_seen"] == 40 and acct["spans_kept"] == 8
    assert acct["spans_dropped"] == 32         # recomputed, not stale
    # shrink bottoms out at one entry per non-empty stream, never zero
    for _ in range(10):
        half = obs.FlightRecorder.shrink(half)
    assert len(half["spans"]) == 1 and len(half["instants"]) == 1


def test_capacities_must_be_positive():
    with pytest.raises(ValueError):
        obs.FlightRecorder(span_cap=0)


def test_attribution_refolds_with_float_equality_and_carves_nesting():
    # awkward IEEE durations on purpose: 0.1 + 0.2 != 0.3 territory
    req = _span("request", 0.1, 0.7000000000000003, tid=9)
    children = [
        _span("queue_wait", 0.1, 0.10000000000000014, tid=9),
        _span("prefill", 0.2, 0.15000000000000002, tid=9),
        _span("decode", 0.4, 0.30000000000000004, tid=9),
        _span("migrate", 0.45, 0.1, tid=9),        # nested inside decode
        _span("prefill_chunk", 0.21, 0.01, tid=9),  # stays inside prefill
    ]
    cps = critpath.analyze([req] + children)
    assert len(cps) == 1
    cp = cps[0]
    assert critpath.verify(cp)                 # bitwise, not approx
    assert critpath.fold([d for _, d in cp["segments"]]) == req["dur"]
    # the migrate span was carved out of its decode parent, charged once
    assert cp["by_stage"]["migrate"] == pytest.approx(0.1)
    assert cp["by_stage"]["decode"] == \
        pytest.approx(0.30000000000000004 - 0.1)
    assert "prefill_chunk" not in cp["by_stage"]
    assert cp["segments"][-1][0] == "unattributed"
    assert cp["dominant"] == "decode"


def test_aggregate_ranks_stages_and_p_tail():
    fast = [critpath.attribute_request(
        _span("request", i * 1.0, 0.01, tid=i),
        [_span("queue_wait", i * 1.0, 0.008, tid=i)]) for i in range(9)]
    slow = [critpath.attribute_request(
        _span("request", 100.0, 1.0, tid=99),
        [_span("decode", 100.0, 0.9, tid=99)])]
    agg = critpath.aggregate(fast + slow, p=0.9)
    assert agg["exact"] and agg["requests"] == 10
    assert agg["ranking"][0] == "decode"       # 0.9s beats 9 * 8ms
    # the slow request IS the tail: fixing decode moves the p-quantile
    assert agg["p_dominant"] == "decode" and agg["p_dur"] == 1.0
    assert agg["stages"]["queue_wait"]["requests_dominated"] == 9
    shares = sum(rec["share"] for rec in agg["stages"].values())
    assert shares == pytest.approx(1.0)


def test_aggregate_by_role_maps_stages_to_tiers():
    cp = critpath.attribute_request(
        _span("request", 0.0, 1.0, tid=0),
        [_span("queue_wait", 0.0, 0.2, tid=0),
         _span("prefill", 0.2, 0.3, tid=0),
         _span("handoff", 0.5, 0.1, tid=0),
         _span("decode", 0.6, 0.3, tid=0)])
    agg = critpath.aggregate([cp], roles=True)
    roles = agg["by_role"]
    assert roles["prefill"]["stages"] == ["prefill", "queue_wait"]
    assert roles["boundary"]["stages"] == ["handoff"]
    assert roles["decode"]["total_s"] == pytest.approx(0.3)
    assert sum(r["share"] for r in roles.values()) == pytest.approx(1.0)


def test_empty_and_childless_requests_stay_exact():
    assert critpath.aggregate([])["requests"] == 0
    cp = critpath.attribute_request(_span("request", 0.0, 0.25, tid=1), [])
    assert critpath.verify(cp)
    assert cp["segments"] == [("unattributed", 0.25)]
    assert cp["dominant"] == "unattributed"


def test_prompt_gateway_flight_ring_supports_exact_critpath():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=32, paged=True,
                      block_size=4)
    fl = obs.FlightRecorder(seed=3)
    m = obs.MetricsRegistry(interval_s=0.005)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=4,
                       flight=fl, metrics=m)
    tel = gw.run(_prompt_arrivals(cfg, 5))
    assert len(tel.records) == 5
    snap = fl.snapshot()
    assert snap["spans"] and snap["samples"]   # ring + metrics both fed
    cps = critpath.analyze(snap["spans"])
    agg = critpath.aggregate(cps)
    assert agg["requests"] >= 1 and agg["exact"]
    # package-level aliases resolve to the same functions
    assert obs.analyze_critical_paths is critpath.analyze
    assert obs.aggregate_critical_paths is critpath.aggregate


def test_frame_gateway_traced_run_attributes_every_request():
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 4)),
                           fe.FrontendSpec(mode="sc", bits=4))
    gw.warmup()
    tr = obs.Tracer()
    tel = gw.run(_frame_arrivals(12), tracer=tr)
    agg = critpath.aggregate(critpath.analyze(tr.events))
    assert agg["requests"] == len(tel.records) and agg["exact"]
    assert set(agg["ranking"]) <= set(critpath.STAGES)



# ==========================================================================
# Parity with the reference.
# ==========================================================================

def _stream(o, seed: int):
    """A seeded stream of nested request spans, engine ticks, instants,
    counters and metric samples through package ``o``'s tracer into a
    small recorder (the reservoir overflows)."""
    fl = o.FlightRecorder(span_cap=48, instant_cap=16, counter_cap=8,
                          sample_cap=8, seed=seed)
    tr = o.Tracer(sink=fl)
    m = o.MetricsRegistry(interval_s=0.01, sink=fl.observe_sample)
    rng = np.random.default_rng(seed)
    t = 0.0
    for uid in range(60):
        t0 = t
        tr.begin("request", tid=uid, t=t0)
        for stage in ("queue_wait", "prefill", "decode"):
            d = float(rng.exponential(0.002))
            tr.begin(stage, tid=uid, t=t)
            if stage == "decode" and rng.random() < 0.3:
                tr.begin("migrate", tid=uid, t=t + d / 4)
                tr.end("migrate", tid=uid, t=t + d / 2)
            t += d
            tr.end(stage, tid=uid, t=t)
        tr.end("request", tid=uid, t=t)
        tr.begin("tick", pid=o.ENGINE_PID, tid=0, t=t0)
        tr.end("tick", pid=o.ENGINE_PID, tid=0, t=t)
        if rng.random() < 0.4:
            tr.instant("drop", tid=uid, t=t, args={"reason": "queue_full"})
        tr.counter("load", {"q": int(rng.integers(10))}, t=t)
        m.inc("done")
        m.maybe_sample(t)
    return fl, tr


@pytest.mark.parametrize("seed", [0, 11])
def test_ring_and_critical_paths_match_reference(seed):
    fl, tr = _stream(obs, seed)
    jfl, jtr = _stream(jobs, seed)
    snap, jsnap = fl.snapshot(), jfl.snapshot()
    assert snap == jsnap                 # the same kept sets, seeded
    assert snap["accounting"]["spans_dropped"] > 0
    assert obs.FlightRecorder.shrink(snap) == \
        jobs.FlightRecorder.shrink(jsnap)
    for events in (tr.events, snap["spans"]):
        cps = critpath.analyze(events)
        assert cps == jobs.critpath.analyze(events)
        assert all(critpath.verify(cp) for cp in cps)
        for roles in (False, True):
            assert critpath.aggregate(cps, roles=roles) == \
                jobs.critpath.aggregate(cps, roles=roles)
