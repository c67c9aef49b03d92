"""Incident forensics (``repro_torch.serve.obs.incident``), held against the
reference on the CPU.

The reference's behavioural tests (``tests/test_incident.py``: the SLO
capture landing before the first shed drop, cooldowns, drop bursts,
recompile leaks (here over the port's captured steps), energy mismatches,
explicit captures, ``ServeSpec(flight=True, incident_dir=...)``, the size
bound shrinking the ring until the bundle fits, refusal of invalid and
truncated bundles, and the CLI's inspect, diff and critpath commands)
run on the port below.  Then the parity tests: the prompt gateway's
explicit capture after the same load equals the reference's bundle field
for field (captured keys per step aside: the port captures only the
ticks, and the port's ``"plain"`` backend is the reference's ``"xla"``), and
the CLI runs as ``python -m repro_torch.serve.obs.incident``."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.serve import obs as jobs
from repro.serve import spec as jspec
from repro.serve.gateway import gateway as jgw
from repro.serve.obs import tracer as jtracer
from repro_torch.serve import capture, obs
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway import gateway as gw_mod
from repro_torch.serve.gateway.gateway import GatewayConfig, PromptGateway
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import ContinuousBatcher, make_adapter
from repro_torch.serve.obs import incident as inc_mod
from repro_torch.serve.obs import tracer as tracer_mod
from repro_torch.serve.spec import ServeSpec
from test_torch_lm import smoke_pair
from test_torch_obs import (MicroBatchGateway, _setup, fake_clock,
                            make_gateway)


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


def _policy(target=0.006):
    return obs.SLOPolicy(
        objectives=(obs.SLObjective("queue_wait", target=target,
                                    budget=0.05),
                    obs.SLObjective("drop_rate", budget=0.05)),
        windows=(obs.BurnWindow(0.05, 0.01, 8.0, "critical"),
                 obs.BurnWindow(0.05, 0.01, 2.0, "warn")))


def test_slo_critical_capture_lands_before_first_shed_drop(tmp_path):
    """The whole point of auto-capture: the bundle is written while
    dropping is still avoidable, so the forensic record shows the system
    *entering* distress — the flight ring inside the bundle must contain
    no drop instants yet."""
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1,), max_queue=16,
                                         max_delay_s=0.0005,
                                         service_model="fixed",
                                         fixed_service_s=0.002),
                           fe.FrontendSpec(mode="sc", bits=4))
    gw.warmup()
    fl = obs.FlightRecorder()
    mon = obs.SLOMonitor(_policy(), metrics=obs.MetricsRegistry(
        interval_s=0.005))
    inc = obs.IncidentCapture(str(tmp_path), flight=fl, slo=mon)
    tel = gw.run(_frame_arrivals(60), slo=mon, flight=fl, incident=inc)
    assert tel.dropped, "overload must eventually hit the queue bound"
    assert inc.captures and inc.captures[0]["reason"] == "slo_critical"
    first_drop_t = tel.dropped[0][3]
    assert inc.captures[0]["t"] < first_drop_t
    bundle = obs.load_incident_bundle(inc.captures[0]["path"])
    assert bundle["trigger_detail"]["from"] == "warn"
    assert not [e for e in bundle["flight"]["instants"]
                if e["name"] == "drop"]
    assert bundle["slo"]["state"] == "critical"
    assert bundle["state"]["kind"] == "frame_gateway"
    assert "jit_cache_sizes" in bundle["state"]


def test_cooldown_suppresses_back_to_back_auto_captures(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), drop_burst=2,
                              drop_window_s=1.0, cooldown_s=10.0)
    for t in (0.1, 0.2, 0.3, 0.4):
        inc.observe_drop(t)
    assert len(inc.captures) == 1              # burst fired once, then held
    # explicit captures bypass the cooldown
    inc.capture("operator_probe", t=0.5)
    assert [c["reason"] for c in inc.captures] == \
        ["drop_burst", "operator_probe"]


def test_drop_burst_needs_a_dense_window(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), drop_burst=4,
                              drop_window_s=0.1, cooldown_s=0.0)
    for i in range(8):                         # sparse: one drop per 0.2s
        inc.observe_drop(i * 0.2)
    assert not inc.captures
    for i in range(4):                         # dense burst inside 0.1s
        inc.observe_drop(2.0 + i * 0.01)
    assert len(inc.captures) == 1
    b = obs.load_incident_bundle(inc.captures[0]["path"])
    assert b["reason"] == "drop_burst"
    assert b["trigger_detail"]["drops_in_window"] == 4


def test_unarmed_detector_never_trips(tmp_path):
    det = obs.RecompileDetector()              # no snapshot taken
    inc = obs.IncidentCapture(str(tmp_path), detector=det)
    inc.poll(0.1)
    assert not inc.captures


class _Ledger:
    def __init__(self, ok):
        self.ok = ok

    def assert_conserved(self):
        assert self.ok, "per-span energy does not fold to the fleet total"


def test_energy_mismatch_capture(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), cooldown_s=0.0)
    assert inc.check_energy(_Ledger(True), 1.0)
    assert not inc.captures
    assert not inc.check_energy(_Ledger(False), 2.0)
    b = obs.load_incident_bundle(inc.captures[0]["path"])
    assert b["reason"] == "energy_mismatch" and b["t"] == 2.0
    assert "fold" in b["trigger_detail"]["error"]


def test_gateway_capture_incident_snapshots_debug_state(tmp_path):
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=32, paged=True,
                      block_size=4)
    inc = obs.IncidentCapture(str(tmp_path), flight=obs.FlightRecorder())
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=4,
                       flight=obs.FlightRecorder(), incident=inc)
    gw.run(_prompt_arrivals(cfg, 3))
    path = gw.capture_incident("operator_probe", extra={"ticket": "X-1"})
    assert pathlib.Path(path).name.endswith("operator_probe.json")
    b = obs.load_incident_bundle(path)
    assert b["trigger_detail"] == {"ticket": "X-1"}
    st = b["state"]
    assert st["kind"] == "prompt_gateway"
    assert st["pool"]["free_blocks"] >= 0      # pool snapshot rode along
    assert st["batcher"]["n_slots"] == 2
    gw_plain = PromptGateway(ContinuousBatcher(ad))
    with pytest.raises(RuntimeError):
        gw_plain.capture_incident("nope")


def test_servespec_arms_flight_and_incident(tmp_path):
    cfg, params = _setup()
    spec = ServeSpec(n_slots=2, max_len=32, paged=True, block_size=4,
                     max_new_tokens=4, flight=True,
                     incident_dir=str(tmp_path))
    gw = make_gateway(cfg, params, spec)
    assert isinstance(gw.incident, obs.IncidentCapture)
    assert isinstance(gw.flight, obs.FlightRecorder)
    assert gw.incident.flight is gw.flight
    tel = gw.run(_prompt_arrivals(cfg, 3))
    assert len(tel.records) == 3
    path = gw.capture_incident("smoke")
    assert obs.load_incident_bundle(path)["state"]["kind"] == \
        "prompt_gateway"


def _many_span_flight(n=600):
    fl = obs.FlightRecorder()
    for i in range(n):
        fl({"name": "decode", "ph": "X", "pid": 0, "tid": i % 7,
            "ts": i * 1e-3, "dur": 1e-4,
            "args": {"note": "x" * 40}})
    return fl


def test_size_bound_shrinks_flight_until_bundle_fits(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), flight=_many_span_flight(),
                              max_bytes=16 * 1024)
    path = inc.capture("probe")
    assert pathlib.Path(path).stat().st_size <= 16 * 1024
    b = obs.load_incident_bundle(path)
    acct = b["flight"]["accounting"]
    assert acct["spans_kept"] < acct["spans_seen"]
    assert acct["spans_dropped"] == acct["spans_seen"] - acct["spans_kept"]


def test_impossible_size_bound_raises_instead_of_writing(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), flight=_many_span_flight(),
                              max_bytes=64)
    with pytest.raises(ValueError, match="cannot fit"):
        inc.capture("probe")
    assert not list(tmp_path.glob("*.json"))   # nothing half-written


def test_writer_refuses_schema_violations(tmp_path):
    good = {"schema": inc_mod.SCHEMA, "reason": "probe", "t": 0.0,
            "seq": 0, "trigger_detail": {}, "state": {}, "flight": None,
            "slo": None, "recompile": None}
    path = str(tmp_path / "b.json")
    inc_mod.write_incident_bundle(path, good)
    assert obs.validate_incident_bundle(json.load(open(path))) == []
    for bad in (
        {**good, "schema": "repro.incident.v0"},      # wrong schema tag
        {**good, "reason": ""},                       # empty reason
        {k: v for k, v in good.items() if k != "t"},  # missing field
        {**good, "flight": {"spans": []}},            # gutted flight section
    ):
        with pytest.raises(ValueError, match="refusing"):
            inc_mod.write_incident_bundle(str(tmp_path / "bad.json"), bad)
    assert not (tmp_path / "bad.json").exists()


def test_truncated_bundle_is_rejected_on_load(tmp_path):
    inc = obs.IncidentCapture(str(tmp_path), flight=_many_span_flight(64))
    path = inc.capture("probe")
    text = open(path).read()
    open(path, "w").write(text[:len(text) // 2])
    with pytest.raises(ValueError, match="unreadable"):
        obs.load_incident_bundle(path)
    # a parseable-but-doctored bundle fails the schema pass instead
    doctored = json.loads(text)
    del doctored["flight"]["accounting"]
    open(path, "w").write(json.dumps(doctored))
    with pytest.raises(ValueError, match="accounting"):
        obs.load_incident_bundle(path)


def test_accounting_seen_lt_kept_is_invalid():
    fl = obs.FlightRecorder()
    fl({"name": "a", "ph": "X", "pid": 0, "tid": 0, "ts": 0.0,
        "dur": 1e-3, "args": {}})
    snap = fl.snapshot()
    snap["accounting"]["spans_seen"] = 0       # forged: kept > seen
    bundle = {"schema": inc_mod.SCHEMA, "reason": "probe", "t": 0.0,
              "seq": 0, "trigger_detail": {}, "state": {}, "flight": snap,
              "slo": None, "recompile": None}
    assert any("spans_seen" in e
               for e in obs.validate_incident_bundle(bundle))


def test_cli_inspect_diff_critpath(tmp_path, capsys):
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1,), max_queue=16,
                                         max_delay_s=0.0005,
                                         service_model="fixed",
                                         fixed_service_s=0.002),
                           fe.FrontendSpec(mode="sc", bits=4))
    gw.warmup()
    fl = obs.FlightRecorder()
    mon = obs.SLOMonitor(_policy())
    inc = obs.IncidentCapture(str(tmp_path), flight=fl, slo=mon,
                              cooldown_s=0.0, drop_burst=4,
                              drop_window_s=0.05)
    gw.run(_frame_arrivals(60), slo=mon, flight=fl, incident=inc)
    assert len(inc.captures) >= 2              # slo_critical then drop_burst
    a, b = inc.captures[0]["path"], inc.captures[-1]["path"]

    assert inc_mod.main(["inspect", a]) == 0
    out = capsys.readouterr().out
    assert "reason=slo_critical" in out and "flight:" in out
    assert "warn -> critical" in out

    assert inc_mod.main(["diff", a, b]) == 0
    out = capsys.readouterr().out
    assert "->" in out

    assert inc_mod.main(["critpath", a]) == 0
    out = capsys.readouterr().out
    assert "exact re-fold: True" in out and "queue_wait" in out

    bad = tmp_path / "trunc.json"
    bad.write_text(open(a).read()[:100])
    assert inc_mod.main(["inspect", str(bad)]) == 1
    assert "ERROR" in capsys.readouterr().out



def test_recompile_leak_polled_into_a_bundle(tmp_path):
    """The reference's test over a ``jax.jit``; here a captured step, whose
    new input shape is a new captured key."""
    import torch
    f = capture.CapturedStep(lambda x: x * 2, torch.device("cpu"))
    det = obs.RecompileDetector()
    det.track("t", {"f": f})
    f(np.ones(2, np.float32))
    det.snapshot()
    inc = obs.IncidentCapture(str(tmp_path), detector=det, cooldown_s=0.0)
    f(np.zeros(2, np.float32))                 # same shape: the same key
    inc.poll(0.1)
    assert not inc.captures                    # steady state: nothing
    f(np.zeros(3, np.float32))                 # new shape: a leak
    inc.poll(0.2)
    assert len(inc.captures) == 1
    b = obs.load_incident_bundle(inc.captures[0]["path"])
    assert b["reason"] == "recompile_leak"
    assert b["trigger_detail"]["by_fn"] == {"t.f": 1}
    assert b["recompile"]["steady_state_recompiles"] == 1
    inc.poll(0.3)                              # same leak: not re-captured
    assert len(inc.captures) == 1


# ==========================================================================
# Parity with the reference.
# ==========================================================================

def _load(mod, vocab):
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, 8)
    return [mod.Arrival(t=0.002 * i, uid=i, endpoint=0, kind="prompt",
                        payload=np.concatenate(
                            [prefix, rng.integers(0, vocab, 3)]
                        ).astype(np.int32)) for i in range(5)]


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_prompt_bundle_matches_reference(backend, tmp_path):
    jcfg, jparams, cfg, params = smoke_pair()
    kw = dict(n_slots=2, max_len=32, paged=True, block_size=4,
              max_new_tokens=4, flight=True)
    gw = make_gateway(cfg, params, ServeSpec(
        backend=backend, incident_dir=str(tmp_path / "port"),
        metrics=obs.MetricsRegistry(interval_s=0.003), **kw))
    jg = jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(
        backend={"plain": "xla"}.get(backend, backend),
        incident_dir=str(tmp_path / "ref"),
        metrics=jobs.MetricsRegistry(interval_s=0.003), **kw))
    p1, p2 = fake_clock(gw_mod, tracer_mod)
    with p1, p2:
        tel = gw.run(_load(gw_mod, cfg.vocab))
        path = gw.capture_incident("probe", extra={"ticket": 7})
    p1, p2 = fake_clock(jgw, jtracer)
    with p1, p2:
        jg.run(_load(jgw, cfg.vocab))
        jpath = jg.capture_incident("probe", extra={"ticket": 7})
    assert len(tel.records) == 5
    b, jb = obs.load_incident_bundle(path), jobs.load_incident_bundle(jpath)
    assert pathlib.Path(path).name == pathlib.Path(jpath).name
    sizes, jsizes = (x["state"].pop("jit_cache_sizes") for x in (b, jb))
    assert set(sizes) <= set(jsizes)
    assert {k: jsizes[k] for k in sizes} == sizes
    # the port's "plain" tick is the reference's "xla" one
    assert (b["state"].pop("backend"), jb["state"].pop("backend")) in (
        ("plain", "xla"), ("cascade", "cascade"))
    assert b == jb
    assert b["flight"]["spans"] and b["flight"]["samples"]


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.serve.obs.incident``: the package resolves
    the incident names lazily, so the module loads once (no runpy
    warning), and a valid bundle inspects with exit code 0."""
    inc = obs.IncidentCapture(str(tmp_path), flight=_many_span_flight(8))
    path = inc.capture("probe")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run(
        [sys.executable, "-W", "error::RuntimeWarning", "-m",
         "repro_torch.serve.obs.incident", "inspect", path],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "reason=probe" in out.stdout
