"""The port's frame gateway against the reference's on one seeded sensor
trace with shared weights and a fixed service time: every telemetry record
is equal field for field, and so are the drops under a tight queue bound.
The slot batcher against the reference's single-request greedy oracle,
for the decoder, moe, hybrid and encdec families (``tests/test_gateway.py::
test_decoder_family_slot_batcher_parity`` on the port; the encdec family
with the reference tests' frames as ``extras``)."""
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.serve import engine as jengine
from repro.serve.gateway import frontend as jfe
from repro.serve.gateway import gateway as jgw
from repro.serve.gateway import sensors as jsensors
from repro_torch.convert import lenet_params_from_jax
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway import gateway as gw
from repro_torch.serve.gateway import sensors
from repro_torch.serve.gateway import slots
from conftest import sequential_decode_reference
from test_torch_lm import ENCDEC, HYMBA, MOE, extras_pair, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


def _fleet():
    return dict(n_endpoints=8, frame_rate_hz=6.0, seed=4, image_pool=32)


@pytest.fixture(scope="module")
def trace():
    ours = sensors.SensorFleet(sensors.FleetConfig(**_fleet())).events(1.0)
    theirs = jsensors.SensorFleet(jsensors.FleetConfig(**_fleet())).events(1.0)
    assert 16 <= len(ours) <= 64
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.uid, a.t, a.endpoint, a.kind, a.label) == \
            (b.uid, b.t, b.endpoint, b.kind, b.label)
        np.testing.assert_array_equal(a.payload, b.payload)
    return ours, theirs


def _pair(mode, **cfg):
    kw = dict(bucket_sizes=(1, 2, 4), service_model="fixed",
              fixed_service_s=2e-3)
    kw.update(cfg)
    ref = jgw.MicroBatchGateway(jgw.GatewayConfig(**kw),
                                jfe.FrontendSpec(mode=mode, bits=4), seed=1)
    params = lenet_params_from_jax(jax.tree.map(np.asarray, ref.params),
                                   "cpu")
    port = gw.MicroBatchGateway(gw.GatewayConfig(**kw),
                                fe.FrontendSpec(mode=mode, bits=4),
                                params=params, device="cpu")
    return ref, port


@pytest.mark.parametrize("mode", ["sc", "binary"])
def test_records_equal_field_for_field(trace, mode):
    ours, theirs = trace
    ref, port = _pair(mode)
    tel = port.run(ours)
    jtel = ref.run(theirs)
    assert len(tel.records) == len(jtel.records) == len(ours)
    for a, b in zip(tel.records, jtel.records):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    tel.assert_conserved()
    assert tel.fleet_energy_nj == jtel.fleet_energy_nj
    assert tel.report(1.0) == jtel.report(1.0)


@pytest.mark.parametrize("mode", ["sc", "binary"])
def test_drops_equal_under_tight_queue(trace, mode):
    ours, theirs = trace
    ref, port = _pair(mode, max_queue=2, max_delay_s=0.001,
                      fixed_service_s=0.1)
    tel = port.run(ours)
    jtel = ref.run(theirs)
    assert len(tel.dropped) > 0
    assert tel.dropped == jtel.dropped
    assert [dataclasses.asdict(r) for r in tel.records] == \
        [dataclasses.asdict(r) for r in jtel.records]


def test_warmup_and_bucket_padding():
    port = gw.MicroBatchGateway(
        gw.GatewayConfig(bucket_sizes=(1, 2, 4), service_model="fixed"),
        fe.FrontendSpec(mode="sc", bits=2), device="cpu")
    port.warmup()
    assert [port._bucket_for(n) for n in (1, 2, 3, 4, 9)] == [1, 2, 4, 4, 4]
    with pytest.raises(ValueError):
        gw.GatewayConfig(bucket_sizes=(4, 1))


@pytest.mark.parametrize("arch", ["stablelm_3b", MOE, HYMBA, ENCDEC])
def test_slot_batcher_matches_sequential_decode(arch):
    """Three requests through two dense slots (one slot cleared and
    reused): every request's greedy tokens equal the reference's prefill
    and B=1 ``decode_step`` run alone on it."""
    jcfg, jparams, cfg, params = smoke_pair(arch=arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in (5, 9, 7)]
    n_new, max_len = 4, 32
    jx, px = extras_pair(cfg)
    batcher = slots.ContinuousBatcher(
        slots.make_adapter(cfg, params, n_slots=2, max_len=max_len,
                           extras=px))
    for i, p in enumerate(prompts):
        batcher.submit(slots.Request(uid=i, prompt=p, max_new_tokens=n_new))
    got = {r.uid: r.generated for r in batcher.run()}
    assert len(got) == len(prompts)
    # the oracle's engine calls jitted (one decode executable for the three
    # requests), as the reference's adapters run them
    with mock.patch.object(jengine, "prefill",
                           jax.jit(jengine.prefill, static_argnums=0)), \
            mock.patch.object(jengine, "decode_step",
                              jax.jit(jengine.decode_step, static_argnums=0)):
        for i, p in enumerate(prompts):
            want = sequential_decode_reference(jcfg, jparams, p, n_new,
                                               max_len, extras=jx)
            assert got[i] == want, (i, got[i], want)
