"""The port's paged serving stack against the reference's, decoder family,
stablelm-3b smoke size in float32 with the reference's weights: the decode
tick (both backends: tokens equal, logits within 2e-4), the one-shot paged
adapter over a scripted sequence that forces a radix hit, a copy-on-write
and an at-capacity lane (tokens, tables, lens, slot and pool statistics
equal), the continuous batcher, and the prompt gateway on a seeded trace
(per request: generated tokens, energy, link bytes and KV blocks equal);
the tick and the adapter also for the moe family (deepseek-moe-16b's smoke
size, each lane routed as its own group as the reference's vmapped tick
routes it), the adapter for the hybrid family (hymba-1.5b's smoke
size, with the lanes' recurrent state), and the adapter and the prompt
gateway for the encdec family (whisper-medium's smoke size, the reference
tests' frames as ``extras``, the lanes' cross K/V within 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro_torch.dist.sharding import Mesh
from repro_torch.serve import engine, spec
from repro_torch.serve.gateway import sensors, slots
from repro_torch.serve.shard import RolePlan
from test_torch_lm import ENCDEC, HYMBA, MOE, extras_pair, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


@pytest.fixture(scope="module")
def moe_pair():
    return smoke_pair(arch=MOE)


@pytest.fixture(scope="module")
def hymba_pair():
    return smoke_pair(arch=HYMBA)


@pytest.fixture(scope="module")
def encdec_pair():
    return smoke_pair(arch=ENCDEC)


def _adapters(pair, backend, n_slots=3, max_len=16):
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    ref = jslots.make_adapter(jcfg, jparams, n_slots=n_slots,
                              max_len=max_len, extras=jx, paged=True,
                              block_size=BS, chunked=False, backend="xla")
    port = slots.make_adapter(cfg, params, n_slots=n_slots, max_len=max_len,
                              extras=px, paged=True, block_size=BS,
                              chunked=False, backend=backend)
    return ref, port


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_decode_tick_matches_reference(pair, backend):
    """engine.decode_step_paged vs the reference's backend="xla" tick on the
    same arena: logits within 2e-4, greedy tokens equal, the written rows
    within 1e-5 and every other arena row untouched.  backend="cuda" on
    CPU tensors runs the kernels' plain versions."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(0)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    nb, S = 4, 3
    num_blocks = S * nb + 1
    arena_np = {k: rng.normal(0, 1, (L, num_blocks, 1, BS, Hkv, D)
                              ).astype(np.float32) for k in ("k", "v")}
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(S, nb
                                                               ).astype(np.int32)
    lens = np.array([5, 8, nb * BS], np.int32)      # mid, boundary, full
    tokens = rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32)
    wbids = np.array([tables[0, 1], tables[1, 2], 0], np.int32)
    arena = {k: torch.from_numpy(v.copy()) for k, v in arena_np.items()}
    logits = engine.decode_step_paged(
        cfg, params, torch.from_numpy(tokens), tables=torch.from_numpy(tables),
        lens=torch.from_numpy(lens), arena=arena,
        wbids=torch.from_numpy(wbids), backend=backend)
    jarena, _, jlogits = jengine.decode_step_paged(
        jcfg, jparams, {"len": jnp.asarray(lens)}, jnp.asarray(tokens),
        tables=jnp.asarray(tables), lens=jnp.asarray(lens),
        arena={k: jnp.asarray(v) for k, v in arena_np.items()},
        wbids=jnp.asarray(wbids), backend="xla")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    for key in ("k", "v"):
        got, want = arena[key].numpy(), np.asarray(jarena[key])
        written = np.zeros(got.shape[:4], bool)
        written[:, wbids, 0, lens % BS] = True
        written[:, 0] = True                        # trash: garbage
        np.testing.assert_array_equal(got[~written], arena_np[key][~written])
        lanes = [0, 1]
        np.testing.assert_allclose(got[:, wbids[lanes], 0, lens[lanes] % BS],
                                   want[:, wbids[lanes], 0, lens[lanes] % BS],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_moe_decode_tick_matches_reference(moe_pair, backend):
    test_decode_tick_matches_reference(moe_pair, backend)


def _same_state(ref, port):
    np.testing.assert_array_equal(port.tables, np.asarray(ref.tables))
    np.testing.assert_array_equal(port.lens, np.asarray(ref.lens))
    assert port.slot_bids == ref.slot_bids
    assert port.cow_blk == ref.cow_blk and port.cow_spare == ref.cow_spare
    for s in range(port.n_slots):
        assert port.slot_stats(s) == ref.slot_stats(s)
    assert port.pool_stats() == ref.pool_stats()
    for key, a in port.state.items():      # the lane state: the hybrid
        # family's recurrent state, the encdec family's cross K/V
        want = np.moveaxis(np.asarray(ref.cache[key])[:, :, 0], 0, 1)
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_adapter_sharing_cow_and_capacity_match_reference(pair, backend):
    """Slot 0 and slot 2 admit the same 10-token prompt (two full-block
    hits plus the shared partial block, so both must copy on their first
    write); slot 1 shares the two full blocks only.  Forced tokens then
    run every lane to capacity, where it must write the trash block."""
    ref, port = _adapters(pair, backend)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 512, 10).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 512, 3)]).astype(np.int32)
    for slot, prompt, max_new in ((0, a, 6), (2, a, 6), (1, b, 5)):
        assert port.insert(slot, prompt, max_new) == \
            ref.insert(slot, prompt, max_new)
        _same_state(ref, port)
    assert port.cow_blk[0] == port.cow_blk[2] == 2
    assert port.slot_stats(1)["prefix_hit_blocks"] == 2
    active = np.ones(3, bool)
    for _ in range(7):
        live = [s for s in range(3) if not port.at_capacity(s)]
        forced = rng.integers(0, 512, 3).astype(np.int32)
        got, want = port.decode(forced, active), ref.decode(forced, active)
        np.testing.assert_array_equal(got[live], np.asarray(want)[live])
        np.testing.assert_allclose(port.last_logits[live].numpy(),
                                   np.asarray(ref.last_logits)[live],
                                   rtol=2e-4, atol=2e-4)
        _same_state(ref, port)
        for s in live:                  # every block a live lane reads
            for bid in port.slot_bids[s]:
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        port.arena_block(key, bid).numpy(),
                        np.asarray(ref.arena_block(key, bid)),
                        rtol=1e-5, atol=1e-5)
    assert all(port.at_capacity(s) for s in range(3))
    assert port.pool_stats()["cow_copies"] == 2
    for s in range(3):
        port.clear(s)
        ref.clear(s)
        _same_state(ref, port)


def test_moe_adapter_sharing_cow_and_capacity_match_reference(moe_pair):
    test_adapter_sharing_cow_and_capacity_match_reference(moe_pair, "cuda")


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_hymba_adapter_sharing_cow_and_capacity_match_reference(hymba_pair,
                                                                backend):
    """The hybrid family: the lanes' state within 1e-5 of the reference's
    after every step, a lane at capacity (inactive) keeping its own."""
    test_adapter_sharing_cow_and_capacity_match_reference(hymba_pair,
                                                          backend)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_encdec_adapter_sharing_cow_and_capacity_match_reference(encdec_pair,
                                                                 backend):
    """The encdec family: every admission encodes the frames (a radix hit
    too), and the lanes' cross K/V stay within 1e-5 of the reference's."""
    test_adapter_sharing_cow_and_capacity_match_reference(encdec_pair,
                                                          backend)


def test_adapter_admission_demand_matches_reference(pair):
    ref, port = _adapters(pair, "plain", n_slots=2, max_len=12)
    prompt = np.arange(6, dtype=np.int32)
    for ad in (ref, port):
        ad.insert(0, prompt, 2)
    for p, n in ((prompt, 2), (prompt[:4], 8), (prompt + 1, 6)):
        assert port._admission_demand(p, n) == ref._admission_demand(p, n)
        assert port.can_admit(p, n) == ref.can_admit(p, n)
    with pytest.raises(ValueError):
        port.validate_request(40, 20)


def _requests(mod, rng, n=6):
    base = rng.integers(0, 512, 9).astype(np.int32)
    reqs = []
    for uid in range(n):
        tail = rng.integers(0, 512, uid % 3).astype(np.int32)
        prompt = np.concatenate([base[:5 + uid % 4], tail]).astype(np.int32)
        reqs.append(mod.Request(uid=uid, prompt=prompt,
                                max_new_tokens=3 + uid % 3))
    return reqs


def test_batcher_matches_reference(pair):
    ref, port = _adapters(pair, "plain", n_slots=2, max_len=16)
    rng = np.random.default_rng(2)
    jb, tb = jslots.ContinuousBatcher(ref), slots.ContinuousBatcher(port)
    for r in _requests(jslots, np.random.default_rng(2)):
        jb.submit(r)
    for r in _requests(slots, rng):
        tb.submit(r)
    done = {r.uid: r for r in tb.run()}
    jdone = {r.uid: r for r in jb.run()}
    assert done.keys() == jdone.keys() == set(range(6))
    for uid, r in done.items():
        j = jdone[uid]
        assert (r.generated, r.kv_blocks, r.prefix_hit_blocks) == \
            (j.generated, j.kv_blocks, j.prefix_hit_blocks)
    assert tb.peak_active == jb.peak_active == 2
    assert port.pool_stats() == ref.pool_stats()


def test_prompt_gateway_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    fleet = dict(n_endpoints=8, prompt_fraction=0.25, frame_rate_hz=6.0,
                 seed=3, image_pool=8)
    trace = sensors.SensorFleet(sensors.FleetConfig(**fleet)).events(1.0)
    jtrace = jsensors.SensorFleet(jsensors.FleetConfig(**fleet)).events(1.0)
    assert 4 <= sum(a.kind == "prompt" for a in trace) <= 40
    kw = dict(n_slots=2, max_len=32, paged=True, block_size=BS,
              chunked=False, max_new_tokens=6)
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw), extras=px,
                           device="cpu")
    jgw = jspec.make_gateway(jcfg, jparams,
                             jspec.ServeSpec(backend="xla", **kw), extras=jx)
    assert gw.batcher.adapter.backend == "plain"
    gen = {}
    for g, out in ((gw, "port"), (jgw, "ref")):
        step = g.batcher.step

        def traced(step=step, out=out):
            fin = step()
            for r in fin:
                gen[(out, r.uid)] = list(r.generated)
            return fin
        g.batcher.step = traced
        g.warmup((8, 12, 16))
    tel, jtel = gw.run(trace), jgw.run(jtrace)
    assert tel.dropped == jtel.dropped
    assert len(tel.records) == len(jtel.records) > 0
    recs = {r.uid: r for r in tel.records}
    for j in jtel.records:
        r = recs[j.uid]
        assert gen[("port", r.uid)] == gen[("ref", j.uid)]
        assert (r.energy_nj, r.link_bytes, r.kv_blocks, r.output,
                r.tokens_out, r.endpoint, r.t_arrival) == \
            (j.energy_nj, j.link_bytes, j.kv_blocks, j.output,
             j.tokens_out, j.endpoint, j.t_arrival)
        assert 0 <= r.t_dequeue <= r.t_admit <= r.t_done
    assert tel.pool["prefill_tokens_total"] == \
        jtel.pool["prefill_tokens_total"]


def test_encdec_prompt_gateway_matches_reference(encdec_pair):
    test_prompt_gateway_matches_reference(encdec_pair)


def test_spec_refuses_what_is_not_ported(pair):
    """Names the enum does not hold and the reference's refused
    combinations (``mesh`` without ``paged=True``, ``roles`` without
    ``mesh``) are refused; the dense slots (``paged=False``),
    ``backend="gather"``, the observability attachments
    (``tests/test_torch_obs.py``), single-device slices
    (``tests/test_torch_sharded.py``) and slices of two devices (tensor
    parallelism within a slice, ``tests/test_torch_model_axis.py``) are
    ported: a ``mesh`` of two-device slices builds, chunked or not."""
    _, _, cfg, params = pair
    cpu = torch.device("cpu")
    wide = Mesh(np.asarray([[cpu, cpu]], object), ("data", "model"))
    for kw in (dict(paged=True, mesh=wide),                     # chunked
               dict(paged=True, chunked=False, mesh=[[cpu, cpu]])):
        gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw),
                               device="cpu")
        assert [len(sl.adapter.shards) for sl in gw.slices] == [2]
    for kw, err in ((dict(mesh=[cpu]), ValueError),              # dense
                    (dict(paged=True, roles=RolePlan.split(1, 1)),
                     ValueError),
                    (dict(paged=True, chunked=False, backend="xla"),
                     ValueError),
                    (dict(paged=False, chunked=False, backend="plain"),
                     ValueError)):
        with pytest.raises(err):
            spec.make_gateway(cfg, params, spec.ServeSpec(**kw),
                              device="cpu")
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else ValueError):
        spec.make_gateway(cfg, params, spec.ServeSpec(paged=True,
                                                      chunked=False))
