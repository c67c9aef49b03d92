"""Disaggregated prefill/decode serving in the port (``serve/shard/`` under
a ``RolePlan``) against the reference's (``tests/test_disagg.py``) on the
CPU.

Every test of the reference's file is mirrored at its smoke configs
(float32, the reference's weights, the decoder, moe, hybrid and encdec
families), each scenario run through both packages
(``test_torch_sharded._sides``, each reference run once per module): the
tokens, the handoff counters and bytes, the records and the ledger's nJ
equal the reference's; the migration rollbacks leave both slices as they
were and the moved lane continues the stay-put run bit for bit; the pool's
protected eviction, the per-role shedding and the per-role series are the
reference's.  The reference's forced 8-device head-of-line test runs here
on 8 ``"cpu"`` slices."""
import functools
import types

import numpy as np
import pytest
import torch

from repro.serve.kvcache.pool import BlockPool as JBlockPool
from repro_torch.launch.mesh import make_disagg_meshes
from repro_torch.serve.kvcache.pool import BlockPool, PoolExhausted, \
    chain_keys
from repro_torch.serve import shard
from repro_torch.serve.obs import MetricsRegistry
from repro_torch.serve.obs.export import (openmetrics_text,
                                          validate_openmetrics,
                                          write_openmetrics)
from test_torch_sharded import (BS, CPU, FAMILY_ARCH, LOGITS, _np, _records,
                                _sides)

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


def _run_capture(gw, s, prompts):
    """Run ``prompts`` (all arriving at 0) through the gateway; returns
    (the Request objects by uid, the telemetry)."""
    arrivals = [s.Arrival(uid=i, t=0.0, endpoint=0, kind="prompt",
                          payload=p) for i, p in enumerate(prompts)]
    reqs = {}
    orig = gw.submit

    def submit(req):
        reqs[req.uid] = req
        return orig(req)

    gw.submit = submit
    tel = gw.run(arrivals)
    gw.submit = orig
    return reqs, tel


def _oracle_tokens(s, prompts, max_new):
    ad = s.adapter(2, 16)
    out = []
    for i, p in enumerate(prompts):
        ob = s.ContinuousBatcher(ad)
        o = s.Request(uid=1000 + i, prompt=p, max_new_tokens=max_new)
        ob.submit(o)
        ob.run()
        out.append(o.generated)
    return out


# ==========================================================================
# RolePlan and the role meshes.
# ==========================================================================

def test_roleplan_validation():
    """``RolePlan.split``, ``role_of``, and the reference's refusals as
    ``ValueError`` (an overlap, an empty role, a slice outside the plan, a
    plan that does not cover the gateway's slices)."""
    plan = shard.RolePlan.split(1, 2)
    assert plan.prefill == (0,) and plan.decode == (1, 2)
    assert plan.role_of(0) == "prefill" and plan.role_of(2) == "decode"
    with pytest.raises(ValueError):
        shard.RolePlan(prefill=(0, 1), decode=(1, 2))     # overlap
    with pytest.raises(ValueError):
        shard.RolePlan(prefill=(0,), decode=())           # empty role
    with pytest.raises(ValueError):
        plan.role_of(3)                                   # not in the plan
    _, port = _sides("decoder")
    with pytest.raises(ValueError):                       # coverage
        port.gateway(2, roles=shard.RolePlan.split(1, 2))


def test_disagg_meshes_partition_devices():
    """``make_disagg_meshes(1, 7)`` gives one prefill and seven decode
    one-device groups, here all sharing ``"cpu"`` (the reference's: eight
    forced host devices, disjoint); a role without a slice raises; a
    prefill slice of two devices takes the two leading ones."""
    pre, dec = make_disagg_meshes(1, 7, device="cpu")
    assert len(pre) == 1 and len(dec) == 7
    assert all(m.device_list == [CPU] for m in pre + dec)
    with pytest.raises(ValueError):
        make_disagg_meshes(0, 1, device="cpu")
    pre, dec = make_disagg_meshes(1, 2, prefill_model=2, device="cpu")
    assert [m.device_list for m in pre + dec] == [[CPU, CPU], [CPU], [CPU]]


# ==========================================================================
# Handoff parity: the disaggregated gateway's tokens are the stay-put
# oracle's and the reference's; the handoff energy re-folds conserved.
# ==========================================================================

def _disagg_run(s):
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, s.cfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 9, 6, 7)]
    gw = s.gateway(3, roles=s.RolePlan.split(1, 2))
    reqs, tel = _run_capture(gw, s, prompts)
    tel.assert_conserved()
    rep = tel.report(1.0, kind="prompt")
    assert rep["completed"] == len(prompts)
    assert gw.handoffs == len(prompts)
    assert rep["routing"]["handoffs"] == gw.handoffs
    assert rep["routing"]["handoff_bytes"] == gw.handoff_bytes > 0
    assert gw.migrations == 0            # no rebalancing in role mode
    for i, want in enumerate(_oracle_tokens(s, prompts, gw.max_new_tokens)):
        assert reqs[i].generated == want, i
    return ([reqs[i].generated for i in range(len(prompts))],
            _records(tel), rep["routing"], tel.fleet_energy_nj)


@functools.lru_cache(maxsize=None)
def _ref_disagg(family):
    return _disagg_run(_sides(family)[0])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_disagg_tokens_match_oracle(family):
    """1 prefill + 2 decode slices: every request is admitted on the
    prefill slice, handed off, and generates the solo oracle's tokens; the
    tokens, records, routing counters and fleet nJ are the reference's."""
    assert _disagg_run(_sides(family)[1]) == _ref_disagg(family)


def _energy_run(s):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, s.cfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 9, 6)]
    gw = s.gateway(3, roles=s.RolePlan.split(1, 2))
    reqs, tel = _run_capture(gw, s, prompts)
    tel.assert_conserved()
    rep = tel.report(1.0, kind="prompt")
    moved = [r for r in tel.records if r.migration_bytes > 0]
    assert moved and sum(r.migration_bytes for r in moved) == \
        gw.handoff_bytes > 0
    assert rep["migration_bytes_total"] == gw.handoff_bytes
    assert all(reqs[i].migrations == 1 for i in range(len(prompts)))
    return _records(tel), tel.fleet_energy_nj, gw.handoff_bytes


def test_handoff_energy_rides_the_conserved_ledger():
    """Handoff bytes are charged per request through the migration-energy
    pricing: the ledger conserved, the records' bytes summing to the
    router's total; every record's nJ and the fleet's bit for bit the
    reference's."""
    jside, pside = _sides("decoder")
    assert _energy_run(pside) == _energy_run(jside)


def _colocated_run(s):
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, s.cfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 9, 6, 7)]
    colo = s.gateway(3)
    creqs, ctel = _run_capture(colo, s, prompts)
    assert colo.handoffs == 0
    assert ctel.report(1.0, kind="prompt")["routing"]["handoffs"] == 0
    disagg = s.gateway(3, roles=s.RolePlan.split(1, 2))
    dreqs, _ = _run_capture(disagg, s, prompts)
    for i in range(len(prompts)):
        assert creqs[i].generated == dreqs[i].generated, i
    return [creqs[i].generated for i in range(len(prompts))]


def test_colocated_roles_none_matches_disagg_tokens():
    """``roles=None`` and a 1 + 2 role split give the same tokens (the
    colocated run hands nothing off), and the reference's."""
    jside, pside = _sides("decoder")
    assert _colocated_run(pside) == _colocated_run(jside)


# ==========================================================================
# Affinity-aware eviction: a handoff protects the prompt chain on its
# owning decode slice; the pool evicts unprotected blocks first.
# ==========================================================================

def _protect_run(s):
    rng = np.random.default_rng(31)
    prefix = rng.integers(0, s.cfg.vocab, size=2 * BS).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=3,
                                                    dtype=np.int32)]),
               np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=5,
                                                    dtype=np.int32)])]
    gw = s.gateway(3, roles=s.RolePlan.split(1, 2), max_len=24)
    gw.run([s.Arrival(uid=0, t=0.0, endpoint=0, kind="prompt",
                      payload=prompts[0])])
    owners = [i for i in gw.roles.decode
              if gw.slices[i].adapter.pool.protected]
    assert len(owners) == 1
    gw.run([s.Arrival(uid=1, t=0.0, endpoint=0, kind="prompt",
                      payload=prompts[1])])
    assert gw.handoffs == 2
    own = gw.slices[owners[0]].adapter.pool
    keys, _ = chain_keys(prefix, BS)
    assert set(keys) <= own.protected
    assert all(not gw.slices[i].adapter.pool.protected
               for i in gw.roles.decode if i != owners[0])
    return owners, sorted(own.protected), gw.handoff_bytes


def test_handoff_protects_chain_on_owning_decode_slice():
    """Two requests sharing a two-block prefix hand off to the same decode
    slice (radix affinity beats occupancy), whose pool protects the
    chain's keys; the owner, the protected keys and the handoff bytes are
    the reference's."""
    jside, pside = _sides("decoder")
    assert _protect_run(pside) == _protect_run(jside)


def _eviction_run(pool_cls):
    pool = pool_cls(num_blocks=4, block_size=BS)
    bids = [pool.alloc() for _ in range(3)]
    keys = [bytes([i]) * 20 for i in range(3)]
    for k, b in zip(keys, bids):
        pool.register(k, b)
    for b in bids:
        pool.release(b)                         # LRU cold->hot: bids order
    pool.protect([keys[0]])
    got = pool.alloc()                          # coldest unprotected
    assert got == bids[1]
    assert keys[0] in pool.index and keys[1] not in pool.index
    assert pool.protected_evictions == 0
    pool.protect([keys[2]])                     # everything parked protected
    got2 = pool.alloc()
    assert got2 == bids[0]                      # cold-end fallback
    assert pool.protected_evictions == 1
    assert keys[0] not in pool.protected        # unindex clears protection
    pool.unprotect(keys)
    assert not pool.protected
    pool.protect([b"missing" * 3])              # unindexed: a no-op
    assert not pool.protected
    return got, got2, pool.stats()


def test_pool_protected_eviction_preference():
    """Eviction takes the coldest unprotected block first and, with every
    parked block protected, falls back to the cold end and counts it; the
    blocks and the pool's counters are the reference's."""
    assert _eviction_run(BlockPool) == _eviction_run(JBlockPool)


# ==========================================================================
# Migration rollback: a failed move leaves both slices as they were.
# ==========================================================================

def _rollback_exhausted_run(s):
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, s.cfg.vocab, size=9).astype(np.int32)
    src = s.adapter(2, 24, slice=True)
    dst = s.adapter(2, 24, num_blocks=3, slice=True)
    oracle = s.adapter(2, 24, slice=True)
    assert oracle.insert(0, prompt, max_new=8) == \
        src.insert(0, prompt, max_new=8)
    free0, idx0 = len(dst.pool.free), dict(dst.pool.index)
    with pytest.raises(PoolExhausted if s.name == "port" else Exception):
        s.migrate(src, 0, dst, 0, prompt)
    assert len(dst.pool.free) == free0 and dst.pool.index == idx0
    assert not dst.slot_bids[0]
    assert src.slot_bids[0]
    lane0 = np.asarray([True, False])
    tokens = []
    for _ in range(3):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        to, ts = oracle.decode(forced, lane0), src.decode(forced, lane0)
        np.testing.assert_array_equal(to, ts)
        np.testing.assert_array_equal(_np(oracle.last_logits)[0],
                                      _np(src.last_logits)[0])
        tokens.append(int(ts[0]))
    return tokens


def test_migrate_rollback_on_pool_exhausted():
    """A destination too small for the chain: allocation fails partway,
    every destination block is released and its index untouched, and the
    source decodes on bit for bit as the oracle, the reference's
    tokens."""
    jside, pside = _sides("decoder")
    assert _rollback_exhausted_run(pside) == _rollback_exhausted_run(jside)


def _flaky(obj, name, calls, fail_at):
    """Patch ``obj.name`` to count its calls (by block id) and raise on
    call ``fail_at``; returns the original."""
    real = getattr(obj, name)

    def flaky(*args):
        calls.append(args)
        if len(calls) >= fail_at:
            raise RuntimeError("wire dropped mid-copy")
        return real(*args)
    setattr(obj, name, flaky)
    return real


def _rollback_midcopy_run(s):
    rng = np.random.default_rng(43)
    prefix = rng.integers(0, s.cfg.vocab, size=BS).astype(np.int32)
    prompt = np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=7,
                                                  dtype=np.int32)])
    other = np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=5,
                                                 dtype=np.int32)])
    src, dst = s.adapter(2, 24, slice=True), s.adapter(2, 24, slice=True)
    oracle = s.adapter(2, 24, slice=True)
    assert oracle.insert(0, prompt, max_new=8) == \
        src.insert(0, prompt, max_new=8)
    dst.insert(0, other, max_new=4)             # a chain predating the move
    idx0 = dict(dst.pool.index)
    ref0 = dst.pool.refcount.copy()
    free0 = len(dst.pool.free)
    calls: list = []
    name = "write_block" if s.name == "port" else "_write_block"
    real = _flaky(dst, name, calls, 2)
    with pytest.raises(RuntimeError, match="mid-copy"):
        s.migrate(src, 0, dst, 1, prompt)
    setattr(dst, name, real)
    assert len(calls) == 2                      # it failed partway
    assert dst.pool.index == idx0               # registrations undone,
    np.testing.assert_array_equal(dst.pool.refcount, ref0)  # refs restored
    assert len(dst.pool.free) == free0
    assert not dst.slot_bids[1]
    assert src.slot_bids[0]
    receipt = s.migrate(src, 0, dst, 1, prompt)     # the retry succeeds
    assert receipt.bytes_moved > 0
    lane0, lane1 = np.asarray([True, False]), np.asarray([False, True])
    tokens = []
    for _ in range(3):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        to = oracle.decode(forced, lane0)
        td = dst.decode(forced[::-1], lane1)
        assert to[0] == td[1]
        np.testing.assert_array_equal(_np(oracle.last_logits)[0],
                                      _np(dst.last_logits)[1])
        tokens.append(int(td[1]))
    return receipt.bytes_moved, receipt.blocks_moved, \
        receipt.blocks_shared, tokens


def test_migrate_rollback_mid_copy_releases_and_unregisters():
    """A failure after a block was copied and registered unindexes exactly
    this migration's entries, releases its blocks, keeps the destination's
    older chain, leaves the source decodable; the retry succeeds and the
    moved lane continues the oracle bit for bit; the receipt and the
    tokens are the reference's."""
    jside, pside = _sides("decoder")
    assert _rollback_midcopy_run(pside) == _rollback_midcopy_run(jside)


# ==========================================================================
# Per-role admission control: which scheduler sheds under which burn.
# ==========================================================================

def _ev(worst, state="critical"):
    return types.SimpleNamespace(state=state, worst=worst, prev="ok",
                                 burns={}, t=0.0)


def test_per_role_shedding_mapping():
    """TPOT burn (a decode symptom) tightens the handoff scheduler and
    leaves admission alone; every other objective sheds at the door; the
    colocated gateway keeps one bound."""
    _, port = _sides("decoder")
    gw = port.gateway(3, roles=shard.RolePlan.split(1, 2), max_queue=64)
    gw._on_pressure(_ev("ttft"))
    assert gw._shed_role == "prefill"
    assert gw._admit_bound() == 64 // gw.shed_factor
    gw._on_pressure(_ev("tpot"))
    assert gw._shed_role == "decode"
    assert gw._admit_bound() == 64
    gw._on_pressure(_ev("tpot", state="ok"))
    assert gw._shed_role is None and gw._admit_bound() == 64
    colo = port.gateway(2, max_queue=64)
    colo._on_pressure(_ev("tpot"))
    assert colo._shed_role is None
    assert colo._admit_bound() == 64 // colo.shed_factor


def _headroom_run(s):
    gw = s.gateway(3, roles=s.RolePlan.split(1, 2), num_blocks=9)
    rng = np.random.default_rng(47)
    prompt = rng.integers(0, s.cfg.vocab, size=9).astype(np.int32)
    req = s.Request(uid=0, prompt=prompt, max_new_tokens=4)
    gw.submit(req)
    gw.slices[0].batcher.step(decode=False)     # prefilled, awaiting handoff
    assert req.generated and gw.slices[0].batcher.active[0] is req
    first = gw.route_handoff(req)
    assert first in gw.roles.decode
    gw._shedding, gw._shed_role = True, "decode"
    assert gw.route_handoff(req) is None        # headroom x4 not available
    gw._shedding, gw._shed_role = False, None
    return first, gw.route_handoff(req), req.generated


def test_decode_shed_tightens_handoff_headroom():
    """After a prefill-only step (``step(decode=False)``: the lane admitted,
    its prefill token staged, no tick), decode-side shedding needs
    shed_factor x block headroom for a handoff, so the just-fitting slices
    stop being candidates until pressure clears; the targets and the
    staged token are the reference's."""
    jside, pside = _sides("decoder")
    assert _headroom_run(pside) == _headroom_run(jside)


# ==========================================================================
# Per-role observability: the gauge series and the OpenMetrics exposition.
# ==========================================================================

def test_role_metrics_series_and_openmetrics(tmp_path):
    _, port = _sides("decoder")
    rng = np.random.default_rng(53)
    prompts = [rng.integers(0, port.cfg.vocab, size=int(n)).astype(np.int32)
               for n in (5, 9, 6)]
    metrics = MetricsRegistry(interval_s=1e-9)
    gw = port.gateway(3, roles=shard.RolePlan.split(1, 2), metrics=metrics)
    arrivals = [port.Arrival(uid=i, t=0.0, endpoint=0, kind="prompt",
                             payload=p) for i, p in enumerate(prompts)]
    tel = gw.run(arrivals)
    rep = tel.report(1.0, kind="prompt")
    names = set().union(*(s.keys() for s in rep["series"])) - {"t"}
    for want in ("prefill_queue", "decode_queue", "prefill_occupancy",
                 "decode_occupancy", "handoffs", "handoff_bytes"):
        assert want in names, (want, names)
    last = rep["series"][-1]
    assert last["handoffs"] == gw.handoffs == len(prompts)
    assert last["prefill_occupancy"] == 0.0     # drained at run end
    text = openmetrics_text(metrics)
    required = ["repro_handoffs", "repro_handoff_bytes",
                "repro_prefill_occupancy", "repro_decode_occupancy",
                "repro_prefill_queue", "repro_decode_queue"]
    assert validate_openmetrics(text, require=required) == []
    assert validate_openmetrics(text, require=["repro_nope"]) \
        == ["required family 'repro_nope' not declared"]
    out = write_openmetrics(str(tmp_path / "m.txt"), metrics=metrics,
                            require=required)
    assert "repro_handoffs" in out
    with pytest.raises(AssertionError, match="repro_nope"):
        write_openmetrics(str(tmp_path / "m2.txt"), metrics=metrics,
                          require=["repro_nope"])


# ==========================================================================
# 8 slices: the head-of-line relief (the reference's forced 8 devices).
# ==========================================================================

def test_disagg_relieves_decode_head_of_line():
    """A prefill burst at an equal slice budget (8 "cpu" slices): the
    decode slices' p99 tick latency (between-token time; their ticks hold
    no fold) beats the colocated gateway's all-slice p99, whose ticks
    absorb admission's chunked folds; both complete every request."""
    _, port = _sides("decoder")
    rng = np.random.default_rng(61)
    short = [rng.integers(0, port.cfg.vocab, size=5, dtype=np.int32)
             for _ in range(12)]
    burst = [rng.integers(0, port.cfg.vocab, size=28, dtype=np.int32)
             for _ in range(8)]
    arrivals = [port.Arrival(uid=i, t=0.0, endpoint=0, kind="prompt",
                             payload=p) for i, p in enumerate(short)]
    arrivals += [port.Arrival(uid=100 + i, t=0.0, endpoint=0,
                              kind="prompt", payload=p)
                 for i, p in enumerate(burst)]

    def build(roles):
        gw = port.gateway(8, n_slots=2, max_len=36, max_new=6,
                          auto_rebalance=False, roles=roles)
        gw.warmup((4, 8))
        return gw

    colo = build(None)
    ctel = colo.run(list(arrivals))
    disagg = build(shard.RolePlan.split(2, 6))
    dtel = disagg.run(list(arrivals))
    assert ctel.report(1.0, kind="prompt")["completed"] == \
        dtel.report(1.0, kind="prompt")["completed"] == len(arrivals)
    assert disagg.handoffs > 0
    c_p99 = colo.tick_latency_ms("all")
    d_p99 = disagg.tick_latency_ms("decode")
    assert d_p99 > 0 and c_p99 > 0
    assert d_p99 < c_p99, (d_p99, c_p99)
