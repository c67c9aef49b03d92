"""Sharded paged serving in the port (``repro_torch.serve.shard``) against
the reference's (``tests/test_sharded.py``) on the CPU.

Every test of the reference's file is mirrored at its smoke configs
(float32, the reference's weights through ``convert.lm_params_from_jax``,
the decoder, moe, hybrid and encdec families): the same scenario runs
through both packages (:func:`_sides`), each reference run once per module
(cached), and the port is held to the reference's outputs: greedy tokens
and migration receipts equal, logits within 2e-4 (the paged tick's
contract), the ledger's records, routing counters and nJ equal; and within
the port bit for bit where the reference is bitwise (a one-device slice
against the unsharded adapter, a migrated lane against its stay-put run).
The port's slices share ``"cpu"`` where the reference's ``@multi`` tests
force 8 host devices, so those run here too, on 8 ``"cpu"`` slices (the
reference's side of them on 8 slices sharing its one device).  The two
tests of the model axis (``test_model_axis_sharded_slice_decodes``,
``test_arena_specs_match_layout``) are mirrored in
``tests/test_torch_model_axis.py``; here a slice of two devices builds
from the mesh maker and ``build_slices``."""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro.serve import shard as jshard
from repro_torch.dist.sharding import Mesh, mesh_shape_dict, slice_meshes
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serve.gateway import sensors, slots
from repro_torch.serve import shard
from test_torch_lm import extras_pair, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

FAMILY_ARCH = {                      # one arch per attention family
    "decoder": "stablelm_3b",
    "moe": "deepseek_moe_16b",
    "hybrid": "hymba_1_5b",
    "encdec": "whisper_medium",
}
BS = 4
LOGITS = 2e-4
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _pair(family):
    return smoke_pair(arch=FAMILY_ARCH[family])


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sides(family):
    """The two packages' entry points for ``family``'s smoke model, one
    namespace each: ``adapter(n_slots, max_len, num_blocks=None,
    slice=False)`` (``slice``: placed on a slice's one device),
    ``slices(n, **kw)``, ``gateway(n, **kw)``, ``migrate``, ``Request``,
    ``Arrival``, ``make_adapter`` and ``ContinuousBatcher``."""
    jcfg, jparams, cfg, params = _pair(family)
    jx, px = extras_pair(cfg)
    jdev = JMesh(np.asarray(jax.devices()[:1]), ("model",))

    def side(name, c, p, x, mod_slots, mod_shard, mod_sensors, where):
        def adapter(n_slots, max_len, num_blocks=None, slice=False):
            kw = where if slice else {}
            return mod_slots.make_adapter(
                c, p, n_slots=n_slots, max_len=max_len, extras=x,
                paged=True, block_size=BS, num_blocks=num_blocks, **kw)

        def slices(n, *, n_slots=2, max_len=16, num_blocks=None):
            group = where["mesh"] if "mesh" in where else [where["device"]]
            return mod_shard.build_slices(
                c, p, [group] * n, n_slots=n_slots, max_len=max_len,
                block_size=BS, num_blocks=num_blocks, extras=x)

        def gateway(n, *, n_slots=2, num_blocks=None, max_new=4,
                    auto_rebalance=True, max_queue=128, max_len=16,
                    roles=None, **kw):
            return mod_shard.ShardedPromptGateway(
                slices(n, n_slots=n_slots, max_len=max_len,
                       num_blocks=num_blocks),
                max_new_tokens=max_new, max_queue=max_queue,
                auto_rebalance=auto_rebalance, roles=roles, **kw)
        return types.SimpleNamespace(
            name=name, cfg=c, params=p, extras=x, adapter=adapter,
            slices=slices, gateway=gateway, migrate=mod_shard.migrate_slot,
            RolePlan=mod_shard.RolePlan, Request=mod_slots.Request,
            Arrival=mod_sensors.Arrival,
            ContinuousBatcher=mod_slots.ContinuousBatcher)
    return (side("ref", jcfg, jparams, jx, jslots, jshard, jsensors,
                 {"mesh": jdev}),
            side("port", cfg, params, px, slots, shard, sensors,
                 {"device": CPU}))


def _chain_blocks(ad, slot):
    return {(key, j): _np(ad.arena_block(key, bid))
            for j, bid in enumerate(ad.slot_bids[slot])
            for key in ad.seq_keys}


def _state_rows(ad):
    """The port's lane state (axis 1 the slot), the reference's
    slot-stacked cache (axis 0), as {key: (n_slots, ...)} numpy."""
    if hasattr(ad, "cache"):
        return {k: _np(a) for k, a in ad.cache.items() if k != "len"}
    return {k: np.moveaxis(_np(a), 1, 0) for k, a in ad.state.items()}


# ==========================================================================
# A one-device slice runs the unsharded tick bit for bit, per family.
# ==========================================================================

def _placement_run(s, family):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, s.cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9)]
    un = s.adapter(2, 24)
    sh = s.adapter(2, 24, slice=True)
    out = {"first": [], "tokens": [], "logits": []}
    for slot, p in enumerate(prompts):
        a, b = un.insert(slot, p, max_new=8), sh.insert(slot, p, max_new=8)
        assert a == b
        out["first"].append(a)
    active = np.asarray([True, True])
    for _ in range(4):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        tu, ts = un.decode(forced, active), sh.decode(forced, active)
        np.testing.assert_array_equal(tu, ts)
        np.testing.assert_array_equal(_np(un.last_logits),
                                      _np(sh.last_logits))
        out["tokens"].append(np.asarray(tu).tolist())
        out["logits"].append(_np(un.last_logits))
    assert un.slot_bids == sh.slot_bids
    out["bids"] = un.slot_bids
    for slot in range(2):
        a, b = _chain_blocks(un, slot), _chain_blocks(sh, slot)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))
    ra, rb = _state_rows(un), _state_rows(sh)
    for key in ra:
        np.testing.assert_array_equal(ra[key], rb[key])
    return out


@functools.lru_cache(maxsize=None)
def _ref_placement(family):
    return _placement_run(_sides(family)[0], family)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_slice_placement_bitwise(family):
    """An adapter placed on a slice's device reproduces the unsharded
    adapter's tokens, logits, arena blocks and lane state bit for bit;
    its tokens and blocks are the reference's, its logits within 2e-4."""
    port = _placement_run(_sides(family)[1], family)
    ref = _ref_placement(family)
    assert port["first"] == ref["first"]
    assert port["tokens"] == ref["tokens"]
    assert port["bids"] == ref["bids"]
    for got, want in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(got, want, rtol=LOGITS, atol=LOGITS)


def test_model_axis_waits_for_tensor_parallelism():
    """A slice of two devices (the reference's tensor-parallel slice,
    ``engine.arena_specs``) builds from the mesh maker and from
    ``build_slices``: its adapter's arena splits the KV heads over the two
    devices (``tests/test_torch_model_axis.py`` holds its answers)."""
    (sub,) = slice_meshes(make_serving_mesh(1, model=2, device="cpu"))
    assert sub.device_list == [CPU, CPU]
    _, port = _sides("decoder")
    wide = Mesh(np.asarray([[CPU, CPU]], object), ("data", "model"))
    (sl,) = shard.build_slices(port.cfg, port.params, wide, n_slots=2,
                               max_len=16, block_size=BS)
    assert sl.mesh.device_list == [CPU, CPU]
    heads = port.cfg.n_kv_heads
    assert [sh.heads for sh in sl.adapter.shards] == \
        [(0, heads // 2), (heads // 2, heads)]


# ==========================================================================
# Cross-slice migration mid-decode: the moved lane keeps the stay-put bits.
# ==========================================================================

def _migration_run(s):
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, s.cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9)]
    oracle = s.adapter(2, 24)
    A, B = s.adapter(2, 24, slice=True), s.adapter(2, 24, slice=True)
    active = np.asarray([True, True])
    for slot, p in enumerate(prompts):
        assert oracle.insert(slot, p, max_new=8) == \
            A.insert(slot, p, max_new=8)
    for _ in range(3):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        np.testing.assert_array_equal(oracle.decode(forced, active),
                                      A.decode(forced, active))
    live = -(-int(A.lens[1]) // BS)
    receipt = s.migrate(A, 1, B, 1, prompts[1])
    assert receipt.blocks_moved == live > 0
    assert receipt.blocks_total == len(B.slot_bids[1]) > live
    assert not A.slot_bids[1]                     # source slot released
    hits, _, _, _ = B.pool.match_prefix(prompts[1], count=False)
    assert len(hits) == len(prompts[1]) // BS
    lane1 = np.asarray([False, True])
    out = {"receipt": receipt, "tokens": [], "logits": []}
    for _ in range(3):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        to = oracle.decode(forced, active)
        tb = B.decode(forced, lane1)
        np.testing.assert_array_equal(to[1:], tb[1:])
        np.testing.assert_array_equal(_np(oracle.last_logits)[1],
                                      _np(B.last_logits)[1])
        out["tokens"].append(int(tb[1]))
        out["logits"].append(_np(B.last_logits)[1])
    return out


@functools.lru_cache(maxsize=None)
def _ref_migration(family):
    return _migration_run(_sides(family)[0])


@pytest.mark.parametrize("family", ["decoder", "hybrid", "encdec"])
def test_migration_mid_decode_bitwise(family):
    """Three ticks on slice A, the lane migrated to slice B, three more:
    B continues the stay-put oracle bit for bit (plain K/V, the hybrid
    conv / SSM state row, the encdec cross K/V); the receipt (blocks and
    bytes) and the tokens are the reference's, the logits within 2e-4."""
    port = _migration_run(_sides(family)[1])
    ref = _ref_migration(family)
    assert port["receipt"] == shard.MigrationReceipt(
        **vars(ref["receipt"]))
    assert port["tokens"] == ref["tokens"]
    for got, want in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(got, want, rtol=LOGITS, atol=LOGITS)


def _sharing_run(s):
    rng = np.random.default_rng(31)
    prefix = rng.integers(0, s.cfg.vocab, size=2 * BS).astype(np.int32)
    p0 = np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=3,
                                              dtype=np.int32)])
    p1 = np.concatenate([prefix, rng.integers(0, s.cfg.vocab, size=5,
                                              dtype=np.int32)])
    oracle = s.adapter(2, 24)
    A, B = s.adapter(2, 24, slice=True), s.adapter(2, 24, slice=True)
    for slot, p in enumerate((p0, p1)):
        assert oracle.insert(slot, p, max_new=8) == \
            A.insert(slot, p, max_new=8)
    shared_bids = A.slot_bids[0][:2]
    assert shared_bids == A.slot_bids[1][:2]      # prefix blocks shared
    assert all(A.pool.refcount[b] == 2 for b in shared_bids)
    before = {(key, b): _np(A.arena_block(key, b)).copy()
              for b in shared_bids for key in A.seq_keys}
    live1 = -(-int(A.lens[1]) // BS)
    r1 = s.migrate(A, 1, B, 1, p1)
    assert r1.blocks_shared == 0 and r1.blocks_moved == live1
    assert all(A.pool.refcount[b] == 1 for b in shared_bids)
    for (key, b), val in before.items():
        np.testing.assert_array_equal(val, _np(A.arena_block(key, b)))
    active = np.asarray([True, True])
    lane0 = np.asarray([True, False])
    tokens = []
    for _ in range(3):
        forced = rng.integers(0, s.cfg.vocab, size=2).astype(np.int32)
        to = oracle.decode(forced, active)
        ta = A.decode(forced, lane0)
        np.testing.assert_array_equal(to[:1], ta[:1])
        tokens.append(int(ta[0]))
    live0 = -(-int(A.lens[0]) // BS)
    r0 = s.migrate(A, 0, B, 0, p0)
    assert r0.blocks_shared == 2
    assert r0.blocks_moved == live0 - 2 < r1.blocks_moved
    assert all(B.pool.refcount[b] == 2 for b in B.slot_bids[0][:2])
    return r1, r0, tokens


def test_migration_preserves_sharing_and_cow():
    """Two requests sharing a two-block prefix: moving one leaves the
    sibling's shared blocks bit for bit on the source, which decodes on as
    the oracle; moving the sibling then references the chain on the
    destination instead of copying it.  Both receipts and the sibling's
    tokens are the reference's."""
    jside, pside = _sides("decoder")
    assert _sharing_run(pside) == tuple(
        r if isinstance(r, list) else shard.MigrationReceipt(**vars(r))
        for r in _sharing_run(jside))


# ==========================================================================
# The router: affinity, spill to a non-owning slice, rebalancing, ledger.
# ==========================================================================

def _spill_run(s):
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, s.cfg.vocab, size=2 * BS).astype(np.int32)
    tails = [rng.integers(0, s.cfg.vocab, size=3, dtype=np.int32)
             for _ in range(3)]
    prompts = [np.concatenate([prefix, t]) for t in tails]
    gw = s.gateway(2, n_slots=1, auto_rebalance=False)
    i0 = gw.submit(s.Request(uid=0, prompt=prompts[0], max_new_tokens=4))
    gw.slices[i0].batcher.run()
    assert gw.routing["load"] == 1
    i1, reason = gw.route(prompts[1], 4)
    assert (i1, reason) == (i0, "affinity")
    gw.submit(s.Request(uid=1, prompt=prompts[1], max_new_tokens=4))
    busy = s.Request(uid=2, prompt=prompts[2], max_new_tokens=5)
    gw.slices[i0].batcher.submit(busy)
    gw.slices[i0].batcher.step()
    gw.slices[i0].batcher.submit(s.Request(
        uid=3, prompt=rng.integers(0, s.cfg.vocab, size=5, dtype=np.int32),
        max_new_tokens=4))
    i2, reason = gw.route(prompts[1], 4)
    assert reason == "affinity_spill" and i2 != i0
    req = s.Request(uid=4, prompt=prompts[1], max_new_tokens=4)
    assert gw.submit(req) != i0
    gw.slices[i2].batcher.run()
    ob = s.ContinuousBatcher(s.adapter(1, 16))
    oreq = s.Request(uid=99, prompt=prompts[1], max_new_tokens=4)
    ob.submit(oreq)
    ob.run()
    assert req.generated == oreq.generated
    return dict(gw.routing), req.generated


def test_router_affinity_then_spill_to_non_owning_slice():
    """A prefix seeded on one slice routes its sibling there by affinity;
    with that slice saturated the next sibling spills to the other slice
    and still generates the oracle's tokens; the routing counters and the
    tokens are the reference's."""
    jside, pside = _sides("decoder")
    assert _spill_run(pside) == _spill_run(jside)


def _records(tel):
    return sorted((r.uid, r.energy_nj, r.link_bytes, r.kv_blocks, r.output,
                   r.tokens_out, r.migration_bytes, r.migrations,
                   r.prefix_hit_blocks, r.prefill_tokens_skipped)
                  for r in tel.records)


def _rebalance_run(s):
    rng = np.random.default_rng(51)
    gw = s.gateway(2, n_slots=1, num_blocks=9, max_new=4)
    prefix = rng.integers(0, s.cfg.vocab, size=2 * BS).astype(np.int32)
    a = s.Request(uid=0, prompt=prefix, max_new_tokens=8)
    assert gw.submit(a) == 0
    gw.slices[0].batcher.step()
    b = s.Request(uid=1, prompt=rng.integers(0, s.cfg.vocab, size=6,
                                             dtype=np.int32),
                  max_new_tokens=2)
    assert gw.submit(b) == 1
    c = s.Request(uid=2, prompt=np.concatenate(
        [prefix, rng.integers(0, s.cfg.vocab, size=3, dtype=np.int32)]),
        max_new_tokens=2)
    assert gw.submit(c) == 0
    assert len(gw.slices[0].batcher.pending) == 1
    tel = gw.run([])
    tel.assert_conserved()
    rep = tel.report(1.0, kind="prompt")
    assert rep["completed"] == 3
    assert gw.migrations >= 1
    assert a.migrations >= 1 and a.migration_bytes > 0
    assert c.prefill_tokens_skipped > 0
    assert rep["routing"]["migrations"] == gw.migrations
    assert rep["routing"]["migration_bytes"] == gw.migration_bytes > 0
    assert rep["migration_bytes_total"] == gw.migration_bytes
    assert set(rep["pools"]) == {0, 1}
    assert rep["pool"]["n_slices"] == 2
    migrated = [r for r in tel.records if r.migration_bytes > 0]
    assert migrated and sum(r.migration_bytes for r in migrated) == \
        gw.migration_bytes
    return (_records(tel), rep["routing"], tel.fleet_energy_nj,
            [x.generated for x in (a, b, c)])


def test_router_run_rebalances_and_conserves_energy():
    """A long request blocks its slice while an affinity-routed sibling
    queues behind it and the other slice drains: the loop's rebalancer
    moves the long request to the idle slice, the sibling admits onto the
    warm prefix, the migration bytes land in the conserved ledger; the
    records (nJ, bytes, blocks, outputs), the routing counters, the fleet
    nJ and the tokens are the reference's, bit for bit."""
    jside, pside = _sides("decoder")
    assert _rebalance_run(pside) == _rebalance_run(jside)


# ==========================================================================
# 8 slices: the reference's forced 8-device tests on 8 "cpu" slices.
# ==========================================================================

def test_serving_mesh_factors_into_slices():
    """``make_serving_mesh(8)`` factors into 8 one-device slices, all on
    ``"cpu"`` here (the reference's: 8 forced host devices)."""
    mesh = make_serving_mesh(8, model=1, device="cpu")
    subs = slice_meshes(mesh)
    assert len(subs) == 8
    assert all(m.device_list == [CPU] for m in subs)
    assert mesh_shape_dict(mesh) == {"data": 8, "model": 1}
    assert [mesh_shape_dict(m) for m in subs] == [{"model": 1}] * 8
    mesh2 = make_serving_mesh(4, model=2, device="cpu")
    assert mesh_shape_dict(mesh2) == {"data": 4, "model": 2}
    subs2 = slice_meshes(mesh2)
    assert len(subs2) == 4
    assert all(m.device_list == [CPU, CPU] for m in subs2)


def test_slice_groups_are_device_lists_or_sub_meshes():
    """A slice is a list of devices or a ``("model",)`` sub-mesh
    (``slice_meshes``); a bare device or a sub-mesh of another axis is
    refused."""
    _, port = _sides("decoder")
    kw = dict(n_slots=2, max_len=16, block_size=BS)
    subs = slice_meshes(make_serving_mesh(2, device="cpu"))
    for mesh in (subs, [[CPU], [CPU]], make_serving_mesh(2, device="cpu")):
        slices = shard.build_slices(port.cfg, port.params, mesh, **kw)
        assert [sl.mesh.device_list for sl in slices] == [[CPU], [CPU]]
    with pytest.raises(TypeError, match="list of devices"):
        shard.build_slices(port.cfg, port.params, [CPU, CPU], **kw)
    data = Mesh(np.asarray([CPU], object), ("data",))
    with pytest.raises(ValueError, match="one axis"):
        shard.build_slices(port.cfg, port.params, [data], **kw)


def test_shared_device_round_costs_its_wall_time():
    """Slices that share a device tick one after another on it, so an
    untraced round costs its wall time; only slices on devices of their
    own are priced at the slowest slice's tick plus the router's serial
    work."""
    _, port = _sides("decoder")
    gw = port.gateway(2)
    assert not gw.parallel
    gw._tick_sum, gw._tick_max = 0.25, 0.125
    assert gw._step_cost(0.5) == 0.5
    gw.parallel = True
    assert gw._step_cost(0.5) == 0.375


def _parity8_run(s):
    rng = np.random.default_rng(61)
    gw = s.gateway(8, n_slots=2, max_new=3, auto_rebalance=False)
    prompts = [rng.integers(0, s.cfg.vocab, size=int(n), dtype=np.int32)
               for n in rng.integers(4, 10, size=8)]
    reqs = [s.Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    used = {gw.submit(r) for r in reqs}
    assert len(used) == 8                  # load routing spread the fleet
    while gw.busy:
        gw.step()
    oracle_ad = s.adapter(2, 16)
    for i, p in enumerate(prompts):
        ob = s.ContinuousBatcher(oracle_ad)
        oreq = s.Request(uid=100 + i, prompt=p, max_new_tokens=3)
        ob.submit(oreq)
        ob.run()
        assert reqs[i].generated == oreq.generated, i
    return [r.generated for r in reqs], dict(gw.routing)


def test_router_multi_device_parity():
    """8 one-device slices, one request each (distinct prompts route by
    load): every request generates the unsharded solo run's tokens, and
    the reference's."""
    jside, pside = _sides("decoder")
    assert _parity8_run(pside) == _parity8_run(jside)


def _aggregate_run(s):
    rng = np.random.default_rng(71)
    budget = 9                            # 8 usable blocks per device
    prompts = [rng.integers(0, s.cfg.vocab, size=6, dtype=np.int32)
               for _ in range(16)]
    arrivals = [s.Arrival(uid=i, t=0.0, endpoint=0, kind="prompt",
                          payload=p) for i, p in enumerate(prompts)]
    sb = s.ContinuousBatcher(s.adapter(8, 16, num_blocks=budget))
    for i, p in enumerate(prompts):
        sb.submit(s.Request(uid=i, prompt=p, max_new_tokens=4))
    sb.run()
    gw = s.gateway(8, n_slots=8, num_blocks=budget, max_new=4)
    tel = gw.run(arrivals)
    assert gw.peak_active_total() > sb.peak_active
    return (sb.peak_active, gw.peak_active_total(), _records(tel),
            tel.report(1.0, kind="prompt")["routing"])


def test_aggregate_slots_exceed_single_device():
    """At a fixed per-device block budget, 8 slices sustain more
    concurrent slots than one device; the peaks, the records and the
    routing counters are the reference's."""
    jside, pside = _sides("decoder")
    assert _aggregate_run(pside) == _aggregate_run(jside)
