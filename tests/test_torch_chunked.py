"""The port's chunked prefill (the fold, its compute-skipping resume on
radix prefix hits, and the chunked paged adapter and gateway) against the
reference, decoder family, stablelm-3b smoke size in float32 with the
reference's weights: ``engine.prefill_chunked`` logits and K/V within 1e-5,
the decoder cases of ``tests/test_chunked_prefill.py`` ported (fold resume
bitwise, adapter resume bitwise against a cold insert, divergent writers
isolated, admission demand equal to the actual allocations, the
at-capacity slot), and the chunked adapter and gateway token for token with
equal tables and pool statistics; the fold, its resume and the adapter also
for the moe family (deepseek-moe-16b's smoke size, routed dropless and
not, windows counted from its first MoE block), and for the hybrid family
(hymba-1.5b's smoke size: the adapter's resume, the chunked adapter with
the lanes' state and the boundary states' bytes, a resume after the
snapshotted slot ticked on, and the snapshots' LRU cap and their drop
with an evicted key, against the reference's), and for the encdec family
(whisper-medium's smoke size with the reference tests' frames as
``extras``: the adapter's resume, the lane's cross K/V bit for bit a cold
insert's, and the chunked adapter).

The reference's two jit-recompile tests (``test_fold_steady_state_never_
recompiles`` and ``test_fold_buckets_shared_process_wide``) are not ported:
PyTorch runs eagerly, so the port has no jit cache to hold steady or to
share between adapters."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve import engine, spec
from repro_torch.serve.gateway import sensors, slots
from repro_torch.serve.kvcache.pool import PoolExhausted
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


def _empty(cfg):
    shape = (cfg.n_layers, 1, 0, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape), "v": torch.zeros(shape),
            "len": torch.tensor(0, dtype=torch.int32)}


def _fold(cfg, params, prompt, cache, start):
    q, logits = start, None
    while q < len(prompt):
        c = min(BS, len(prompt) - q)
        cache, logits = engine.prefill_chunked(
            cfg, params, torch.from_numpy(prompt[None, q:q + c]), cache, q)
        q += c
    return cache, logits


def _jfold(cfg, params, prompt, cache, start):
    q, logits = start, None
    while q < len(prompt):
        c = min(BS, len(prompt) - q)
        cache, logits = jengine.prefill_chunked(
            cfg, params, {"tokens": jnp.asarray(prompt[None, q:q + c])},
            cache, q)
        q += c
    return cache, logits


def _jempty(cfg):
    shape = (cfg.n_layers, 1, 0, cfg.n_kv_heads, cfg.d_head)
    return {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
            "len": jnp.int32(0)}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [0, 5])
def test_prefill_chunked_matches_reference(pair, window):
    """The fold over an 11-token prompt (two full chunks and a partial
    one), cold and resumed at one block: logits and K/V within 1e-5 of the
    reference's fold; with a window of 5 the later chunks attend only the
    prefix's last 5 rows."""
    _check_prefill_chunked(pair, window=window)


@pytest.mark.parametrize("kw", [
    {"moe_dropless_prefill": True}, {"moe_dropless_prefill": False},
    {"moe_dropless_prefill": True, "window": 5, "global_every": 2}],
    ids=["dropless", "capacity", "windows"])
def test_moe_prefill_chunked_matches_reference(moe_pair, kw):
    """The moe family's fold: dense layer 0 unwindowed, then the MoE
    blocks, each chunk routed as one group, dropless or not; under
    ``global_every=2`` the first MoE block is the global one (the
    reference counts the window's index from it, not from layer 0)."""
    _check_prefill_chunked(moe_pair, **kw)


def _check_prefill_chunked(pair, **kw):
    jcfg, jparams, cfg, params = pair
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(cfg, **kw)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 11
                                               ).astype(np.int32)
    cache, logits = _fold(cfg, params, prompt, _empty(cfg), 0)
    jcache, jlogits = _jfold(jcfg, jparams, prompt, _jempty(jcfg), 0)
    assert int(cache["len"]) == 11
    _close(logits, jlogits)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        _close(cache[key], jcache[key])
    warm = {"k": cache["k"][:, :, :BS], "v": cache["v"][:, :, :BS],
            "len": torch.tensor(BS, dtype=torch.int32)}
    jwarm = {"k": jcache["k"][:, :, :BS], "v": jcache["v"][:, :, :BS],
             "len": jnp.int32(BS)}
    c1, l1 = engine.prefill_chunked(
        cfg, params, torch.from_numpy(prompt[None, BS:2 * BS]), warm, BS)
    j1, jl1 = jengine.prefill_chunked(
        jcfg, jparams, {"tokens": jnp.asarray(prompt[None, BS:2 * BS])},
        jwarm, BS)
    _close(l1, jl1)
    _close(c1["k"], j1["k"])
    with pytest.raises(ValueError):
        engine.prefill_chunked(cfg, params, torch.from_numpy(prompt[None]),
                               warm, 0)


def test_engine_fold_resume_bitwise(pair):
    """Resuming the fold at an H-block prefix reproduces the cold fold's
    logits and K/V bit for bit (H = 0 is the cold fold itself)."""
    _, _, cfg, params = pair
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 11
                                               ).astype(np.int32)
    cold, cold_logits = _fold(cfg, params, prompt, _empty(cfg), 0)
    for H in (0, 1, 2):
        q0 = H * BS
        warm = {"k": cold["k"][:, :, :q0].clone(),
                "v": cold["v"][:, :, :q0].clone(),
                "len": torch.tensor(q0, dtype=torch.int32)}
        got, logits = _fold(cfg, params, prompt, warm, q0)
        assert torch.equal(logits, cold_logits), H
        for key in ("k", "v"):
            assert torch.equal(got[key], cold[key]), (key, H)


def test_moe_engine_fold_resume_bitwise(moe_pair):
    test_engine_fold_resume_bitwise(moe_pair)


def _adapter(pair, **kw):
    _, _, cfg, params = pair
    kw = {"n_slots": 2, "max_len": 32, **kw}
    return slots.make_adapter(cfg, params, extras=extras_pair(cfg)[1],
                              paged=True, block_size=BS, **kw)


def _slot_blocks(ad, slot):
    return {(key, j): ad.arena_block(key, bid).clone()
            for j, bid in enumerate(ad.slot_bids[slot])
            for key in ad.seq_keys}


def _same_blocks(a, b):
    assert a.keys() == b.keys()
    for where, t in a.items():
        assert torch.equal(t, b[where]), where


def test_adapter_resume_matches_cold_insert(pair):
    """A prefix-hit insert writes bit-identical blocks, returns bit-identical
    logits and picks the same token as the same prompt admitted cold, also
    when the shared prefix ends mid-block, while skipping the shared
    blocks' prefill."""
    _, _, cfg, _ = pair
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab, 2 * BS).astype(np.int32)
    pa = np.concatenate([prefix, rng.integers(0, cfg.vocab, 3)]
                        ).astype(np.int32)
    pb = np.concatenate([prefix, rng.integers(0, cfg.vocab, 3)]
                        ).astype(np.int32)
    cold = _adapter(pair)
    tok_cold = cold.insert(0, pb, max_new=4)
    assert cold.prefill_chunks_total == 3
    warm = _adapter(pair)
    warm.insert(0, pa, max_new=4)
    tok_warm = warm.insert(1, pb, max_new=4)
    assert warm.prefill_chunks_total == 3 + 1
    assert warm.slot_stats(1)["prefill_tokens_skipped"] == 2 * BS
    assert warm.slot_stats(1)["prefix_hit_blocks"] == 2
    assert tok_warm == tok_cold
    assert torch.equal(warm.last_prefill_logits, cold.last_prefill_logits)
    _same_blocks(_slot_blocks(cold, 0), _slot_blocks(warm, 1))
    for key in engine.CROSS_KEYS:       # the encdec family's, per lane
        if key in warm.state:
            assert torch.equal(warm.state[key][:, 1], cold.state[key][:, 0])
    # a hit ending mid-block: the fold recomputes the boundary chunk into
    # a block of its own
    warm.clear(1)
    tok_mid = warm.insert(1, pa, max_new=4)
    st = warm.slot_stats(1)
    assert st["prefix_hit_blocks"] == 3 and \
        st["prefill_tokens_skipped"] == 2 * BS
    assert warm.slot_bids[1][2] != warm.slot_bids[0][2]
    oracle = _adapter(pair, n_slots=1)
    assert tok_mid == oracle.insert(0, pa, max_new=4)
    _same_blocks(_slot_blocks(oracle, 0), _slot_blocks(warm, 1))
    assert warm.pool_stats()["prefill_tokens_skipped"] == 4 * BS


def test_adapter_divergent_writers_stay_isolated(pair):
    """Two slots admitted from one prompt decode into private boundary
    blocks: one slot's writes leave the sibling's blocks and logits
    untouched, bit for bit."""
    _, _, cfg, _ = pair
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 6
                                               ).astype(np.int32)

    def mk():
        ad = _adapter(pair)
        ad.insert(0, prompt, max_new=8)
        ad.insert(1, prompt, max_new=8)
        return ad

    a, b = mk(), mk()
    blocks0 = _slot_blocks(a, 0)
    for tok in (3, 11, 5, 1):
        a.decode(np.asarray([0, tok], np.int32), np.asarray([False, True]))
    _same_blocks(blocks0, _slot_blocks(a, 0))
    for tok in (7, 2, 5, 9):
        for ad in (a, b):
            ad.decode(np.asarray([tok, 0], np.int32),
                      np.asarray([True, False]))
        assert torch.equal(a.last_logits[0], b.last_logits[0])
    assert a.pool_stats()["cow_copies"] == 0


def _consumed(ad, prompt, max_new, slot):
    before = ad.pool.available()
    ad.insert(slot, prompt, max_new=max_new)
    return before - ad.pool.available()


def test_admission_demand_matches_actual_allocations(pair):
    """``_admission_demand`` equals the supply ``insert`` consumes: cold,
    warm with a live holder (the boundary block priced once), and warm
    from the LRU (revivals consume evictable supply one for one)."""
    _, _, cfg, _ = pair
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.integers(0, cfg.vocab, 2 * BS),
                        rng.integers(0, cfg.vocab, 2)]).astype(np.int32)
    ad = _adapter(pair, n_slots=3, max_len=16, num_blocks=32)
    d = ad._admission_demand(p, 4)
    assert d == 4 and _consumed(ad, p, 4, 0) == d
    d = ad._admission_demand(p, 4)
    assert d == 2 and _consumed(ad, p, 4, 1) == d
    ad.clear(0)
    ad.clear(1)
    d = ad._admission_demand(p, 4)
    assert d == 4 and _consumed(ad, p, 4, 2) == d


def test_failed_chunked_insert_leaks_nothing(pair):
    _, _, cfg, _ = pair
    p = np.random.default_rng(7).integers(0, cfg.vocab, 6).astype(np.int32)
    ad = _adapter(pair, max_len=20, num_blocks=6)
    ad.insert(0, p, max_new=2)
    avail = ad.pool.available()
    assert not ad.can_admit(p, 12)
    with pytest.raises(PoolExhausted):
        ad.insert(1, p, max_new=12)
    assert ad.pool.available() == avail and ad.pool.blocks_in_use() == 2
    ad.clear(0)
    ad.insert(1, p, max_new=12)


def test_at_capacity_slot_writes_trash_and_finishes(pair):
    """A slot whose length reached max_len writes the trash block, keeps
    its length, and the batcher retires its request."""
    _, _, cfg, _ = pair
    p = np.random.default_rng(8).integers(0, cfg.vocab, 6).astype(np.int32)
    ad = _adapter(pair, n_slots=1, max_len=8)
    ad.insert(0, p, max_new=2)
    ad.lens[0] = ad.max_len
    assert ad.at_capacity(0)
    final = int(ad.tables[0, ad.nb_max - 1])
    before = {key: ad.arena_block(key, final).clone() for key in ad.seq_keys}
    ad.decode(np.asarray([3], np.int32), np.asarray([True]))
    assert ad.lens[0] == ad.max_len
    for key in ad.seq_keys:
        assert torch.equal(before[key], ad.arena_block(key, final))
    ad2 = _adapter(pair, n_slots=1, max_len=8)
    batcher = slots.ContinuousBatcher(ad2)
    batcher.submit(slots.Request(uid=0, prompt=p[:4], max_new_tokens=4))
    batcher.step()
    assert batcher.active[0] is not None
    ad2.lens[0] = ad2.max_len
    assert [r.uid for r in batcher.step()] == [0]
    assert batcher.active[0] is None and not batcher.busy


def _same_state(ref, port):
    np.testing.assert_array_equal(port.tables, np.asarray(ref.tables))
    np.testing.assert_array_equal(port.lens, np.asarray(ref.lens))
    assert port.slot_bids == ref.slot_bids
    assert port.partial_reg == ref.partial_reg
    for s in range(port.n_slots):
        assert port.slot_stats(s) == ref.slot_stats(s)
    assert port.pool_stats() == ref.pool_stats()
    for key, a in port.state.items():      # the lane state: the hybrid
        # family's recurrent state, the encdec family's cross K/V
        want = np.moveaxis(np.asarray(ref.cache[key])[:, :, 0], 0, 1)
        _close(a, want)


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_chunked_adapter_matches_reference(pair, backend):
    """The chunked adapter against the reference's ``chunked=True``
    adapter over a scripted sequence: a cold prompt, one that shares its
    two full blocks, one identical to the first (full chain plus the
    partial chunk, recomputed privately), then forced decode ticks: tokens
    equal, logits within 2e-4, equal tables, statistics and pool
    statistics, and the chunks the fold ran."""
    jcfg, jparams, cfg, params = pair
    jbackend = {"plain": "xla", "cuda": "xla", "cascade": "cascade"}[backend]
    jx, px = extras_pair(cfg)
    ref = jslots.make_adapter(jcfg, jparams, n_slots=3, max_len=24,
                              extras=jx, paged=True, block_size=BS,
                              backend=jbackend)
    port = slots.make_adapter(cfg, params, n_slots=3, max_len=24, extras=px,
                              paged=True, block_size=BS, backend=backend)
    assert ref.chunked and port.chunked
    rng = np.random.default_rng(9)
    a = rng.integers(0, cfg.vocab, 10).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, cfg.vocab, 5)]
                       ).astype(np.int32)
    for slot, prompt, max_new in ((0, a, 6), (1, b, 5), (2, a, 6)):
        assert port.insert(slot, prompt, max_new) == \
            ref.insert(slot, prompt, max_new)
        _same_state(ref, port)
    assert [port.slot_stats(s)["prefill_tokens_skipped"]
            for s in range(3)] == [0, 8, 8]
    assert port.prefill_chunks_total == 3 + 2 + 1
    active = np.ones(3, bool)
    for _ in range(4):
        forced = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        got, want = port.decode(forced, active), ref.decode(forced, active)
        np.testing.assert_array_equal(got, np.asarray(want))
        _close(port.last_logits, ref.last_logits, 2e-4)
        _same_state(ref, port)
    for s in range(3):
        port.clear(s)
        ref.clear(s)
        _same_state(ref, port)


def test_moe_chunked_adapter_matches_reference(moe_pair):
    test_chunked_adapter_matches_reference(moe_pair, "cuda")


def test_chunked_gateway_matches_reference(pair):
    """``make_gateway`` with the reference's default ``chunked=True`` on a
    seeded trace, against the reference's gateway: per request the same
    tokens, energy, link bytes and KV blocks, and the same prefill tokens
    skipped."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    fleet = dict(n_endpoints=8, prompt_fraction=0.25, frame_rate_hz=6.0,
                 seed=3, image_pool=8)
    trace = sensors.SensorFleet(sensors.FleetConfig(**fleet)).events(1.0)
    jtrace = jsensors.SensorFleet(jsensors.FleetConfig(**fleet)).events(1.0)
    kw = dict(n_slots=2, max_len=32, paged=True, block_size=BS,
              max_new_tokens=6)
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw), extras=px,
                           device="cpu")
    jgw = jspec.make_gateway(jcfg, jparams,
                             jspec.ServeSpec(backend="xla", **kw), extras=jx)
    assert gw.batcher.adapter.chunked and jgw.batcher.adapter.chunked
    gen = {}
    for g, out in ((gw, "port"), (jgw, "ref")):
        step = g.batcher.step

        def traced(step=step, out=out):
            fin = step()
            for r in fin:
                gen[(out, r.uid)] = list(r.generated)
            return fin
        g.batcher.step = traced
    tel, jtel = gw.run(trace), jgw.run(jtrace)
    assert tel.dropped == jtel.dropped
    assert len(tel.records) == len(jtel.records) > 0
    recs = {r.uid: r for r in tel.records}
    for j in jtel.records:
        r = recs[j.uid]
        assert gen[("port", r.uid)] == gen[("ref", j.uid)]
        assert (r.energy_nj, r.link_bytes, r.kv_blocks, r.output,
                r.tokens_out) == (j.energy_nj, j.link_bytes, j.kv_blocks,
                                  j.output, j.tokens_out)
    for key in ("prefill_tokens_total", "prefill_tokens_skipped",
                "blocks_in_use", "cow_copies"):
        assert tel.pool[key] == jtel.pool[key], key


def test_default_spec_builds_the_chunked_gateway(pair):
    """``ServeSpec(paged=True)`` admits through the fold; for the rwkv
    family, whose O(1) state has nothing to page, it builds state slots
    (``StateSlotAdapter``), as the reference's does."""
    _, _, cfg, params = pair
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(paged=True),
                           device="cpu")
    assert gw.batcher.adapter.chunked
    rwkv = dataclasses.replace(configs.smoke_config("rwkv6_7b"),
                               param_dtype="float32")
    gw = spec.make_gateway(rwkv, lm.init(rwkv, torch.Generator()
                                         .manual_seed(0)),
                           spec.ServeSpec(paged=True), device="cpu")
    assert type(gw.batcher.adapter).__name__ == "StateSlotAdapter"


def test_encdec_adapter_resume_matches_cold_insert(encdec_pair):
    """The encdec family: a prefix hit still runs the encoder (the index
    keys on tokens alone), and the resumed admission's logits, blocks and
    cross K/V are the cold admission's bit for bit."""
    test_adapter_resume_matches_cold_insert(encdec_pair)


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_encdec_chunked_adapter_matches_reference(encdec_pair, backend):
    """The scripted sequence with the lanes' cross K/V within 1e-5 of the
    reference's and ``prefill_tokens_skipped`` equal."""
    test_chunked_adapter_matches_reference(encdec_pair, backend)


def test_hymba_adapter_resume_matches_cold_insert(hymba_pair):
    """``tests/test_chunked_prefill.py::test_adapter_resume_matches_cold_
    insert`` for the hybrid family: the resume starts from the boundary
    state the first admission's fold left."""
    test_adapter_resume_matches_cold_insert(hymba_pair)


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_hymba_chunked_adapter_matches_reference(hymba_pair, backend):
    """The scripted sequence with the lanes' state within 1e-5 of the
    reference's and ``pool_stats()`` (``boundary_state_bytes`` among them)
    equal, every step."""
    test_chunked_adapter_matches_reference(hymba_pair, backend)


def test_hymba_resume_after_the_snapshotted_slot_ticked(hymba_pair):
    """Slot 0 admits a prompt cold, then ticks five times (its state and
    rows written in place each tick); slot 1 then admits a prompt sharing
    its two full blocks and resumes from the boundary state slot 0's fold
    left: logits, blocks and state bit for bit the same prompt admitted
    cold in a fresh adapter, and the held snapshots bit for bit as they
    were committed."""
    _, _, cfg, _ = hymba_pair
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, cfg.vocab, 2 * BS).astype(np.int32)
    pa = np.concatenate([prefix, rng.integers(0, cfg.vocab, 3)]
                        ).astype(np.int32)
    pb = np.concatenate([prefix, rng.integers(0, cfg.vocab, 5)]
                        ).astype(np.int32)
    warm = _adapter(hymba_pair)
    tok = warm.insert(0, pa, max_new=8)
    held = {k: {n: t.clone() for n, t in st.items()}
            for k, st in warm._boundary_states.items()}
    assert len(held) == 2
    for _ in range(5):
        tok = warm.decode(np.asarray([tok, 0], np.int32),
                          np.asarray([True, False]))[0]
    for k, st in warm._boundary_states.items():
        for n, t in st.items():
            assert torch.equal(t, held[k][n])
    warm.insert(1, pb, max_new=4)
    assert warm.slot_stats(1)["prefill_tokens_skipped"] == 2 * BS
    cold = _adapter(hymba_pair)
    cold.insert(0, pb, max_new=4)
    assert torch.equal(warm.last_prefill_logits, cold.last_prefill_logits)
    _same_blocks(_slot_blocks(cold, 0), _slot_blocks(warm, 1))
    for key in ("conv", "ssm"):
        assert torch.equal(warm.state[key][:, 1], cold.state[key][:, 0])
    per = sum(a[:, 0].numel() * a.element_size()
              for a in warm.state.values())
    assert warm.pool_stats()["boundary_state_bytes"] == \
        len(warm._boundary_states) * per


def test_hymba_boundary_states_lru_and_eviction_match_reference(hymba_pair):
    """The reference's boundary-state bookkeeping under pressure: the LRU
    capped at 2 entries (patched into both adapters) and a 9-block arena
    whose evictions unindex keys (their snapshots dropped through
    ``pool.on_unindex``), so a resume is capped at the deepest held
    snapshot or falls back to a cold fold.  Tokens, skipped tokens and
    ``pool_stats()`` equal the reference's after every admission."""
    jcfg, jparams, cfg, params = hymba_pair
    ref = jslots.make_adapter(jcfg, jparams, n_slots=2, max_len=16,
                              paged=True, block_size=BS, num_blocks=9)
    port = slots.make_adapter(cfg, params, n_slots=2, max_len=16,
                              paged=True, block_size=BS, num_blocks=9)
    ref._max_boundary_states = port._max_boundary_states = 2
    rng = np.random.default_rng(13)
    p1 = rng.integers(0, cfg.vocab, 14).astype(np.int32)
    p2 = np.concatenate([p1[:4], rng.integers(0, cfg.vocab, 10)]
                        ).astype(np.int32)
    p3 = np.concatenate([p1[:8], rng.integers(0, cfg.vocab, 6)]
                        ).astype(np.int32)
    p4 = rng.integers(0, cfg.vocab, 14).astype(np.int32)
    skipped = []
    for prompt in (p1, p2, p1, p3, p4, p1, p3):
        assert port.insert(0, prompt, max_new=2) == \
            ref.insert(0, prompt, max_new=2)
        skipped.append(port.slot_stats(0)["prefill_tokens_skipped"])
        _same_state(ref, port)
        assert list(port._boundary_states) == list(ref._boundary_states)
        port.clear(0)
        ref.clear(0)
    assert port.pool.evictions > 0
    assert any(skipped) and not all(skipped[1:])
