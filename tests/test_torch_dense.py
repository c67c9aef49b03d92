"""The port's dense KV path and the gather-tick oracle against the
reference's, decoder family, stablelm-3b smoke size in float32 with the
reference's weights: the batched dense ``decode_step`` (one length per
lane) against the reference's, the dense ``KVSlotAdapter`` over admit,
decode, clear and reuse (tokens equal, logits within 2e-4, the whole
cache within 1e-5 and lengths equal), the default ``ServeSpec()`` gateway
on a seeded trace, ``backend="gather"`` against the reference's gather
tick, and, under the reference's own contract
(``tests/test_paged_decode.py``), the port's gather tick and dense adapter
bit for bit against its in-place ``"plain"`` tick; the per-lane step, the
adapter and the bitwise ticks also for the moe family (deepseek-moe-16b's
smoke size), the hybrid family (hymba-1.5b's, the lanes' recurrent
state held to the reference's and bit for bit across the ticks) and the
encdec family (whisper-medium's, with the reference tests' frames as
``extras``; the lanes' cross K/V held to the reference's and bit for bit
across the ticks)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro_torch.serve import engine, spec
from repro_torch.serve.kvcache import paged
from repro_torch.serve.gateway import sensors, slots
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


def _cache(cfg, rng, B, Smax):
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.d_head)
    return {k: rng.normal(0, 1, shape).astype(np.float32) for k in ("k", "v")}


def test_decode_step_matches_reference(pair):
    """One length for every lane (the reference's batched step): logits
    within 2e-4, tokens equal, the written row within 1e-5 and every other
    row untouched; the cache's length advances by one."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(0)
    B, Smax, pos = 3, 12, 7
    c = _cache(cfg, rng, B, Smax)
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    cache = {"len": torch.tensor(pos, dtype=torch.int32),
             **{k: torch.from_numpy(v.copy()) for k, v in c.items()}}
    cache, logits = engine.decode_step(cfg, params, cache,
                                       torch.from_numpy(tokens))
    jcache, jlogits = jengine.decode_step(
        jcfg, jparams, {"len": jnp.int32(pos),
                        **{k: jnp.asarray(v) for k, v in c.items()}},
        jnp.asarray(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert int(cache["len"]) == int(jcache["len"]) == pos + 1
    for key in ("k", "v"):
        got, want = cache[key].numpy(), np.asarray(jcache[key])
        np.testing.assert_allclose(got[:, :, pos], want[:, :, pos],
                                   rtol=1e-5, atol=1e-5)
        rest = np.ones(Smax, bool)
        rest[pos] = False
        np.testing.assert_array_equal(got[:, :, rest], c[key][:, :, rest])


def test_decode_step_per_lane_lengths_match_reference(pair):
    """Each lane at its own position, some inactive: the reference vmaps a
    B=1 step over the lanes and selects the inactive lanes' old cache; the
    port runs one batched step that writes the active lanes' rows only.
    Lane 3 sits at the cache's end (the reference clamps its row)."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    B, Smax = 4, 10
    lens = np.array([0, 5, 9, Smax], np.int32)
    active = np.array([True, False, True, False])
    c = _cache(cfg, rng, B, Smax)
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    cache = {"len": torch.from_numpy(lens.copy()),
             **{k: torch.from_numpy(v.copy()) for k, v in c.items()}}
    _, logits = engine.decode_step(cfg, params, cache,
                                   torch.from_numpy(tokens),
                                   torch.from_numpy(active))
    jc = {"len": jnp.asarray(lens),
          **{k: jnp.asarray(v).transpose(1, 0, 2, 3, 4)[:, :, None]
             for k, v in c.items()}}
    new, jlogits = jax.vmap(lambda cc, t: jengine.decode_step(
        jcfg, jparams, cc, t))(jc, jnp.asarray(tokens)[:, :, None])
    jlogits = np.asarray(jlogits)[:, 0]
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  jlogits.argmax(-1))
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.where(active, lens + 1, lens))
    for key in ("k", "v"):
        got = cache[key].numpy()
        want = np.asarray(new[key])[:, :, 0].transpose(1, 0, 2, 3, 4)
        for b in range(B):
            if active[b]:
                np.testing.assert_allclose(got[:, b], want[:, b], rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(got[:, b], c[key][:, b])


def test_moe_decode_step_per_lane_lengths_match_reference(moe_pair):
    """The moe family: each lane routes as its own group of one token, as
    in the reference's vmapped B=1 step."""
    test_decode_step_per_lane_lengths_match_reference(moe_pair)


def _same_cache(port, ref, tol=1e-5):
    np.testing.assert_array_equal(port.cache["len"].numpy(),
                                  np.asarray(ref.cache["len"]))
    for key in ("k", "v") + tuple(k for k in engine.STATE_KEYS
                                  + engine.CROSS_KEYS if k in port.cache):
        want = np.moveaxis(np.asarray(ref.cache[key])[:, :, 0], 0, 1)
        np.testing.assert_allclose(port.cache[key].numpy(), want, rtol=tol,
                                   atol=tol)


def test_dense_adapter_matches_reference(pair):
    """Admit three prompts, tick with lane 1 inactive, clear lane 1, admit a
    longer prompt into it, tick again: tokens equal, every lane's logits
    (inactive ones too) within 2e-4, the whole cache within 1e-5 and the
    lengths equal after every step; the tick is the captured step the
    reference's ``decode`` names."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    ref = jslots.make_adapter(jcfg, jparams, n_slots=3, max_len=24,
                              extras=jx)
    port = slots.make_adapter(cfg, params, n_slots=3, max_len=24, extras=px)
    assert isinstance(port, slots.KVSlotAdapter)
    assert set(ref.jit_fns()) - set(port.jit_fns()) == {"prefill"} <= \
        set(paged.NOT_CAPTURED)
    rng = np.random.default_rng(2)
    for slot, n in ((0, 5), (1, 9), (2, 3)):
        p = rng.integers(0, cfg.vocab, n).astype(np.int32)
        assert port.insert(slot, p) == ref.insert(slot, p)
        _same_cache(port, ref)

    def ticks(active, n):
        for _ in range(n):
            forced = rng.integers(0, cfg.vocab, 3).astype(np.int32)
            got, want = port.decode(forced, active), ref.decode(forced,
                                                                active)
            np.testing.assert_array_equal(got[active],
                                          np.asarray(want)[active])
            np.testing.assert_allclose(port.last_logits.numpy(),
                                       np.asarray(ref.last_logits),
                                       rtol=2e-4, atol=2e-4)
            _same_cache(port, ref)
    ticks(np.array([True, False, True]), 3)
    port.clear(1)
    ref.clear(1)
    _same_cache(port, ref)
    p = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    assert port.insert(1, p) == ref.insert(1, p)
    _same_cache(port, ref)
    ticks(np.ones(3, bool), 4)
    assert port._decode._cache_size() == 1
    with pytest.raises(ValueError):
        port.insert(0, np.zeros(25, np.int32))


def test_moe_dense_adapter_matches_reference(moe_pair):
    test_dense_adapter_matches_reference(moe_pair)


def test_hymba_dense_adapter_matches_reference(hymba_pair):
    """The hybrid family: the lanes' conv taps and SSM state within 1e-5
    of the reference's slot-stacked ones after every step, an inactive
    lane's kept."""
    test_dense_adapter_matches_reference(hymba_pair)


def test_encdec_dense_adapter_matches_reference(encdec_pair):
    """The encdec family: every admission encodes the frames, and the
    lanes' cross K/V stay within 1e-5 of the reference's after every
    step, a re-admitted slot's rewritten."""
    test_dense_adapter_matches_reference(encdec_pair)


def _trace(mod):
    fleet = dict(n_endpoints=8, prompt_fraction=0.25, frame_rate_hz=6.0,
                 seed=5, image_pool=8)
    return mod.SensorFleet(mod.FleetConfig(**fleet)).events(1.0)


def test_default_gateway_matches_reference(pair):
    """``make_gateway(cfg, params)`` with the default ``ServeSpec()`` (dense
    slots) against the reference's default gateway on a seeded trace: per
    request the generated tokens, energy, link bytes, output and arrival
    equal."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    trace, jtrace = _trace(sensors), _trace(jsensors)
    assert 4 <= sum(a.kind == "prompt" for a in trace) <= 40
    kw = dict(n_slots=2, max_len=32, max_new_tokens=6)
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw), extras=px,
                           device="cpu")
    jgw = jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(**kw), extras=jx)
    assert not spec.ServeSpec().paged
    assert type(gw.batcher.adapter).__name__ == \
        type(jgw.batcher.adapter).__name__ == "KVSlotAdapter"
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
        assert (r.energy_nj, r.link_bytes, r.output, r.tokens_out,
                r.endpoint, r.t_arrival) == \
            (j.energy_nj, j.link_bytes, j.output, j.tokens_out,
             j.endpoint, j.t_arrival)
    assert tel.pool == jtel.pool == {}


def _paged(cfg, params, backend, max_len=24, **kw):
    return slots.make_adapter(cfg, params, n_slots=2, max_len=max_len,
                              extras=extras_pair(cfg)[1], paged=True,
                              block_size=BS, backend=backend, **kw)


def _chain_blocks(ad, slot):
    return {(key, j): ad.arena_block(key, bid).numpy()
            for j, bid in enumerate(ad.slot_bids[slot])
            for key in ad.seq_keys}


def test_gather_tick_matches_reference(pair):
    """``backend="gather"`` against the reference's gather tick on the same
    inserts and forced tokens: tokens equal, logits within 2e-4, every
    block of the lanes' chains within 1e-5, and the same tables."""
    jcfg, jparams, cfg, params = pair
    ref = jslots.make_adapter(jcfg, jparams, n_slots=2, max_len=24,
                              extras=extras_pair(cfg)[0], paged=True,
                              block_size=BS, backend="gather")
    port = _paged(cfg, params, "gather")
    assert ref.backend == port.backend == "gather"
    rng = np.random.default_rng(3)
    for slot, n in ((0, 5), (1, 9)):
        p = rng.integers(0, cfg.vocab, n).astype(np.int32)
        assert port.insert(slot, p, max_new=8) == ref.insert(slot, p,
                                                             max_new=8)
    active = np.ones(2, bool)
    for _ in range(6):
        forced = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        np.testing.assert_array_equal(port.decode(forced, active),
                                      np.asarray(ref.decode(forced, active)))
        np.testing.assert_allclose(port.last_logits.numpy(),
                                   np.asarray(ref.last_logits), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_array_equal(port.tables, np.asarray(ref.tables))
    assert port.slot_bids == ref.slot_bids
    for slot in range(2):
        for j, bid in enumerate(port.slot_bids[slot]):
            for key in port.seq_keys:
                np.testing.assert_allclose(
                    port.arena_block(key, bid).numpy(),
                    np.asarray(ref.arena_block(key, bid)), rtol=1e-5,
                    atol=1e-5, err_msg=str((slot, j, key)))
    assert set(port.jit_fns()) == {"decode"}


@pytest.mark.parametrize("chunked", [True, False])
def test_gather_tick_bitwise_vs_inplace_plain(pair, chunked):
    """``tests/test_paged_decode.py::test_inplace_matches_gather_tick_
    bitwise`` on the port: the in-place ``"plain"`` tick produces the
    gather tick's tokens, logits and chain blocks bit for bit, every
    step, with a lane left inactive for two steps."""
    _, _, cfg, params = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, s).astype(np.int32) for s in (5, 9)]
    ads = [_paged(cfg, params, b, chunked=chunked)
           for b in ("plain", "gather")]
    for slot, p in enumerate(prompts):
        toks = [ad.insert(slot, p, max_new=8) for ad in ads]
        assert toks[0] == toks[1]
    for step in range(6):
        active = np.array([True, step not in (2, 3)])
        forced = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        outs = [ad.decode(forced, active) for ad in ads]
        np.testing.assert_array_equal(outs[0], outs[1])
        assert torch.equal(ads[0].last_logits, ads[1].last_logits)
    np.testing.assert_array_equal(ads[0].lens, ads[1].lens)
    assert ads[0].slot_bids == ads[1].slot_bids
    for key in ads[0].state:
        assert torch.equal(ads[0].state[key], ads[1].state[key])
    for slot in range(2):
        a, b = _chain_blocks(ads[0], slot), _chain_blocks(ads[1], slot)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


def test_moe_gather_tick_bitwise_vs_inplace_plain(moe_pair):
    test_gather_tick_bitwise_vs_inplace_plain(moe_pair, True)


def test_hymba_gather_tick_matches_reference(hymba_pair):
    test_gather_tick_matches_reference(hymba_pair)


@pytest.mark.parametrize("chunked", [True, False])
def test_hymba_gather_tick_bitwise_vs_inplace_plain(hymba_pair, chunked):
    """The hybrid family, the lanes' state included: both ticks leave it
    bit for bit equal, the inactive lane's as it was."""
    test_gather_tick_bitwise_vs_inplace_plain(hymba_pair, chunked)


def test_dense_adapter_bitwise_vs_inplace_plain(pair):
    """``tests/test_paged_decode.py::test_inplace_matches_dense_adapter_
    bitwise`` on the port: one-shot paged admission shares the dense
    adapter's prefill, and every tick's tokens and logits are the dense
    tick's bit for bit (the dense cache's ``max_len`` equals the paged
    chain's ``nb_max * bs``)."""
    _, _, cfg, params = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, s).astype(np.int32) for s in (6, 9)]
    pg = _paged(cfg, params, "plain", chunked=False)
    dense = slots.make_adapter(cfg, params, n_slots=2, max_len=24,
                               extras=extras_pair(cfg)[1])
    for slot, p in enumerate(prompts):
        assert pg.insert(slot, p, max_new=8) == dense.insert(slot, p)
    active = np.ones(2, bool)
    for _ in range(6):
        forced = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        np.testing.assert_array_equal(pg.decode(forced, active),
                                      dense.decode(forced, active))
        assert torch.equal(pg.last_logits, dense.last_logits)
        for key in pg.state:
            assert torch.equal(pg.state[key], dense.cache[key])


def test_moe_dense_adapter_bitwise_vs_inplace_plain(moe_pair):
    test_dense_adapter_bitwise_vs_inplace_plain(moe_pair)


def test_hymba_dense_adapter_bitwise_vs_inplace_plain(hymba_pair):
    test_dense_adapter_bitwise_vs_inplace_plain(hymba_pair)


def test_encdec_gather_tick_matches_reference(encdec_pair):
    test_gather_tick_matches_reference(encdec_pair)


@pytest.mark.parametrize("chunked", [True, False])
def test_encdec_gather_tick_bitwise_vs_inplace_plain(encdec_pair, chunked):
    """``tests/test_paged_decode.py:56`` for the encdec family: the gather
    tick reads the lanes' cross K/V from the adapter's state, as the
    in-place tick does, bit for bit."""
    test_gather_tick_bitwise_vs_inplace_plain(encdec_pair, chunked)


def test_encdec_dense_adapter_bitwise_vs_inplace_plain(encdec_pair):
    """``tests/test_paged_decode.py:90`` for the encdec family: the dense
    cache's cross K/V equal the paged lanes' bit for bit, and so does
    every tick."""
    test_dense_adapter_bitwise_vs_inplace_plain(encdec_pair)


def test_gather_gateway_matches_plain_gateway(pair):
    """The gateway over ``backend="gather"`` serves the seeded trace with
    the in-place ``"plain"`` gateway's tokens and ledger."""
    _, _, cfg, params = pair
    trace = _trace(sensors)
    out = {}
    for backend in ("plain", "gather"):
        gw = spec.make_gateway(cfg, params, spec.ServeSpec(
            n_slots=2, max_len=32, paged=True, block_size=BS,
            backend=backend, max_new_tokens=5), device="cpu")
        tel = gw.run(trace)
        out[backend] = sorted((r.uid, r.output, r.tokens_out, r.energy_nj,
                               r.kv_blocks) for r in tel.records)
        assert tel.pool["prefill_tokens_total"] > 0
    assert out["plain"] == out["gather"] and out["plain"]
