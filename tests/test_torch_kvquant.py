"""The int8 KV layout (``serve/kvquant.py``, ``LMConfig.kv_quant``) against
the reference on the same inputs and weights, float32 smoke configs:
``quantize`` / ``dequantize`` bit for bit; prefill and the dense tick for
the decoder, moe and hybrid families (logits within 2e-4 of the
reference's int8 logits, codes and scales equal but where the float32 row
lies within rounding of a half step, counted); the in-place ``"plain"``
int8 tick bit for bit its gather oracle (tokens, logits and every chain
block of all four arenas, ``tests/test_paged_decode.py``'s contract); the
refusals and the one-shot admission; the cache's bytes; and a small int8
gateway trace equal to the reference's, record for record."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # bare env: deterministic sweep fallback
    from _hypothesis_compat import given, settings, st

from repro.serve import engine as jengine
from repro.serve import kvquant as jkvquant
from repro.serve import spec as jspec
from repro.serve.gateway import sensors as jsensors
from repro_torch.serve import engine, kvquant, spec
from repro_torch.serve.gateway import sensors, slots
from test_torch_lm import ARCH, HYMBA, MOE, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4
FAMILY_ARCH = {"decoder": ARCH, "moe": MOE, "hybrid": HYMBA}
# the reference test's shapes: two prompts of 12 tokens, the cache grown by 4
B, S, GROW = 2, 12, 4


@pytest.fixture(scope="module", params=sorted(FAMILY_ARCH))
def qpair(request):
    """(family, the reference's cfg and params, the port's) for one
    family's smoke config in float32 with ``kv_quant`` on."""
    return (request.param,) + smoke_pair(arch=FAMILY_ARCH[request.param],
                                         kv_quant=True)


@given(st.integers(1, 64), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_quantize_dequantize_bitwise(d, seed):
    """Codes, scales and both dequantized dtypes bit for bit the
    reference's, rows of ``d`` values at the reference test's spread, one
    row all zeros (the 1e-8 floor) and exact half steps (round half to
    even)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (3, 5, d)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0] = np.arange(d, dtype=np.float32) - d / 2 + 0.5
    # eager: under jit XLA multiplies by a rounded 1/127 where the source
    # divides by 127, so a scale may move by one ulp (ROADMAP.md)
    jq, js = jkvquant.quantize(jnp.asarray(x))
    q, s = kvquant.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jkvquant.dequantize(jq, js, jd).astype(
            jnp.float32))
        got = kvquant.dequantize(q, s, td).float().numpy()
        np.testing.assert_array_equal(got, want)


def _grow(cache, n):
    """The reference test's cache grown by ``n`` positions of zeros."""
    out = dict(cache)
    for k in engine.PAGED_SEQ_KEYS:
        if k in out:
            pad = [(0, 0)] * out[k].ndim
            pad[-3] = (0, n)
            out[k] = jnp.pad(out[k], pad)
    return out


def _half_step_codes(qcfg, params, toks, got, want):
    """Positions where the port's and the reference's int8 codes differ,
    and whether each lies within rounding of a half step: the float32 row
    over its scale (from the port's unquantized prefill, which the fold
    computes the same way) within 1e-3 of a half integer."""
    cache, _ = engine.prefill(dataclasses.replace(qcfg, kv_quant=False),
                              params, toks)
    out = {}
    for key in ("k", "v"):
        diff = got[key].numpy() != want[key]
        y = (cache[key] / got[f"{key}_scale"]).numpy()
        near = np.abs(np.abs(y - np.floor(y)) - 0.5) < 1e-3
        out[key] = (int(diff.sum()), bool((near | ~diff).all()))
    return out


def test_prefill_and_decode_step_match_reference(qpair):
    """Prefill then one dense tick under ``kv_quant`` (float32): logits
    within 2e-4 of the reference's int8 logits at both steps, the cache's
    codes equal but where a half step rounds apart (counted and printed),
    its scales within 1e-5, the tick's row landed int8 beside its
    scale."""
    family, jcfg, jparams, cfg, params = qpair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jcache, jlogits = jengine.prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)})
    cache, logits = engine.prefill(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    assert cache["k"].dtype == torch.int8
    assert tuple(cache["k_scale"].shape) == tuple(jcache["k_scale"].shape)
    want = {k: np.asarray(jcache[k]) for k in engine.PAGED_SEQ_KEYS}
    apart = _half_step_codes(cfg, params, torch.from_numpy(toks), cache,
                             want)
    print(f"{family}: prefill codes apart at half steps {apart}")
    assert all(ok for _, ok in apart.values()), apart
    for key in engine.SCALE_KEYS:
        np.testing.assert_allclose(cache[key].numpy(), want[key], rtol=1e-5,
                                   atol=0)
    # the tick: the reference's grown cache, codes and all, in both
    jgrown = _grow(jcache, GROW)
    grown = {k: torch.from_numpy(np.array(a)) for k, a in jgrown.items()}
    grown["k"], grown["v"] = grown["k"].to(torch.int8), \
        grown["v"].to(torch.int8)
    tick = toks[:, :1]
    jnew, jl2 = jengine.decode_step(jcfg, jparams, jgrown, jnp.asarray(tick))
    new, l2 = engine.decode_step(cfg, params, grown, torch.from_numpy(tick))
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=2e-4,
                               atol=2e-4)
    row = (slice(None), slice(None), S)
    for key in engine.PAGED_SEQ_KEYS:
        got, ref = new[key][row].numpy(), np.asarray(jnew[key])[row]
        if key in engine.SCALE_KEYS:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        else:
            assert np.abs(got.astype(np.int32) - ref).max() <= 1, key
            print(f"{family}: tick {key} codes apart "
                  f"{int((got != ref).sum())} of {got.size}")
    assert int(new["len"]) == S + 1


def _adapter(cfg, params, backend, **kw):
    return slots.make_adapter(cfg, params, n_slots=2, max_len=24,
                              paged=True, block_size=BS, backend=backend,
                              **kw)


def _chain_blocks(ad, slot):
    return {(key, j): ad.arena_block(key, bid).numpy()
            for j, bid in enumerate(ad.slot_bids[slot])
            for key in ad.seq_keys}


def test_inplace_int8_tick_bitwise_vs_gather(qpair):
    """The in-place ``"plain"`` int8 tick against the gather oracle (the
    dense int8 tick on each lane's gathered chain) on the same inserts and
    forced tokens: tokens and logits bit for bit every tick, and every
    chain block of k, v, k_scale and v_scale bit for bit after them
    (``tests/test_paged_decode.py``'s int8 contract, for the decoder, moe
    and hybrid families)."""
    family, _, _, cfg, params = qpair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in (5, 9)]
    inp, gat = (_adapter(cfg, params, b) for b in ("plain", "gather"))
    assert set(inp.seq_keys) == set(engine.PAGED_SEQ_KEYS)
    assert inp.arena["k"].dtype == torch.int8
    for slot, p in enumerate(prompts):
        assert inp.insert(slot, p, 8) == gat.insert(slot, p, 8)
    active = np.ones(2, bool)
    for _ in range(5):
        forced = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        np.testing.assert_array_equal(inp.decode(forced, active),
                                      gat.decode(forced, active))
        assert torch.equal(inp.last_logits, gat.last_logits)
    assert inp.slot_bids == gat.slot_bids
    for slot in range(2):
        a, b = _chain_blocks(inp, slot), _chain_blocks(gat, slot)
        assert {k for k, _ in a} == set(engine.PAGED_SEQ_KEYS)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))
    for key, st_ in inp.state.items():
        assert torch.equal(st_, gat.state[key]), key


def test_refusals_one_shot_admission_and_bytes(qpair):
    """Under ``kv_quant`` an explicit ``"cuda"`` or ``"cascade"`` raises
    naming the layout, ``None`` resolves to ``"plain"``, the fold is off
    (the engine's fold refuses the layout too), and the int8 K/V cache
    (values and scales) holds under 0.6x the bf16 one's bytes."""
    family, _, _, cfg, params = qpair
    for backend in ("cuda", "cascade"):
        with pytest.raises(ValueError, match="kv_quant"):
            _adapter(cfg, params, backend)
    ad = _adapter(cfg, params, None, chunked=True)
    assert ad.backend == "plain" and not ad.chunked
    with pytest.raises(ValueError, match="kv_quant"):
        engine.prefill_chunked(cfg, params,
                               torch.zeros((1, 4), dtype=torch.long),
                               engine.empty_cache(cfg, 1, "cpu"), 0)

    def nbytes(c):
        return sum(a.numel() * a.element_size() for key, a in c.items()
                   if key in engine.PAGED_SEQ_KEYS)
    bf16 = dataclasses.replace(cfg, kv_quant=False, param_dtype="bfloat16")
    q16 = dataclasses.replace(bf16, kv_quant=True)
    n8 = nbytes(engine.init_cache(q16, 4, 128, "meta"))
    n16 = nbytes(engine.init_cache(bf16, 4, 128, "meta"))
    assert n8 < 0.6 * n16, (n8, n16)


def test_encdec_and_vlm_ignore_kv_quant():
    """The encdec and vlm families keep their cache in the model's dtype
    whatever ``kv_quant`` says, as the reference's ``init_cache`` does; the
    adapter's explicit kernel requests are still refused for the layout."""
    from repro_torch import configs
    for arch in ("whisper_medium", "llama32_vision_90b"):
        cfg = dataclasses.replace(configs.smoke_config(arch), kv_quant=True)
        cache = engine.init_cache(cfg, 1, 8, "meta")
        assert cache["k"].dtype == cfg.dtype and "k_scale" not in cache
        assert set(engine.init_paged_arena(cfg, 3, 4, "meta")) == {"k", "v"}


def _trace(mod):
    fleet = dict(n_endpoints=6, prompt_fraction=0.3, frame_rate_hz=6.0,
                 seed=5, image_pool=8)
    return mod.SensorFleet(mod.FleetConfig(**fleet)).events(0.5)


@pytest.mark.parametrize("paged", [False, True])
def test_int8_gateway_matches_reference(paged):
    """``make_gateway`` over the int8 layout (the default dense slots, and
    paged, where the reference resolves the tick to XLA and admits
    one-shot) on a seeded trace, against the reference's: per request the
    generated tokens, energy, link bytes, output and KV blocks equal."""
    jcfg, jparams, cfg, params = smoke_pair(kv_quant=True)
    trace, jtrace = _trace(sensors), _trace(jsensors)
    assert sum(a.kind == "prompt" for a in trace) >= 3
    kw = dict(n_slots=2, max_len=32, max_new_tokens=5, paged=paged)
    if paged:
        kw["block_size"] = BS
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw), device="cpu")
    jgw = jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(**kw))
    ad = gw.batcher.adapter
    assert ad.cache["k"].dtype == torch.int8 if not paged else \
        ad.arena["k"].dtype == torch.int8 and not ad.chunked
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
        assert (r.energy_nj, r.link_bytes, r.output, r.tokens_out,
                r.kv_blocks) == (j.energy_nj, j.link_bytes, j.output,
                                 j.tokens_out, j.kv_blocks)
    if paged:
        for key in ("prefill_tokens_total", "blocks_in_use", "cow_copies"):
            assert tel.pool[key] == jtel.pool[key], key
