"""The port's rwkv family served against the reference (rwkv6-7b's smoke
size, float32, the reference's weights): ``tests/test_scheduler.py``'s
loads through ``RwkvContinuousBatcher`` with the reference batcher's tokens
and the port's own dedicated decoding; ``tests/test_gateway.py``'s slot
isolation, freed slots bitwise zero and EOS on the prefill token; the
state adapter step by step against the reference's (tokens, logits within
2e-4, the state within 1e-5 of its scale); ``PromptGateway`` records field for field
under fake clocks; ``make_gateway``'s and ``make_adapter``'s rwkv rules;
the refusals (a prompt the one-shot chunks do not divide, the paged arena,
the fold, the paged tick); the captured tick's keys and the cost model's
analytic stages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as jengine
from repro.serve import scheduler as jscheduler
from repro.serve import spec as jspec
from repro.serve.gateway import gateway as jgateway
from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro.serve.obs import tracer as jtracer
from repro_torch.serve import engine, obs, scheduler, spec
from repro_torch.serve.gateway import gateway, sensors, slots
from repro_torch.serve.kvcache import paged
from repro_torch.serve.obs import tracer
from test_torch_lm import smoke_pair
from test_torch_obs import fake_clock

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

ARCH = "rwkv6_7b"
KEYS = ("wkv", "shift1", "shift2")
LOGITS, STATE = 2e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(arch=ARCH)


def _load(cfg, sizes, seed, n_new):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab, size=s).astype(np.int32), n_new)
            for i, s in enumerate(sizes)]


def _run(batcher_cls, Request, cfg, params, n_slots, load):
    b = batcher_cls(cfg, params, n_slots=n_slots)
    for uid, prompt, n_new in load:
        b.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n_new))
    return b, {r.uid: list(map(int, r.generated)) for r in b.run()}


def _dedicated(cfg, params, prompt, n_new):
    """The port's single-request greedy decode: prefill at B=1, then
    ``n_new - 1`` dense ticks, argmax each."""
    cache, logits = engine.prefill(cfg, params, _t(prompt[None]))
    toks = [int(logits[0].argmax())]
    for _ in range(n_new - 1):
        cache, logits = engine.decode_step(cfg, params, cache,
                                           _t([[toks[-1]]]))
        toks.append(int(logits[0].argmax()))
    return toks


def test_continuous_batching_matches_reference_and_dedicated(pair):
    """``tests/test_scheduler.py::test_continuous_batching_matches_
    dedicated_decode`` on the port: five prompts (5-12 tokens, 6 new
    tokens each) through two slots, tokens equal to the reference
    batcher's and to dedicated decoding of each prompt alone."""
    jcfg, jparams, cfg, params = pair
    load = _load(cfg, (5, 9, 7, 12, 6), 0, 6)
    b, got = _run(scheduler.RwkvContinuousBatcher, scheduler.Request, cfg,
                  params, 2, load)
    _, want = _run(jscheduler.RwkvContinuousBatcher, jscheduler.Request,
                   jcfg, jparams, 2, load)
    assert type(b.adapter) is slots.StateSlotAdapter
    assert b.adapter.max_len is None and b.peak_active == 2
    assert got == want and len(got) == 5
    for uid, prompt, n_new in load:
        assert got[uid] == _dedicated(cfg, params, prompt, n_new), uid


def test_slots_are_isolated(pair):
    """``tests/test_scheduler.py::test_slots_are_isolated``: a short
    request gives the same tokens alone and beside a long one, and the
    reference's."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    a = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
    b = rng.integers(0, cfg.vocab, size=15).astype(np.int32)
    _, solo = _run(scheduler.RwkvContinuousBatcher, scheduler.Request, cfg,
                   params, 1, [(0, a, 5)])
    _, both = _run(scheduler.RwkvContinuousBatcher, scheduler.Request, cfg,
                   params, 2, [(0, a, 5), (1, b, 9)])
    _, jboth = _run(jscheduler.RwkvContinuousBatcher, jscheduler.Request,
                    jcfg, jparams, 2, [(0, a, 5), (1, b, 9)])
    assert both[0] == solo[0] and both == jboth


def test_freed_slots_are_zero_and_eos_on_the_prefill_token(pair):
    """``tests/test_gateway.py``: after draining, every slot's state is
    bitwise zero (a freed slot does not decode stale state); a request
    whose prefill token is its EOS retires with that one token."""
    _, _, cfg, params = pair
    rng = np.random.default_rng(1)
    batcher = slots.ContinuousBatcher(slots.make_adapter(cfg, params,
                                                         n_slots=2))
    batcher.submit(slots.Request(uid=0, prompt=rng.integers(
        0, cfg.vocab, size=6, dtype=np.int32), max_new_tokens=4))
    batcher.run()
    assert set(batcher.adapter.state) == {"len", *KEYS}
    for key, a in batcher.adapter.state.items():
        assert not a.any(), key
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=6,
                                               dtype=np.int32)
    probe = slots.ContinuousBatcher(slots.make_adapter(cfg, params,
                                                       n_slots=1))
    probe.submit(slots.Request(uid=0, prompt=prompt, max_new_tokens=1))
    first = probe.run()[0].generated[0]
    eos = slots.ContinuousBatcher(slots.make_adapter(cfg, params, n_slots=1))
    eos.submit(slots.Request(uid=1, prompt=prompt, max_new_tokens=8,
                             eos_id=first))
    assert eos.run()[0].generated == [first]
    assert not any(eos.adapter.state[key].any() for key in KEYS)


def test_state_adapter_matches_reference(pair):
    """The state slots against the reference's, three slots: admit two
    prompts (16 and 7 tokens), tick with the third lane idle, admit a
    third prompt, tick, clear slot 0, tick with it inactive, reuse it.
    Every step: tokens equal, every lane's logits within 2e-4 (the port's
    ``last_logits`` a copy that the next tick leaves as it is), the shift
    rows within 1e-5 and the wkv state within 1e-5 of its largest
    magnitude, a cleared slot bitwise zero and an inactive slot's state bit
    for bit as it was."""
    jcfg, jparams, cfg, params = pair
    ad = slots.make_adapter(cfg, params, n_slots=3, paged=True)
    jad = jslots.make_adapter(jcfg, jparams, n_slots=3, paged=True)
    assert type(ad).__name__ == type(jad).__name__ == "StateSlotAdapter"
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, s).astype(np.int32)
               for s in (16, 7, 12, 5)]

    def same_state():
        # the wkv state sums k v^T over the context (up to ~18 here), so
        # it is held within 1e-5 of its own scale; the shift rows within
        # 1e-5
        for key in KEYS:
            want = np.asarray(jad.state[key])
            tol = STATE * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(ad.state[key].numpy(), want,
                                       rtol=STATE, atol=tol)

    def tick(active):
        toks = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        before = {k: a.clone() for k, a in ad.state.items()}
        got = ad.decode(toks, active)
        jlogits = jad._decode(jad.params, jad.state,
                              jnp.asarray(toks)[:, None],
                              jnp.asarray(active))[1]
        want = jad.decode(toks, active)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(ad.last_logits.numpy(),
                                   np.asarray(jlogits), rtol=LOGITS,
                                   atol=LOGITS)
        idle = torch.from_numpy(~active)
        for key in KEYS:
            assert torch.equal(ad.state[key][:, idle], before[key][:, idle])
        # each active lane's length advances by one, an idle lane's stays
        assert torch.equal(ad.state["len"],
                           before["len"] + torch.from_numpy(active).int())
        same_state()
        return ad.last_logits
    for slot in (0, 1):
        assert ad.insert(slot, prompts[slot]) == \
            jad.insert(slot, prompts[slot])
    assert ad.state["len"].tolist() == [16, 7, 0]
    same_state()
    kept = tick(np.array([True, True, False]))
    copy = kept.clone()
    assert ad.insert(2, prompts[2]) == jad.insert(2, prompts[2])
    tick(np.ones(3, bool))
    assert torch.equal(kept, copy)
    ad.clear(0)
    jad.clear(0)
    for key in KEYS:
        assert not ad.state[key][:, 0].any()
    assert int(ad.state["len"][0]) == 0
    tick(np.array([False, True, True]))
    assert ad.insert(0, prompts[3]) == jad.insert(0, prompts[3])
    tick(np.ones(3, bool))


def test_bf16_tick_is_batch_invariant_on_the_cpu():
    """In bf16 on the CPU, one tick of eight lanes and each lane's tick
    alone at B = 1, from the same prefill state, give the same greedy
    tokens and logits within 2e-6 (about 8 float32 ulps at |logit| < 4),
    in the reference and in the port (each against itself): neither
    package's arithmetic depends on the batch.  (On the card a batched
    matrix product over the B x H heads would: ``nn/ssm.py``
    ``wkv6_step``.)"""
    jcfg, jparams, cfg, params = smoke_pair("bfloat16", arch=ARCH)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (8, 16)
                                             ).astype(np.int32)
    feed = np.random.default_rng(6).integers(0, cfg.vocab, (8, 1)
                                             ).astype(np.int32)
    jcache, _ = jax.jit(jengine.prefill, static_argnums=0)(
        jcfg, jparams, {"tokens": jnp.asarray(toks)})
    jstep = jax.jit(jengine.decode_step, static_argnums=0)
    cache, _ = engine.prefill(cfg, params, _t(toks))

    def lane(c, s):
        return {k: a[:, s:s + 1] if a.ndim > 1 else a for k, a in c.items()}
    want8 = np.asarray(jstep(jcfg, jparams, jcache, jnp.asarray(feed))[1])
    got8 = engine.decode_step(cfg, params, {k: a.clone() for k, a in
                                            cache.items()}, _t(feed))[1]
    for s in range(8):
        want1 = np.asarray(jstep(jcfg, jparams, lane(jcache, s),
                                 jnp.asarray(feed[s:s + 1]))[1])
        one = {k: a.clone() for k, a in lane(cache, s).items()}
        got1 = engine.decode_step(cfg, params, one, _t(feed[s:s + 1]))[1]
        np.testing.assert_allclose(want1[0], want8[s], rtol=0, atol=2e-6)
        np.testing.assert_allclose(got1[0].numpy(), got8[s].numpy(),
                                   rtol=0, atol=2e-6)
        assert want1[0].argmax() == want8[s].argmax()
        assert int(got1[0].argmax()) == int(got8[s].argmax())


def test_prompt_gateway_records_match_reference(pair):
    """``tests/test_gateway.py::test_prompt_gateway_serves_lm_path`` on
    both packages under fake clocks (``test_torch_obs.fake_clock``): five
    8-token prompts through two state slots behind ``PromptGateway``;
    every record equal to the reference's field for field, the tokens
    equal, no pool."""
    jcfg, jparams, cfg, params = pair
    runs = {}
    for name, pkg, gw_mod, tr_mod, sens, c, p in (
            ("port", slots, gateway, tracer, sensors, cfg, params),
            ("ref", jslots, jgateway, jtracer, jsensors, jcfg, jparams)):
        rng = np.random.default_rng(3)
        arrivals = [sens.Arrival(uid=i, t=0.01 * i, endpoint=i,
                                 kind="prompt",
                                 payload=rng.integers(0, cfg.vocab, size=8,
                                                      dtype=np.int32))
                    for i in range(5)]
        pgw = gw_mod.PromptGateway(pkg.ContinuousBatcher(
            pkg.make_adapter(c, p, n_slots=2)), max_new_tokens=4)
        pgw.warmup((8,), cfg.vocab)
        p1, p2 = fake_clock(gw_mod, tr_mod)
        with p1, p2:
            tel = pgw.run(arrivals)
        tel.assert_conserved()
        runs[name] = tel
    tel, jtel = runs["port"], runs["ref"]
    assert len(tel.records) == len(jtel.records) == 5
    for r, j in zip(tel.records, jtel.records):
        assert dataclasses.asdict(r) == dataclasses.asdict(j)
    assert tel.dropped == jtel.dropped and tel.pool == jtel.pool == {}
    assert tel.report(1.0, kind="prompt") == jtel.report(1.0, kind="prompt")


def test_make_gateway_and_make_adapter_rwkv_rules(pair):
    """``ServeSpec(paged=True)`` (and the default) serves state slots,
    as the reference's does; ``backend`` raises ``ValueError`` for the
    family in both packages, ``mesh`` too (never
    ``NotImplementedError``: the reference will not shard it either);
    ``make_adapter`` refuses a backend and ``extras``, and the KV slots
    refuse the family."""
    jcfg, jparams, cfg, params = pair
    for kw in (dict(paged=True), dict()):
        gw = spec.make_gateway(cfg, params, spec.ServeSpec(**kw),
                               device="cpu")
        jgw = jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(**kw))
        assert type(gw.batcher.adapter) is slots.StateSlotAdapter
        assert type(jgw.batcher.adapter).__name__ == "StateSlotAdapter"
    for kw in (dict(paged=True, backend="plain"),
               dict(paged=True, mesh=object())):
        with pytest.raises(ValueError, match="rwkv"):
            spec.make_gateway(cfg, params, spec.ServeSpec(**kw),
                              device="cpu")
    with pytest.raises(ValueError, match="rwkv"):
        jspec.make_gateway(jcfg, jparams,
                           jspec.ServeSpec(paged=True, backend="xla"))
    with pytest.raises(ValueError, match="rwkv"):
        slots.make_adapter(cfg, params, 2, paged=True, backend="cuda")
    with pytest.raises(ValueError, match="extras"):
        slots.make_adapter(cfg, params, 2, extras=lambda: {})
    with pytest.raises(ValueError, match="StateSlotAdapter"):
        slots.KVSlotAdapter(cfg, params, 2, 16)
    with pytest.raises(ValueError, match="rwkv"):
        paged.PagedKVSlotAdapter(cfg, params, 2, 16)


@pytest.mark.parametrize("what", ["length", "paged_arena", "fold",
                                  "paged_tick"])
def test_refusals(pair, what):
    """What the reference asserts, the port raises as ``ValueError``: a
    one-shot prompt of 20 tokens (chunks of 16 do not divide it; the
    reference's ``wkv6_chunked`` asserts, and the adapter's state is left
    as it was), the paged arena and the fold ("nothing to page"), the
    paged tick."""
    jcfg, jparams, cfg, params = pair
    if what == "length":
        prompt = np.arange(20, dtype=np.int32)
        ad = slots.make_adapter(cfg, params, n_slots=2)
        ad.insert(1, prompt[:16])
        before = {k: a.clone() for k, a in ad.state.items()}
        with pytest.raises(ValueError, match="chunk"):
            ad.insert(0, prompt)
        assert all(torch.equal(ad.state[k], before[k]) for k in KEYS)
        with pytest.raises(AssertionError):
            jengine.prefill(jcfg, jparams, {"tokens": jnp.asarray(
                prompt[None])})
        return
    with pytest.raises(ValueError, match="nothing to page"):
        if what == "paged_arena":
            engine.init_paged_arena(cfg, 8, 4, "cpu")
        elif what == "fold":
            engine.prefill_chunked(cfg, params, _t(np.zeros((1, 4), np.int32)),
                                   engine.init_cache(cfg, 1, 0, "cpu"), 0)
        else:
            engine.decode_step_paged(
                cfg, params, _t(np.zeros((2, 1), np.int32)),
                tables=_t(np.ones((2, 2), np.int32)),
                lens=_t(np.zeros(2, np.int32)), arena={})
    if what == "paged_arena":
        from repro.serve.kvcache import PagedKVSlotAdapter
        with pytest.raises(AssertionError, match="nothing to page"):
            PagedKVSlotAdapter(jcfg, jparams, 2, 16)


def test_captured_keys_and_cost_model(pair):
    """One captured tick (``jit_fns()`` the reference's names less
    ``paged.NOT_CAPTURED``), captured once over a load whatever the mix
    of lanes; the tick's ``fn`` on its static inputs gives the step's
    logits; the cost model's stages analytic."""
    jcfg, jparams, cfg, params = pair
    ad = slots.make_adapter(cfg, params, n_slots=2)
    jad = jslots.make_adapter(jcfg, jparams, n_slots=2)
    ours, theirs = set(ad.jit_fns()), set(jad.jit_fns())
    assert ours == {"decode"}
    assert theirs - ours == {"prefill"} <= set(paged.NOT_CAPTURED)
    b = slots.ContinuousBatcher(ad)
    for uid, prompt, n_new in _load(cfg, (5, 9, 3), 2, 3):
        b.submit(slots.Request(uid=uid, prompt=prompt, max_new_tokens=n_new))
    b.run()
    assert ad.jit_fns()["decode"]._cache_size() == 1
    step, inputs, _ = ad._tick_inputs(np.array([3, 4], np.int32),
                                      np.array([True, False]))
    start = {k: a.clone() for k, a in ad.state.items()}
    logits = step(*inputs).clone()
    for k, a in ad.state.items():
        a.copy_(start[k])
    assert torch.equal(step.fn(*step.load(*inputs)), logits)
    stages = obs.attribute(ad.cost_args())["stages"]
    for name in ("prefill", "decode"):
        assert stages[name]["source"] == "analytic", name
        assert stages[name]["flops"] > 0 and stages[name]["bytes"] > 0
