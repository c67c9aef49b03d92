"""The port's vlm family (llama-3.2-vision-90b's smoke size, float32, the
reference's weights, every ``gate_attn`` at ``VLM_GATE`` = 0.5 on both
sides, the reference tests' patch embeddings as ``extras``) served
against the reference: the paged ``"plain"`` tick against the reference's
``"xla"`` tick on the same arena (the port's flat arena mapped onto the
reference's grouped one); the in-place tick bit for bit its ``"gather"``
oracle (``tests/test_paged_decode.py:162`` on the port) and the dense
adapter's tick; the backends the reference refuses refused with "vlm",
auto-selection giving ``"plain"`` and ``chunked=True`` admitting
one-shot, as the reference's do; a
scripted one-shot load with radix sharing, a copy-on-write and lanes at
capacity (tokens, tables, pool statistics, blocks and the lanes' vision
K/V equal); ``make_gateway`` over dense and paged slots giving the
reference gateway's tokens; the cost model's vlm stages analytic.
The family-agnostic serving tests of ``test_torch_dense`` and
``test_torch_paged`` run here on the vlm pair."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dense as dense_tests
import test_torch_paged as paged_tests
from repro.serve import engine as jengine
from repro.serve.gateway import slots as jslots
from repro_torch.serve import engine, spec
from repro_torch.serve import obs
from repro_torch.serve.gateway import slots
from test_torch_lm import extras_pair, vlm_pair
from test_torch_vlm import flat, grouped

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pair():
    return vlm_pair()


def _ref_arena(cfg, arena_np):
    """The reference's grouped arena from the port's flat one: k / v (G,
    k - 1, num_blocks, 1, bs, Hkv, Dh) and kx_self / vx_self (G,
    num_blocks, 1, bs, Hkv, Dh)."""
    out = {}
    for key, xkey in (("k", "kx_self"), ("v", "vx_self")):
        out[key], out[xkey] = (jnp.asarray(a) for a in
                               grouped(cfg, arena_np[key]))
    return out


def _ref_flat(cfg, jarena):
    """The reference's grouped arena (or one block of it) as the port's
    flat layer-ordered arrays, by key."""
    return {key: flat(jarena[key], jarena[xkey])
            for key, xkey in (("k", "kx_self"), ("v", "vx_self"))}


def test_paged_tick_matches_reference(pair):
    """``engine.decode_step_paged`` (``"plain"``) with the lanes' vision
    K/V against the reference's ``"xla"`` tick on the same arena: logits
    within 2e-4, tokens equal, the rows written within 1e-5 under the
    index map, every other row and the vision K/V untouched; the kernels'
    backends and a missing state refused."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(6)
    L, Hkv, D, G = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.n_cross
    nb, S = 6, 3
    num_blocks = S * nb + 1
    arena_np = {k: rng.normal(0, 1, (L, num_blocks, 1, BS, Hkv, D)
                              ).astype(np.float32) for k in ("k", "v")}
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(
        S, nb).astype(np.int32)
    lens = np.array([5, 20, 9], np.int32)
    st = {k: rng.normal(0, 1, (G, S, cfg.n_vision_tokens, Hkv, D)
                        ).astype(np.float32) for k in ("xk", "xv")}
    tokens = rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32)
    wbids = np.array([tables[0, 1], tables[1, 5], tables[2, 2]], np.int32)
    arena = {k: _t(v.copy()) for k, v in arena_np.items()}
    state = {k: _t(v.copy()) for k, v in st.items()}
    logits = engine.decode_step_paged(
        cfg, params, _t(tokens), tables=_t(tables), lens=_t(lens),
        arena=arena, wbids=_t(wbids), state=state)
    jst = {k: jnp.asarray(np.moveaxis(v, 1, 0))[:, :, None]
           for k, v in st.items()}
    jarena, _, jlogits = jengine.decode_step_paged(
        jcfg, jparams, {"len": jnp.asarray(lens), **jst},
        jnp.asarray(tokens), tables=jnp.asarray(tables),
        lens=jnp.asarray(lens), arena=_ref_arena(cfg, arena_np),
        wbids=jnp.asarray(wbids), backend="xla")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    want = _ref_flat(cfg, {k: np.asarray(a) for k, a in jarena.items()})
    for key in ("k", "v"):
        got = arena[key].numpy()
        written = np.zeros(got.shape[:4], bool)
        written[:, wbids, 0, lens % BS] = True
        np.testing.assert_array_equal(got[~written], arena_np[key][~written])
        np.testing.assert_allclose(got, want[key], rtol=1e-5, atol=1e-5)
    for key in ("xk", "xv"):
        np.testing.assert_array_equal(state[key].numpy(), st[key])
    for backend in ("cuda", "cascade"):
        with pytest.raises(ValueError, match="vlm"):
            engine.decode_step_paged(
                cfg, params, _t(tokens), tables=_t(tables), lens=_t(lens),
                arena=arena, backend=backend, state=state)
    with pytest.raises(ValueError, match="state"):
        engine.decode_step_paged(cfg, params, _t(tokens), tables=_t(tables),
                                 lens=_t(lens), arena=arena)


def test_inplace_tick_bitwise_vs_gather(pair):
    """``tests/test_paged_decode.py::test_vlm_inplace_matches_gather_tick_
    bitwise`` on the port: the in-place ``"plain"`` tick gives the gather
    tick's tokens, logits, chain blocks and lanes' vision K/V bit for bit,
    every step, with a lane left inactive for two steps."""
    dense_tests.test_gather_tick_bitwise_vs_inplace_plain(pair, False)


def test_dense_adapter_bitwise_vs_inplace_plain(pair):
    """The dense adapter's tick and the paged ``"plain"`` tick: tokens,
    logits and the lanes' vision K/V bit for bit."""
    dense_tests.test_dense_adapter_bitwise_vs_inplace_plain(pair)


def test_backends_and_admission_follow_the_reference(pair):
    """An explicit ``"cuda"`` or ``"cascade"`` raises naming "vlm" (the
    reference's explicit ``"pallas"`` / ``"cascade"`` raise too); the
    automatic choice is ``"plain"`` (the reference's ``"xla"``), also for
    the default gateway spec; ``chunked=True`` admits one-shot, as the
    reference's does: no fold chunk, the first token and the prompt's
    blocks bit for bit those of a ``chunked=False`` adapter."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    kw = dict(n_slots=2, max_len=16, paged=True, block_size=BS)
    for backend in ("cuda", "cascade"):
        with pytest.raises(ValueError, match="vlm"):
            slots.make_adapter(cfg, params, extras=px, backend=backend,
                               **kw)
        with pytest.raises(ValueError, match="vlm"):
            spec.make_gateway(cfg, params, spec.ServeSpec(
                backend=backend, **kw), extras=px, device="cpu")
    for backend in ("pallas", "cascade"):
        with pytest.raises(ValueError, match="vlm"):
            jslots.make_adapter(jcfg, jparams, extras=jx, backend=backend,
                                **kw)
    jad = jslots.make_adapter(jcfg, jparams, extras=jx, **kw)
    assert jad.backend == "xla" and not jad.chunked
    ads = {chunked: slots.make_adapter(cfg, params, extras=px,
                                       chunked=chunked, **kw)
           for chunked in (True, False)}
    gw = spec.make_gateway(cfg, params, spec.ServeSpec(paged=True),
                           extras=px, device="cpu")
    assert gw.batcher.adapter.backend == "plain"
    assert not gw.batcher.adapter.chunked
    prompt = np.arange(10, dtype=np.int32) * 7
    toks = {c: ad.insert(0, prompt, max_new=4) for c, ad in ads.items()}
    assert toks[True] == toks[False] == jad.insert(0, prompt, max_new=4)
    for c, ad in ads.items():
        assert ad.backend == "plain" and not ad.chunked
        assert ad.prefill_chunks_total == 0
    a, b = (dense_tests._chain_blocks(ads[c], 0) for c in (True, False))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


def test_adapter_sharing_cow_and_capacity_match_reference(pair):
    """``tests/test_torch_paged.py``'s scripted one-shot load: slot 0 and
    slot 2 admit the same 10-token prompt (two full-block hits plus the
    shared partial block, so both copy on their first write), slot 1
    shares the two full blocks only; forced tokens then run every lane to
    capacity.  Tokens, tables, lens, slot and pool statistics equal to the
    reference's, logits within 2e-4, every block a live lane reads within
    1e-5 of the reference's grouped block under the index map."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    kw = dict(n_slots=3, max_len=16, paged=True, block_size=BS,
              chunked=False)
    ref = jslots.make_adapter(jcfg, jparams, extras=jx, backend="xla", **kw)
    port = slots.make_adapter(cfg, params, extras=px, **kw)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 512, 10).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 512, 3)]).astype(np.int32)
    for slot, prompt, max_new in ((0, a, 6), (2, a, 6), (1, b, 5)):
        assert port.insert(slot, prompt, max_new) == \
            ref.insert(slot, prompt, max_new)
        paged_tests._same_state(ref, port)
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
        paged_tests._same_state(ref, port)
        for s in live:
            for bid in port.slot_bids[s]:
                want = _ref_flat(cfg, {
                    key: np.asarray(ref.arena_block(key, bid))
                    for key in ref.seq_keys})
                for key in ("k", "v"):
                    np.testing.assert_allclose(
                        port.arena_block(key, bid).numpy(), want[key],
                        rtol=1e-5, atol=1e-5)
    assert all(port.at_capacity(s) for s in range(3))
    assert port.pool_stats()["cow_copies"] == 2
    for s in range(3):
        port.clear(s)
        ref.clear(s)
        paged_tests._same_state(ref, port)


@pytest.mark.parametrize("paged", [False, True])
def test_prompt_gateway_matches_reference(pair, paged):
    """``make_gateway`` over dense slots (the default ``ServeSpec``) and
    over one-shot paged slots on a seeded trace: per request the
    reference gateway's generated tokens, energy, link bytes, output and
    arrival (and, paged, KV blocks and prefill tokens)."""
    if paged:
        paged_tests.test_prompt_gateway_matches_reference(pair)
    else:
        dense_tests.test_default_gateway_matches_reference(pair)


@pytest.mark.parametrize("paged", [False, True])
def test_cost_model_reports_vlm_stages_analytic(pair, paged):
    """The vlm adapters' prefill and decode stages are counted
    (``"analytic"``, memory-bound at the reference's ridge on a tick);
    the copy-on-write copy of the flat arena's L layers counts its
    bytes."""
    _, _, cfg, params = pair
    _, px = extras_pair(cfg)
    ad = slots.make_adapter(cfg, params, n_slots=2, max_len=16, extras=px,
                            paged=paged, block_size=BS)
    stages = obs.attribute(ad.cost_args())["stages"]
    for name in ("prefill", "decode"):
        assert stages[name]["source"] == "analytic", name
        assert stages[name]["flops"] > 0 and stages[name]["bytes"] > 0
    if paged:
        assert stages["copy"]["source"] == "bytes-only"
        assert stages["copy"]["bytes"] == \
            2 * cfg.n_layers * BS * 2 * cfg.n_kv_heads * cfg.d_head * 4
