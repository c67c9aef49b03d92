"""Sharded serving's model axis in the port (tensor parallelism within a
serving slice) against the reference on the CPU.

The reference shards a slice's paged arena over its sub-mesh's
``"model"`` axis with ``engine.arena_specs`` (KV heads when they divide,
else the block-size axis: the split-KV fallback) and lets GSPMD partition
the tick; its pin is ``tests/test_sharded.py::
test_model_axis_sharded_slice_decodes`` (tokens equal to the unsharded
adapter, logits within 1e-5, not bitwise: ``docs/sharding.md``).  The
port's slices of m devices repeat ``"cpu"`` here; the reference side is
its unsharded adapter (its forced multi-device mesh is not available in
one process).  At the smoke configs in float32, with the reference's
weights:

- the specs (``cache_specs``, ``arena_specs``) equal the reference's for
  every family and the int8 layout, the vlm family's flat k / v taking
  the spec of the reference's grouped ``k`` and ``kx_self``; the spec
  helpers equal the reference's on ``tests/test_dist.py``'s cases;
- a model-2 slice of every paged family and the int8 layout gives the
  reference's unsharded tokens with logits within 1e-5, through the plain
  tick and the plain versions of the ``"cuda"`` and cascade ticks and the
  chunked fold (the reference's prompts one-shot: its compiles are most of
  this file's time); so does the split-KV fallback (model 4 over the
  hybrid smoke config's 2 KV heads, its windowed layers masking);
- a model-2 slice is bit for bit the port's unsharded adapter (logits,
  arena blocks, lane state) where the heads divide;
- ``migrate_slot`` moves a live request between slices of widths 1, 2
  and 4, and ``make_disagg_meshes(prefill_model=2)`` serves through
  ``build_slices``, each against the stay-put oracle."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as jshd
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.gateway import slots as jslots
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import slice_meshes
from repro_torch.launch.mesh import make_disagg_meshes, make_serving_mesh
from repro_torch.serve import engine, shard
from repro_torch.serve.gateway import slots
from test_torch_lm import VLM_GATE, extras_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")
BS = 4
TOL = 1e-5          # the reference's model-axis logits tolerance
MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 4}]
# the paged families and the int8 layout, with the backends each takes
# (the vlm tick and the int8 layout's are "plain" only, as the reference's
# are XLA only)
FAMILIES = {"decoder": "stablelm_3b", "moe": "deepseek_moe_16b",
            "hybrid": "hymba_1_5b", "encdec": "whisper_medium",
            "vlm": "llama32_vision_90b", "int8": "stablelm_3b"}
CASES = [(f, b) for f in FAMILIES
         for b in (("plain",) if f in ("vlm", "int8")
                   else ("plain", "cuda", "cascade"))]


# ==========================================================================
# Specs.
# ==========================================================================

def _cfgs(arch, quant=False):
    kw = dict(kv_quant=True) if quant else {}
    return (dataclasses.replace(jconfigs.smoke_config(arch), **kw),
            dataclasses.replace(configs.smoke_config(arch), **kw))


def _ref_spec(key, spec, family):
    """The reference's spec at the port's rank: the vlm family's grouped
    ``k`` / ``v`` lose their leading group axis; everything else as it
    is."""
    sp = tuple(spec)
    return sp[1:] if family == "vlm" and key in ("k", "v") else sp


@pytest.mark.parametrize("ms", MESHES, ids=["data2-model2", "model4"])
@pytest.mark.parametrize("arch,quant", [
    ("stablelm_3b", False), ("stablelm_3b", True), ("deepseek_moe_16b",
                                                     False),
    ("hymba_1_5b", False), ("hymba_1_5b", True), ("whisper_medium", False),
    ("llama32_vision_90b", False), ("rwkv6_7b", False)])
def test_cache_and_arena_specs_match_reference(arch, quant, ms):
    """``cache_specs`` and ``arena_specs`` equal the reference's key for
    key (the vlm family's k / v against its grouped ``k`` and its
    ``kx_self`` alike, which the port's flat arena holds as layers), with
    the arena's rank and an unsharded block axis (the cases of
    ``test_sharded.py::test_arena_specs_match_layout``); an arena split by
    them holds each shard's range."""
    jcfg, cfg = _cfgs(arch, quant)
    fam = cfg.family
    for batch in (1, 4):
        want = jengine.cache_specs(jcfg, ms, batch)
        got = engine.cache_specs(cfg, ms, batch)
        mapped = {k for k in want if k not in ("kx_self", "vx_self")}
        assert set(got) == mapped, (arch, set(got), set(want))
        for key, sp in got.items():
            assert isinstance(sp, shd.P)
            assert tuple(sp) == _ref_spec(key, want[key], fam), (arch, key)
        if fam == "vlm":
            assert tuple(got["k"]) == tuple(want["kx_self"])
    if fam == "rwkv":
        with pytest.raises(ValueError, match="rwkv"):
            engine.arena_specs(cfg, ms)
        return
    want = jengine.arena_specs(jcfg, ms)
    got = engine.arena_specs(cfg, ms)
    arena = engine.init_paged_arena(cfg, 3, BS, "meta")
    assert set(got) == set(arena) == \
        {k for k in want if k not in ("kx_self", "vx_self")}
    for key, a in arena.items():
        sp = tuple(got[key])
        assert sp == _ref_spec(key, want[key], fam), (arch, key)
        assert len(sp) == a.dim() and sp[engine.arena_block_axis(a)] is None
        heads = "model" if cfg.n_kv_heads % ms["model"] == 0 else None
        assert sp[-2] == heads and sp[-3] == (None if heads else "model")
    m = ms["model"]
    shards = engine.shard_arena(arena, got, [CPU] * m)
    ax = -2 if cfg.n_kv_heads % m == 0 else -3
    size = arena["k"].shape[ax]
    for d, sh in enumerate(shards):
        held = sh.heads if ax == -2 else sh.positions
        assert held == (d * size // m, (d + 1) * size // m)
        for key, a in sh.arrays.items():
            want_shape = list(arena[key].shape)
            want_shape[ax] //= m
            assert list(a.shape) == want_shape and a.device == CPU


def test_spec_helpers_match_reference():
    """``dp_axes``, ``dp_size``, ``axis_if_divisible`` and
    ``batch_spec_axis`` on ``tests/test_dist.py``'s cases and more, and
    ``P`` a tuple of its entries."""
    for ms in ({"data": 4, "model": 2}, {"pod": 2, "data": 4, "model": 2},
               {"data": 1, "model": 4}, {"model": 8}, {"data": 3}):
        assert shd.dp_axes(ms) == jshd.dp_axes(ms)
        assert shd.dp_size(ms) == jshd.dp_size(ms)
        for batch in (1, 2, 3, 4, 8, 16, 24):
            assert shd.batch_spec_axis(ms, batch) == \
                jshd.batch_spec_axis(ms, batch), (ms, batch)
        for size in (1, 2, 5, 25, 32):
            assert shd.axis_if_divisible("model", size, ms) == \
                jshd.axis_if_divisible("model", size, ms)
    assert shd.batch_spec_axis({"data": 4, "model": 2}, 8) == "data"
    assert shd.batch_spec_axis({"pod": 2, "data": 4, "model": 2}, 16) == \
        ("pod", "data")
    assert shd.axis_if_divisible("model", 25, {"model": 16}) is None
    assert shd.P() == () and shd.P(None, "model") == (None, "model")


# ==========================================================================
# A model-m slice against the reference's unsharded adapter.
# ==========================================================================

# the split-KV fallback's config: the hybrid smoke config (2 KV heads,
# window on its odd layers) at window 6, short of its contexts
WINDOWED = "hybrid-window6"


@functools.lru_cache(maxsize=None)
def _pair(family):
    """(reference cfg, reference params, port cfg, port params) at the
    family's float32 smoke config, the reference's weights carried over
    (``test_torch_lm.smoke_pair``, its ``init`` jitted: a third of the
    eager init's time); the int8 layout and the fallback's window reuse
    their family's weights."""
    if family in ("int8", WINDOWED):
        jcfg, jparams, cfg, params = _pair("decoder" if family == "int8"
                                           else "hybrid")
        kw = dict(kv_quant=True) if family == "int8" else dict(window=6)
        return (dataclasses.replace(jcfg, **kw), jparams,
                dataclasses.replace(cfg, **kw), params)
    arch = FAMILIES[family]
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32")
    jparams = jax.jit(lambda key: jlm.init(key, jcfg, {})[0])(
        jax.random.key(0))
    if family == "vlm":
        g = jparams["cross_blocks"]["gate_attn"]
        jparams["cross_blocks"]["gate_attn"] = jnp.full_like(g, VLM_GATE)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, lens, seed=81):
    """Prompts of ``lens`` tokens sharing their first block, so the
    cascade tick groups them."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=BS)
    return [np.concatenate([head, rng.integers(0, cfg.vocab, size=n - BS)]
                           ).astype(np.int32) for n in lens]


def _drive(ad, cfg, lens, ticks, max_new, seed=81):
    """Admit one prompt per slot, then ``ticks`` forced ticks; returns the
    first tokens, each tick's tokens and logits (numpy)."""
    rng = np.random.default_rng(seed + 1)
    first = [int(ad.insert(s, p, max_new=max_new))
             for s, p in enumerate(_prompts(cfg, lens, seed))]
    toks, logits = [], []
    active = np.ones(len(lens), bool)
    for _ in range(ticks):
        forced = rng.integers(0, cfg.vocab, size=len(lens)).astype(np.int32)
        toks.append(np.asarray(ad.decode(forced, active)).tolist())
        logits.append(np.asarray(ad.last_logits, np.float32))
    return first, toks, logits


@functools.lru_cache(maxsize=None)
def _reference(family, lens=(5, 7), ticks=3, max_len=16):
    """The reference's unsharded adapter (its default tick, prompts
    admitted one-shot) on :func:`_drive`'s load."""
    jcfg, jparams, cfg, _ = _pair(family)
    jx, _ = extras_pair(cfg)
    ad = jslots.make_adapter(jcfg, jparams, n_slots=len(lens),
                             max_len=max_len, extras=jx, paged=True,
                             block_size=BS, chunked=False)
    return _drive(ad, cfg, lens, ticks, max_new=max_len - max(lens))


def _port(family, backend, mesh, lens=(5, 7), ticks=3, max_len=16,
          chunked=True):
    _, _, cfg, params = _pair(family)
    _, px = extras_pair(cfg)
    ad = slots.make_adapter(cfg, params, n_slots=len(lens), max_len=max_len,
                            extras=px, paged=True, block_size=BS,
                            backend=backend, chunked=chunked, mesh=mesh)
    return ad, _drive(ad, cfg, lens, ticks, max_new=max_len - max(lens))


def _assert_close(got, want):
    (f1, t1, l1), (f2, t2, l2) = got, want
    assert f1 == f2 and t1 == t2
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family,backend", CASES)
def test_model_axis_slice_matches_reference(family, backend):
    """A model-2 slice (``make_serving_mesh(1, model=2)``, both devices
    ``"cpu"``) with KV heads split: the reference's unsharded tokens and
    logits within 1e-5 (``test_sharded.py:407``'s load: two slots, prompts
    of 5 and 7 tokens, three forced ticks), through the chunked fold where
    the family takes it."""
    (sub,) = slice_meshes(make_serving_mesh(1, model=2, device="cpu"))
    ad, got = _port(family, backend, sub)
    assert [sh.heads[1] - sh.heads[0] for sh in ad.shards] == \
        [ad.cfg.n_kv_heads // 2] * 2
    _assert_close(got, _reference(family))


FALLBACK = dict(lens=(9, 11), ticks=3, max_len=16)


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_split_kv_fallback_matches_reference(backend):
    """The split-KV fallback: model 4 over the hybrid smoke config's 2 KV
    heads, each shard one in-block position of every block, window 6 on
    its odd layers (contexts of 9-14 tokens, so the window masks): the
    reference's unsharded tokens and logits within 1e-5, the ``"cuda"``
    tick's plain versions through ``paged_decode_attention_with_state``
    with the block stride and the merges."""
    _, _, cfg, _ = _pair(WINDOWED)
    assert cfg.n_kv_heads % 4 and cfg.window == 6 and cfg.global_every == 2
    ad, got = _port(WINDOWED, backend, [CPU] * 4, **FALLBACK)
    assert [sh.positions for sh in ad.shards] == [(d, d + 1)
                                                  for d in range(4)]
    _assert_close(got, _reference(WINDOWED, **FALLBACK))


@pytest.mark.parametrize("S", [2, 3, 4])
def test_merge_of_stacked_states_is_the_merges_in_order(S):
    """``merge_attn_states_n`` (the fallback's merge over more than two
    shards) within 1e-6 of the pairwise state merges in order, normalized
    (``merge_attn_states`` at the last), an empty state dropping out and
    all-empty rows giving zeros."""
    from repro_torch.kernels import paged_attn as pk
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(S)
    acc = torch.randn((S, 3, 5, 8), generator=gen)
    m = torch.randn((S, 3, 5), generator=gen)
    l = torch.rand((S, 3, 5), generator=gen) + 0.5
    acc[1, 0], m[1, 0], l[1, 0] = 0.0, ref.NEG_INF, 0.0     # an empty state
    acc[:, 2, 0], m[:, 2, 0], l[:, 2, 0] = 0.0, ref.NEG_INF, 0.0
    a, mm, ll = acc[0], m[0], l[0]
    for s in range(1, S - 1):
        a, mm, ll = ref.merge_softmax_states(a, mm, ll, acc[s], m[s], l[s])
    want = pk.merge_attn_states(a, mm, ll, acc[-1], m[-1], l[-1])
    got = pk.merge_attn_states_n(acc, m, l)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[2, 0], torch.zeros(8))


# ==========================================================================
# Within the port: bit for bit where the heads divide.
# ==========================================================================

@pytest.mark.parametrize("family,backend", [
    ("decoder", "plain"), ("moe", "cuda"), ("hybrid", "cascade"),
    ("encdec", "plain"), ("vlm", "plain"), ("int8", "plain"),
    ("decoder", "gather")])
def test_model2_slice_bitwise_port_unsharded(family, backend):
    """A model-2 slice is the port's unsharded adapter bit for bit on the
    CPU where the heads divide: tokens, logits, every chain block
    (``arena_block`` joins the shards' heads) and the lane state; one
    shard holds no block whole."""
    un, a = _port(family, backend, None)
    sh, b = _port(family, backend, [CPU, CPU])
    assert a[:2] == b[:2]
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)
    assert un.slot_bids == sh.slot_bids and un.shards[0].arrays is un.arena
    for slot in range(2):
        for bid in un.slot_bids[slot]:
            for key in un.seq_keys:
                np.testing.assert_array_equal(un.arena_block(key, bid),
                                              sh.arena_block(key, bid))
                assert sh.shards[0].arrays[key].shape[-2] * 2 == \
                    un.arena[key].shape[-2]
    for key in un.state:
        assert torch.equal(un.state[key], sh.state[key])
    assert un._token_bytes == sh._token_bytes


# ==========================================================================
# Migration across widths; disaggregated slices of two devices.
# ==========================================================================

@pytest.mark.parametrize("src_w,dst_w", [(1, 2), (2, 1), (2, 4)])
def test_migrate_slot_across_widths(src_w, dst_w):
    """A live request moves mid-decode from a slice of ``src_w`` devices
    to one of ``dst_w``: each block read from the source's shards and
    written to the destination's, the tokens after the move the stay-put
    oracle's, logits within 1e-5, and the receipt's bytes those of a move
    between one-device slices (the reference's)."""
    _, _, cfg, params = _pair("decoder")
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab, size=9).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=(6, 2)).astype(np.int32)

    def slices(*widths):
        return shard.build_slices(cfg, params, [[CPU] * w for w in widths],
                                  n_slots=2, max_len=24, block_size=BS)

    def run(src, dst):
        src.insert(0, prompt, max_new=10)
        act = np.asarray([True, False])
        out = []
        for t in range(3):
            src.decode(forced[t], act)
        receipt = shard.migrate_slot(src, 0, dst, 1, prompt)
        act = np.asarray([False, True])
        for t in range(3, 6):
            toks = dst.decode(forced[t, ::-1].copy(), act)
            out.append((int(toks[1]), np.asarray(dst.last_logits[1])))
        return receipt, out

    stay = slices(src_w)[0].adapter
    stay.insert(0, prompt, max_new=10)
    want = []
    for t in range(6):
        toks = stay.decode(forced[t], np.asarray([True, False]))
        if t >= 3:
            want.append((int(toks[0]), np.asarray(stay.last_logits[0])))
    a, b = (sl.adapter for sl in slices(src_w, dst_w))
    receipt, got = run(a, b)
    base, _ = run(*(sl.adapter for sl in slices(1, 1)))
    assert receipt == base
    assert not a.slot_bids[0] and b.lens[1] == 9 + 6
    for (t1, l1), (t2, l2) in zip(got, want):
        assert t1 == t2
        np.testing.assert_allclose(l1, l2, rtol=TOL, atol=TOL)


def test_disagg_prefill_slice_of_two_devices():
    """``make_disagg_meshes(1, 2, prefill_model=2)`` through
    ``build_slices`` and a ``RolePlan``: a prefill slice of two devices
    (KV heads split) hands its prefixes off to two one-device decode
    slices; every request's tokens are its solo run's on an unsharded
    adapter."""
    _, _, cfg, params = _pair("decoder")
    pre, dec = make_disagg_meshes(1, 2, prefill_model=2, device="cpu")
    assert [len(m.device_list) for m in pre + dec] == [2, 1, 1]
    slc = shard.build_slices(cfg, params, pre + dec, n_slots=2, max_len=16,
                             block_size=BS)
    assert len(slc[0].adapter.shards) == 2
    gw = shard.ShardedPromptGateway(slc, max_new_tokens=3,
                                    roles=shard.RolePlan.split(1, 2))
    assert not gw.parallel
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (6, 9, 5)]
    reqs = [slots.Request(uid=i, prompt=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    for r in reqs:
        gw.submit(r)
    while gw.busy:
        gw.step()
    assert gw.handoffs == len(reqs)
    solo = slots.make_adapter(cfg, params, n_slots=2, max_len=16,
                              paged=True, block_size=BS, device="cpu")
    for r, p in zip(reqs, prompts):
        b = slots.ContinuousBatcher(solo)
        o = slots.Request(uid=100 + r.uid, prompt=p, max_new_tokens=3)
        b.submit(o)
        b.run()
        assert r.generated == o.generated, r.uid


def test_make_adapter_mesh_rules():
    """``mesh=`` needs ``paged=True`` and a non-rwkv family and refuses
    ``device=`` beside it (``ValueError``); a one-device mesh is the
    ``device=`` path, ``arena`` the whole arena dict."""
    _, _, cfg, params = _pair("decoder")
    with pytest.raises(ValueError, match="paged=True"):
        slots.make_adapter(cfg, params, 2, 16, mesh=[CPU, CPU])
    with pytest.raises(ValueError, match="not both"):
        slots.make_adapter(cfg, params, 2, 16, paged=True, mesh=[CPU],
                           device="cpu")
    one = slots.make_adapter(cfg, params, 2, 16, paged=True, mesh=[CPU])
    assert isinstance(one.arena, dict) and one.shards[0].arrays is one.arena
    rw = configs.smoke_config("rwkv6_7b")
    with pytest.raises(ValueError, match="rwkv"):
        slots.make_adapter(rw, None, 2, 16, paged=True, mesh=[CPU, CPU])
