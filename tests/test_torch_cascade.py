"""The port's cascade decode against the reference's, at the stablelm-3b
smoke size in float32 with numpy-seeded inputs: the three cascade kernels'
plain versions (what the wrappers run for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against) against the Pallas
kernels in interpret mode within 2e-6, the empty state and the empty-side
merge exactly, ``attend_decode_cascade`` against the reference's (XLA and
Pallas) and the port's flat attention within 2e-6, the cascade adapter
against the reference's over forced ticks (tokens equal, logits within
2e-4, grouping statistics equal), the degrade rule bit for bit, the
shared-chain eligibility rules, and ``make_gateway(backend="cascade")``
token for token; for the moe family (deepseek-moe-16b's smoke size) the
cascade adapter against the port's flat tick; for the hybrid and encdec
families (hymba-1.5b's and whisper-medium's, the latter with the reference
tests' frames as ``extras``) both."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attn as jpaged
from repro.nn import attention as jattn
from repro.serve import spec as jspec
from repro.serve.gateway import slots as jslots
from repro.serve.kvcache import PagedKVSlotAdapter as JPagedKVSlotAdapter
from repro_torch.kernels import paged_attn, ref
from repro_torch.nn import attention
from repro_torch.serve import spec
from repro_torch.serve.gateway import slots
from test_torch_lm import ENCDEC, HYMBA, MOE, extras_pair, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4
TOL = 2e-6
WINDOWS = [0, 8, 2]                    # none; clips lane 1's prefix; suffix
HEADS = [(4, 2), (4, 4)]               # GQA, MHA


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _fixture(seed=0, Hq=4, Hkv=2):
    """``tests/test_cascade.py``'s fixture: lanes 0-2 share a 3-block
    prefix, lane 3 is ungrouped, lengths end mid-block and the group's
    fourth slot is padding.  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    D, bs = 8, BS
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    ka, va = f(25, bs, Hkv, D), f(25, bs, Hkv, D)
    tables = np.array([[1, 2, 3, 10, 11, 0], [1, 2, 3, 12, 0, 0],
                       [1, 2, 3, 13, 14, 15], [4, 5, 6, 7, 0, 0]], np.int32)
    cache_len = np.array([18, 15, 23, 14], np.int32)
    q = f(4, 1, Hq, D)
    new_kv = (f(4, Hkv, D), f(4, Hkv, D))
    meta = {"group_tables": np.array([[1, 2, 3, 0]], np.int32),
            "group_len": np.array([12], np.int32),
            "group_lanes": np.array([[0, 1, 2, 0]], np.int32),
            "group_mask": np.array([[True, True, True, False]]),
            "lane_q0": np.array([12, 12, 12, 0], np.int32),
            "suffix_tables": np.array([[10, 11, 0, 0], [12, 0, 0, 0],
                                       [13, 14, 15, 0], [4, 5, 6, 7]],
                                      np.int32)}
    return q, ka, va, tables, cache_len, new_kv, meta


# -- the kernels' plain versions against the Pallas kernels --------------------

@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("splice", [False, True])
def test_state_sweep_matches_pallas(window, heads, splice):
    q, ka, va, _, cl, nk, meta = _fixture(Hq=heads[0], Hkv=heads[1])
    st, q0 = meta["suffix_tables"], meta["lane_q0"]
    got = paged_attn.paged_decode_attention_with_state(
        _t(q[:, 0]), _t(ka), _t(va), _t(st), _t(cl), window=window,
        q0=_t(q0), new_kv=tuple(map(_t, nk)) if splice else None)
    want = jpaged.paged_decode_attention_with_state(
        jnp.asarray(q[:, 0]), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(st), jnp.asarray(cl), window=window, q0=jnp.asarray(q0),
        new_kv=tuple(map(jnp.asarray, nk)) if splice else None,
        interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("heads", HEADS)
def test_prefix_pass_matches_pallas(window, heads):
    q, ka, va, _, cl, _, meta = _fixture(seed=1, Hq=heads[0], Hkv=heads[1])
    lanes = meta["group_lanes"]
    qg, lane_lens = q[:, 0][lanes], cl[lanes]
    got = paged_attn.cascade_prefix_attention(
        _t(qg), _t(ka), _t(va), _t(meta["group_tables"]),
        _t(meta["group_len"]), _t(lane_lens), window=window)
    want = jpaged.cascade_prefix_attention(
        jnp.asarray(qg), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(meta["group_tables"]), jnp.asarray(meta["group_len"]),
        jnp.asarray(lane_lens), window=window, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


def _states(rng, B=3, Hq=4, D=8):
    s = rng.normal(0, 3, (B, Hq, 7)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hq, 7, D)).astype(np.float32)
    m = s.max(-1)
    p = np.exp(s - m[..., None])
    return (np.einsum("bhs,bhsd->bhd", p, v).astype(np.float32), m,
            p.sum(-1).astype(np.float32))


def _empty(acc, m, l):
    return (np.zeros_like(acc), np.full_like(m, ref.NEG_INF),
            np.zeros_like(l))


def test_merge_matches_pallas_and_empty_sides_exactly():
    rng = np.random.default_rng(2)
    a, b = _states(rng), _states(rng)
    e = _empty(*a)
    cases = {"both": a + b, "empty_first": e + b, "empty_second": a + e,
             "both_empty": e + e}
    for name, args in cases.items():
        got = paged_attn.merge_attn_states(*map(_t, args))
        want = np.asarray(jpaged.merge_attn_states(
            *map(jnp.asarray, args), interpret=True))
        _close(got, want)
        if name != "both":              # an empty side drops out exactly
            np.testing.assert_array_equal(got.numpy(), want)
    side = b[0] / np.maximum(b[2], 1e-30)[..., None]
    np.testing.assert_array_equal(
        paged_attn.merge_attn_states(*map(_t, e + b)).numpy(), side)
    np.testing.assert_array_equal(
        paged_attn.merge_attn_states(*map(_t, e + e)).numpy(),
        np.zeros_like(side))


def test_merge_softmax_states_matches_reference_and_empty_side_is_identity():
    rng = np.random.default_rng(3)
    a, b = _states(rng), _states(rng)
    got = attention.merge_softmax_states(*map(_t, a + b))
    want = jattn.merge_softmax_states(*map(jnp.asarray, a + b))
    for g, w in zip(got, want):
        _close(g, w)
    e = _empty(*a)
    for args in (e + a, a + e):
        for g, w in zip(attention.merge_softmax_states(*map(_t, args)), a):
            np.testing.assert_array_equal(g.numpy(), w)


def test_empty_sweep_returns_the_empty_state_exactly():
    """lens 0, and a window entirely below the sweep's first position."""
    rng = np.random.default_rng(4)
    ka, va = (rng.normal(size=(5, 4, 2, 8)).astype(np.float32)
              for _ in range(2))
    q = rng.normal(size=(2, 4, 8)).astype(np.float32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    lens, q0 = np.array([0, 30], np.int32), np.array([0, 8], np.int32)
    for window in (None, 2):
        args = (q, ka, va, tables, lens)
        acc, m, l = paged_attn.paged_decode_attention_with_state(
            *map(_t, args), window=window, q0=_t(q0))
        jacc, jm, jl = jpaged.paged_decode_attention_with_state(
            *map(jnp.asarray, args), window=window, q0=jnp.asarray(q0),
            interpret=True)
        empty = [0] if window is None else [0, 1]
        for x, jx, fill in ((acc, jacc, 0.0), (m, jm, ref.NEG_INF),
                            (l, jl, 0.0)):
            np.testing.assert_array_equal(x.numpy()[empty],
                                          np.asarray(jx)[empty])
            np.testing.assert_array_equal(
                x.numpy()[empty], np.full_like(x.numpy()[empty], fill))


def test_plain_cascade_kernels_ignore_trash_block_contents():
    """Garbage in the trash block (padded table entries and group slots)
    never reaches a state: not NaN, not 1e9."""
    q, ka, va, _, cl, nk, meta = _fixture(seed=5)
    lanes = meta["group_lanes"]

    def run(ka, va):
        pre = paged_attn.cascade_prefix_attention(
            _t(q[:, 0][lanes]), _t(ka), _t(va), _t(meta["group_tables"]),
            _t(meta["group_len"]), _t(cl[lanes]))
        suf = paged_attn.paged_decode_attention_with_state(
            _t(q[:, 0]), _t(ka), _t(va), _t(meta["suffix_tables"]), _t(cl),
            q0=_t(meta["lane_q0"]), new_kv=tuple(map(_t, nk)))
        return pre + suf
    base = run(ka, va)
    ka, va = ka.copy(), va.copy()
    ka[0], va[0] = np.nan, 1e9
    for g, w in zip(run(ka, va), base):
        assert torch.equal(g, w)


# -- attend_decode_cascade ----------------------------------------------------

def _port_cascade(q, ka, va, meta, cl, window, nk):
    tmeta = attention.with_lane_meta({k: _t(v) for k, v in meta.items()},
                                     _t(cl))
    return attention.attend_decode_cascade(
        _t(q), _t(ka), _t(va), tmeta, _t(cl), window=window,
        new_kv=None if nk is None else tuple(map(_t, nk)))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("heads", HEADS)
def test_attend_decode_cascade_matches_reference_and_flat(window, heads):
    q, ka, va, tables, cl, nk, meta = _fixture(Hq=heads[0], Hkv=heads[1])
    got = _port_cascade(q, ka, va, meta, cl, window, nk)
    jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
    jargs = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va), jmeta,
             jnp.asarray(cl))
    jnk = tuple(map(jnp.asarray, nk))
    for kernel in (False, True):
        want = jattn.attend_decode_cascade(*jargs, window=window, new_kv=jnk,
                                           kernel=kernel, interpret=True)
        _close(got, want)
    flat = attention.attend_decode_paged(
        _t(q), _t(ka), _t(va), _t(tables), _t(cl), window=window,
        new_kv=tuple(map(_t, nk)))
    _close(got, flat.numpy())
    via = attention.attend_decode_paged(
        _t(q), _t(ka), _t(va), _t(tables), _t(cl), window=window,
        new_kv=tuple(map(_t, nk)), backend="cascade",
        cascade=attention.with_lane_meta(
            {k: _t(v) for k, v in meta.items()}, _t(cl)))
    assert torch.equal(via, got)


def test_attend_decode_cascade_empty_suffix_lane():
    """Lane 0's length equals its group prefix: its suffix pass is empty and
    the merged output is prefix-only attention, no NaN."""
    q, ka, va, tables, _, _, meta = _fixture()
    cl = np.array([12, 15, 23, 14], np.int32)
    got = _port_cascade(q, ka, va, meta, cl, 0, None)
    assert not torch.isnan(got).any()
    want = jattn.attend_decode_cascade(
        jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
        {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(cl))
    _close(got, want)
    flat = attention.attend_decode_paged(_t(q), _t(ka), _t(va), _t(tables),
                                         _t(cl))
    _close(got, flat.numpy())


# -- the suffix pass with the merge fused ----------------------------------

# lane 0's suffix empty (its length is the group prefix); lane 3, in no
# group, of length 0, so both of its sides are empty
FUSED_LENS = {"fixture": [18, 15, 23, 14], "empty suffix": [12, 15, 23, 14],
              "both empty": [18, 15, 23, 0]}


@pytest.mark.parametrize("case", list(FUSED_LENS))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_fused_suffix_pass_bitwise_to_composition(case, window, dtype):
    """The plain fused suffix pass (the kernel's plain version: the prefix
    states gathered through ``lane_slot``) is bit for bit the composition
    it replaces: the state, the group states placed on their lanes through
    ``group_dest``, ``merge_attn_states`` and the cast, with padded group
    slots, a lane in no group, windows that empty lanes' prefixes (2), an
    empty suffix and both sides empty."""
    q, ka, va, _, _, nk, meta = _fixture(seed=7)
    cl = _t(np.array(FUSED_LENS[case], np.int32))
    meta = attention.with_lane_meta({k: _t(v) for k, v in meta.items()}, cl)
    q, ka, va = (_t(x).to(dtype) for x in (q[:, 0], ka, va))
    nk = tuple(_t(x).to(dtype) for x in nk)
    lanes = meta["group_lanes"].long()
    pre = ref.cascade_prefix_attention(
        q[lanes], ka, va, meta["group_tables"], meta["group_len"],
        meta["lane_lens"], window)
    suf = (q, ka, va, meta["suffix_tables"], cl)
    state = ref.paged_decode_attention_with_state(*suf, window,
                                                  meta["lane_q0"], nk)
    want = ref.merge_attn_states(
        *attention.place_group_states(meta, *pre, 4), *state).to(dtype)
    got = paged_attn.paged_decode_attention_with_state(
        *suf, window=window, q0=meta["lane_q0"], new_kv=nk,
        prefix=pre + (meta["lane_slot"],))
    assert got.dtype == dtype and torch.equal(got, want)
    assert not torch.isnan(got).any()
    if case == "both empty":
        assert torch.equal(got[3], torch.zeros_like(got[3]))
    # a grouped lane whose window holds no prefix position: its suffix
    # alone (every grouped lane at window 2, but lane 0 without a suffix)
    empty = (pre[1] == ref.NEG_INF).all(-1)[0]
    alone = (state[0] / torch.clamp(state[2], min=1e-30)[..., None]
             ).to(dtype)
    for c in range(3):
        assert not empty[c] or torch.equal(got[c], alone[c])
    assert bool(empty[:3].all()) == (window == 2 and case != "empty suffix")


def test_lane_slot_inverts_group_dest():
    """``with_lane_meta``'s ``lane_slot`` names each grouped lane's flat
    slot and -1 for the rest, the inverse of ``group_dest`` on the real
    slots, with a padded group as well as padded slots."""
    *_, cl, _, meta = _fixture()
    meta = {k: _t(v) for k, v in meta.items()}
    meta["group_lanes"] = torch.cat([meta["group_lanes"],
                                     torch.zeros_like(meta["group_lanes"])])
    meta["group_mask"] = torch.cat([meta["group_mask"],
                                    torch.zeros_like(meta["group_mask"])])
    got = attention.with_lane_meta(meta, _t(cl))
    dest, slot = got["group_dest"].long(), got["lane_slot"].long()
    assert got["lane_slot"].dtype == torch.int32
    assert slot.tolist() == [0, 1, 2, -1]
    real = dest < cl.shape[0]
    assert torch.equal(slot[dest[real]], torch.nonzero(real)[:, 0])
    assert torch.equal(dest[slot[slot >= 0]], torch.nonzero(slot >= 0)[:, 0])


@pytest.mark.parametrize("window", WINDOWS)
def test_attend_decode_cascade_takes_the_fused_route(window):
    """``attend_decode_cascade`` runs the prefix pass and the fused suffix
    pass and nothing else (no placement of the group states, no separate
    merge), and holds to the reference's cascade with the Pallas kernels
    in interpret mode and without them."""
    q, ka, va, _, cl, nk, meta = _fixture(seed=3)

    def gone(*args, **kwargs):
        raise AssertionError("the fused route must not call this")
    with mock.patch.object(attention, "place_group_states", gone), \
            mock.patch.object(paged_attn, "merge_attn_states", gone):
        got = _port_cascade(q, ka, va, meta, cl, window, nk)
    assert got.shape == (4, 1, 4, 8) and got.dtype == torch.float32
    jargs = (jnp.asarray(q), jnp.asarray(ka), jnp.asarray(va),
             {k: jnp.asarray(v) for k, v in meta.items()}, jnp.asarray(cl))
    for kernel in (False, True):
        _close(got, jattn.attend_decode_cascade(
            *jargs, window=window, new_kv=tuple(map(jnp.asarray, nk)),
            kernel=kernel, interpret=True))


# -- the cascade adapter ----------------------------------------------------

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


def _shared(ad, vocab, *, n_lanes=3, shared_len=5 * BS, tail=3, seed=11):
    """n_lanes lanes sharing a block-aligned prompt prefix, plus one lane
    with a disjoint prompt (``tests/test_cascade.py``'s admission)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=shared_len).tolist()
    for s in range(n_lanes):
        toks = shared + rng.integers(1, vocab, size=tail + s).tolist()
        ad.insert(s, np.asarray(toks, np.int32), max_new=8)
    ad.insert(n_lanes, rng.integers(1, vocab, size=shared_len // 2,
                                    dtype=np.int32), max_new=8)
    return ad


def _port_adapter(pair, backend, n_slots=4, max_len=48):
    _, _, cfg, params = pair
    return slots.make_adapter(cfg, params, n_slots=n_slots, max_len=max_len,
                              extras=extras_pair(cfg)[1], paged=True,
                              block_size=BS, chunked=False, backend=backend)


def test_cascade_adapter_matches_reference(pair):
    jcfg, jparams, cfg, _ = pair
    port = _shared(_port_adapter(pair, "cascade"), cfg.vocab)
    jref = _shared(JPagedKVSlotAdapter(jcfg, jparams, 4, 48, block_size=BS,
                                       extras=extras_pair(cfg)[0],
                                       chunked=False, backend="cascade"),
                   jcfg.vocab)
    assert port.backend == "cascade" and port.flat_backend == "plain"
    rng = np.random.default_rng(21)
    active = np.ones(4, bool)
    for _ in range(4):
        forced = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
        got, want = port.decode(forced, active), jref.decode(forced, active)
        assert port.last_groups == jref.last_groups == 1
        np.testing.assert_array_equal(got, np.asarray(want))
        _close(port.last_logits, np.asarray(jref.last_logits), 2e-4)
        np.testing.assert_array_equal(port.tables, np.asarray(jref.tables))
        np.testing.assert_array_equal(port.lens, np.asarray(jref.lens))
        assert port.cascade_stats() == jref.cascade_stats()
        assert port.tick_bytes_proxy() == jref.tick_bytes_proxy()
    st = port.cascade_stats()
    assert st["groups"] == 1 and st["grouped_lanes"] == 3
    assert st["prefix_rows_flat"] == 3 * st["prefix_rows"]
    proxy = port.tick_bytes_proxy()
    assert proxy["cascade"] < proxy["inplace"] < proxy["gather"]


def test_moe_cascade_matches_the_flat_tick(moe_pair):
    """``tests/test_cascade.py::test_cascade_adapter_matches_flat_tick`` for
    the moe family on the port: the cascade tick emits the flat tick's
    tokens, its logits within 2e-4, with one group every tick."""
    cfg = moe_pair[2]
    flat = _shared(_port_adapter(moe_pair, "plain"), cfg.vocab)
    casc = _shared(_port_adapter(moe_pair, "cascade"), cfg.vocab)
    rng = np.random.default_rng(22)
    active = np.ones(4, bool)
    for _ in range(4):
        forced = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
        np.testing.assert_array_equal(casc.decode(forced, active),
                                      flat.decode(forced, active))
        assert casc.last_groups == 1
        _close(casc.last_logits, flat.last_logits, 2e-4)


def test_hymba_cascade_adapter_matches_reference(hymba_pair):
    """The hybrid family's cascade tick (GQA 2:1, windows of 16 on the
    odd layers) against the reference's, one group every tick."""
    test_cascade_adapter_matches_reference(hymba_pair)


def test_hymba_cascade_matches_the_flat_tick(hymba_pair):
    test_moe_cascade_matches_the_flat_tick(hymba_pair)


def test_encdec_cascade_adapter_matches_reference(encdec_pair):
    """The encdec family's cascade tick (the self-attention grouped, the
    cross-attention over each lane's own cross K/V) against the
    reference's, one group every tick."""
    test_cascade_adapter_matches_reference(encdec_pair)


def test_encdec_cascade_matches_the_flat_tick(encdec_pair):
    test_moe_cascade_matches_the_flat_tick(encdec_pair)


def test_cascade_meta_matches_reference(pair):
    """The host-built metadata of a grouped tick, array for array."""
    jcfg, jparams, cfg, _ = pair
    port = _shared(_port_adapter(pair, "cascade"), cfg.vocab)
    jref = _shared(JPagedKVSlotAdapter(jcfg, jparams, 4, 48, block_size=BS,
                                       chunked=False, backend="cascade"),
                   jcfg.vocab)
    groups = port._cascade_plan(range(4))
    assert groups == jref._cascade_plan(range(4))
    got, want = port._cascade_meta(groups), jref._cascade_meta(groups)
    # the port adds the three per-lane keys every layer of the tick shares;
    # they are what attend_decode_cascade would derive from the other six
    # with the tick's cache_len (the lengths + 1)
    derived = attention.with_lane_meta(
        {k: _t(np.asarray(v)) for k, v in want.items()},
        _t(port.lens.astype(np.int32) + 1))
    assert got.keys() == derived.keys() == \
        set(want) | {"lane_lens", "group_dest", "lane_slot"}
    for key in got:
        np.testing.assert_array_equal(got[key], derived[key].numpy())
        assert got[key].dtype == (np.bool_ if key == "group_mask"
                                  else np.int32)


def test_cascade_degrades_to_the_plain_tick_bitwise(pair):
    """No chain shared by two lanes: the cascade adapter runs the plain
    tick, so logits are bit for bit the plain adapter's and no group forms
    (a lone lane never forms one)."""
    cfg = pair[2]
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, cfg.vocab, size=n, dtype=np.int32)
               for n in (9, 13)]
    plain = _port_adapter(pair, "plain", n_slots=2, max_len=24)
    casc = _port_adapter(pair, "cascade", n_slots=2, max_len=24)
    for slot, p in enumerate(prompts):
        assert plain.insert(slot, p, max_new=6) == \
            casc.insert(slot, p, max_new=6)
    active = np.ones(2, bool)
    for _ in range(4):
        forced = rng.integers(0, cfg.vocab, size=2).astype(np.int32)
        np.testing.assert_array_equal(plain.decode(forced, active),
                                      casc.decode(forced, active))
        assert casc.last_groups == 0
        assert torch.equal(plain.last_logits, casc.last_logits)


def test_shared_chains_eligibility(pair):
    """The pool's grouping rules as the adapter feeds them: a block armed
    for copy-on-write truncates the chain there (the head kills the group),
    and a lone lane never forms a group."""
    ad = _shared(_port_adapter(pair, "cascade"), pair[2].vocab)
    pool = ad.pool
    chains = {s: [int(b) for b in ad.tables[s, :int(ad.lens[s]) // ad.bs]]
              for s in range(4)}
    (chain, lanes), = pool.shared_chains(chains)
    assert sorted(lanes) == [0, 1, 2] and len(chain) == 5
    assert pool.shared_chains(chains, min_lanes=4) == []
    assert pool.shared_chains({0: chains[0]}) == []
    assert pool.shared_chains(chains, skip={chain[2]})[0][0] == chain[:2]
    assert pool.shared_chains(chains, skip={chain[0]}) == []
    # mid-CoW, through the adapter: slot 0 armed to copy its third block
    ad.cow_blk[0] = 2
    assert ad._cascade_plan(range(4))[0][0] == chain[:2]
    ad.cow_blk[0] = None
    assert ad._cascade_plan([0]) == []


def test_make_gateway_cascade_matches_plain_and_reference(pair):
    """Prompts sharing a prefix through make_gateway: the cascade gateway
    generates the plain gateway's tokens and the reference's."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(71)
    shared = rng.integers(1, cfg.vocab, size=5 * BS).tolist()
    prompts = [np.asarray(shared + rng.integers(1, cfg.vocab, 3 + i).tolist(),
                          np.int32) for i in range(3)]
    kw = dict(n_slots=4, max_len=64, paged=True, block_size=BS,
              chunked=False, max_new_tokens=4)
    out = {}
    for name, gw, mod in (
            ("cascade", spec.make_gateway(cfg, params, spec.ServeSpec(
                backend="cascade", **kw), device="cpu"), slots),
            ("plain", spec.make_gateway(cfg, params, spec.ServeSpec(
                backend="plain", **kw), device="cpu"), slots),
            ("reference", jspec.make_gateway(jcfg, jparams, jspec.ServeSpec(
                backend="cascade", **kw)), jslots)):
        for uid, p in enumerate(prompts):
            gw.batcher.submit(mod.Request(uid=uid, prompt=p,
                                          max_new_tokens=4))
        out[name] = {r.uid: list(map(int, r.generated))
                     for r in gw.batcher.run()}
        if name == "cascade":
            assert gw.batcher.adapter.backend == "cascade"
            assert gw.batcher.adapter.last_groups == 1
    assert out["cascade"] == out["plain"] == out["reference"]
    assert sorted(out["cascade"]) == [0, 1, 2]


N_TIGHT = 12


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_batcher_under_a_tight_arena_matches_reference(pair, backend):
    """Eviction pressure: three slots over an arena of 12 blocks of 4
    tokens, twelve requests in pairs from five families that share prompt prefixes,
    so finished chains stay indexed and later admissions evict them.  The
    port's batcher equals the reference's in tokens, ``kv_blocks``,
    prefix-hit blocks and ``pool_stats`` (evictions included)."""
    jcfg, jparams, cfg, params = pair
    kw = dict(block_size=BS, num_blocks=12, chunked=False)
    port = slots.make_adapter(cfg, params, n_slots=3, max_len=24,
                              paged=True, backend=backend, **kw)
    # the reference names the port's plain tick "xla"
    jref = JPagedKVSlotAdapter(jcfg, jparams, 3, 24, backend={
        "plain": "xla"}.get(backend, backend), **kw)

    def requests(mod):
        rng = np.random.default_rng(41)
        bases = [rng.integers(1, cfg.vocab, 9) for _ in range(5)]
        return [mod.Request(uid=uid, prompt=np.concatenate(
            [bases[uid // 2 % 5][:8 + uid % 2],
             rng.integers(1, cfg.vocab, uid % 3)]).astype(np.int32),
            max_new_tokens=3 + uid % 2) for uid in range(N_TIGHT)]
    tb, jb = slots.ContinuousBatcher(port), jslots.ContinuousBatcher(jref)
    for r in requests(slots):
        tb.submit(r)
    for r in requests(jslots):
        jb.submit(r)
    done = {r.uid: r for r in tb.run()}
    jdone = {r.uid: r for r in jb.run()}
    assert done.keys() == jdone.keys() == set(range(N_TIGHT))
    for uid, r in done.items():
        j = jdone[uid]
        assert (list(map(int, r.generated)), r.kv_blocks,
                r.prefix_hit_blocks) == \
            (list(map(int, j.generated)), j.kv_blocks, j.prefix_hit_blocks)
    stats = port.pool_stats()
    assert stats == jref.pool_stats()
    assert stats["evictions"] > 0
    assert sum(r.prefix_hit_blocks for r in done.values()) > 0
