"""The split designs of the ``flash_attention`` and ``paged_decode_attention``
kernels, and of the cascade's two passes (``cascade_prefix_attention``,
``paged_decode_attention_with_state``), on the CPU: their split planners
(plain Python functions of the shapes) cover the key band or the chain
exactly once, the paged and cascade splits fall on block boundaries, and a
fold's chunk j launches the same plan cold and resumed; a plain emulation
of split + combine (each split's state from ``ref.softmax_state`` or from
the plain pass over the split's run of blocks, merged in split order by
``ref.merge_softmax_states`` then normalized, or by the kernels' state
combine) equals the unsplit plain version within 1e-6 in float32, and the
reference's Pallas kernels in interpret mode (2e-5 float32, 2e-2
bfloat16, their own tolerances; the cascade passes 2e-6), including splits
in which some rows' keys are all masked, a split past ``group_len``, and
the first-tile quirk; a state combine of all-empty splits is exactly the
empty state.  The kernels themselves are held against the plain versions
with forced splits on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.kernels import paged_attn as jpaged
from repro.nn import attention as jattn
from repro_torch.kernels import flash_attn, paged_attn, ref
from repro_torch.nn import attention
from test_torch_cascade import TOL, _fixture
from test_torch_chunked import BS, _empty, _fold
from test_torch_lm import smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


# -- the planners ------------------------------------------------------------

def _band(Sq, Sk, q_offset, window, causal):
    win = window if window else ref.NO_WINDOW
    lo = max(0, q_offset - win + 1)
    hi = min(Sk, q_offset + Sq) if causal else Sk
    return lo, hi


def _assert_covers_once(plan, band):
    """Runs of whole tiles from the band's start that cover it exactly
    once, none of them wholly past it."""
    splits, lo, keys = plan
    assert keys % flash_attn.TILE_K == 0 and splits >= 1
    covered = np.zeros(lo + splits * keys, np.int64)
    for z in range(splits):
        covered[lo + z * keys:lo + (z + 1) * keys] += 1
    assert (covered[band[0]:band[1]] == 1).all()
    assert splits == 1 or lo + (splits - 1) * keys < band[1]


def forced_flash_plan(B, Sq, Sk, Hq, q_offset, window, causal, tps):
    """``flash_split_plan`` with ``MIN_CTAS`` raised until it cuts runs of
    ``tps`` tiles, as the card checks force a plan."""
    lo, hi = _band(Sq, Sk, q_offset, window, causal)
    n_tiles = max(1, -(-(hi - lo) // flash_attn.TILE_K))
    ctas = -(-Sq // flash_attn.tile_q(Sq)) * Hq * B
    with mock.patch.object(flash_attn, "MIN_CTAS", ctas * -(-n_tiles // tps)):
        plan = flash_attn.flash_split_plan(B, Sq, Sk, Hq, q_offset, window,
                                           causal)
    assert plan[2] == tps * flash_attn.TILE_K
    return plan


def forced_paged_plan(nb, bs, bps):
    """``paged_split_plan`` with ``SPLIT_POSITIONS`` set to ``bps`` blocks
    (None: the module's own)."""
    if bps is None:
        return paged_attn.paged_split_plan(nb, bs)
    with mock.patch.object(paged_attn, "SPLIT_POSITIONS", bps * bs):
        return paged_attn.paged_split_plan(nb, bs)


# (B, Sq, Sk, Hq, q_offset, window, causal): the fold chunk at stablelm-3b's
# 32 heads, a partial chunk, the one-shot prompt, a windowed GQA chunk, the
# TPU kernel's (BH, S, D) call, a band shorter than a tile
PLAN_CASES = [
    (1, 16, 1088, 32, 1072, 0, True),
    (1, 7, 1079, 32, 1072, 0, True),
    (1, 1000, 1000, 32, 0, 0, True),
    (1, 16, 1088, 8, 1072, 8, True),
    (4, 256, 256, 1, 0, 0, False),
    (2, 5, 5, 4, 0, 0, True),
    (1, 16, 528, 32, 512, 300, True),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,q_offset,window,causal", PLAN_CASES)
def test_flash_split_plan_covers_the_band_once(B, Sq, Sk, Hq, q_offset,
                                               window, causal):
    splits, lo, keys = flash_attn.flash_split_plan(B, Sq, Sk, Hq, q_offset,
                                                   window, causal)
    band = _band(Sq, Sk, q_offset, window, causal)
    assert lo == band[0]
    _assert_covers_once((splits, lo, keys), band)
    ctas = -(-Sq // flash_attn.tile_q(Sq)) * Hq * B
    if ctas >= flash_attn.MIN_CTAS:
        assert splits == 1
    elif band[1] - band[0] > flash_attn.TILE_K:
        assert splits > 1
    # a forced run length of one tile covers the band as well
    with mock.patch.object(flash_attn, "MIN_CTAS", 1 << 30):
        forced = flash_attn.flash_split_plan(B, Sq, Sk, Hq, q_offset, window,
                                             causal)
    assert forced[1:] == (lo, flash_attn.TILE_K)
    _assert_covers_once(forced, band)


def test_flash_split_plan_runs_the_fold_chunk_on_more_than_32_ctas():
    splits, _, _ = flash_attn.flash_split_plan(1, 16, 1088, 32, 1072, None)
    assert 32 * splits > 32 and 32 * splits >= flash_attn.MIN_CTAS
    assert flash_attn.flash_split_plan(1, 1000, 1000, 32, 0, None)[0] == 1


@pytest.mark.parametrize("nb,bs,bps", [(96, 16, None), (4, 16, None),
                                       (5, 8, None), (7, 16, 2),
                                       (1, 64, None), (33, 4, 1)])
def test_paged_split_plan_covers_the_chain_on_block_boundaries(nb, bs, bps):
    splits, per = forced_paged_plan(nb, bs, bps)
    if bps is None:
        assert per * bs == max(bs, paged_attn.SPLIT_POSITIONS // bs * bs)
    else:
        assert per == bps
    entries = np.zeros(splits * per, np.int64)
    for z in range(splits):
        entries[z * per:(z + 1) * per] += 1      # whole table entries
    assert (entries[:nb] == 1).all() and (splits - 1) * per < nb
    # the plan is a function of the table's shape: lens never enters it
    assert forced_paged_plan(nb, bs, bps) == (splits, per)


def test_flash_split_plan_same_for_cold_and_resumed_fold(monkeypatch):
    """Every chunk of the fold launches the plan of its shapes, so chunk j
    of a cold fold and of a fold resumed at block H (j >= H) run the same
    plan on the same bytes."""
    _, _, cfg, params = smoke_pair()
    calls = []
    inner = flash_attn.flash_attention

    def record(q, k, v, **kw):
        B, Sq, Hq, _ = q.shape
        calls.append((kw["q_offset"], flash_attn.flash_split_plan(
            B, Sq, k.shape[1], Hq, kw["q_offset"], kw["window"],
            kw["causal"])))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(attention.flash_kernels, "flash_attention", record)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, 11
                                               ).astype(np.int32)
    cold, _ = _fold(cfg, params, prompt, _empty(cfg), 0)
    cold_plans = dict(calls)
    assert len(cold_plans) == -(-len(prompt) // BS)
    for H in (1, 2):
        calls.clear()
        warm = {"k": cold["k"][:, :, :H * BS].clone(),
                "v": cold["v"][:, :, :H * BS].clone(),
                "len": torch.tensor(H * BS, dtype=torch.int32)}
        _fold(cfg, params, prompt, warm, H * BS)
        assert calls and all(plan == cold_plans[off] for off, plan in calls)


# -- plain emulations of split + combine -------------------------------------

def flash_split_emulation(q, k, v, causal, window, q_offset, plan):
    """Each split's state over its run of keys, merged in split order, then
    ``acc / max(l, 1e-30)`` in v's dtype; p rounded to v's dtype for the
    value product, as the kernel does."""
    splits, lo, keys = plan
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    n_rep = Hq // k.shape[2]
    kt = ref.repeat_kv(k, n_rep).transpose(1, 2).float()
    vt = ref.repeat_kv(v, n_rep).transpose(1, 2)
    s = (q.transpose(1, 2).float() @ kt.transpose(-1, -2)) * D ** -0.5
    win = window if window else ref.NO_WINDOW
    j = torch.arange(Sk)
    rel = (q_offset + torch.arange(Sq))[:, None] - j[None, :]
    band = rel < win
    if causal:
        band &= rel >= 0
    state = None
    for z in range(splits):
        run = (j >= lo + z * keys) & (j < lo + (z + 1) * keys)
        p, m, l = ref.softmax_state(s, band & run)
        part = (p.to(v.dtype).float() @ vt.float(), m, l)
        state = part if state is None else \
            ref.merge_softmax_states(*state, *part)
    acc, _, l = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)


def paged_split_emulation(q, ka, va, tables, lens, window, new_kv, plan):
    """The chain's runs of ``bps`` table entries as splits; probabilities
    stay float32, as in the kernel."""
    splits, bps = plan
    B, Hq, D = q.shape
    bs, Hkv = ka.shape[1], ka.shape[2]
    t = tables.long()
    k = ka[t].reshape(B, -1, Hkv, D).float()
    v = va[t].reshape(B, -1, Hkv, D).float()
    if new_kv is not None:
        ref.splice_rows(k, new_kv[0], lens - 1)
        ref.splice_rows(v, new_kv[1], lens - 1)
    win = window if window else ref.NO_WINDOW
    s = torch.einsum("bhrd,bshd->bhrs",
                     q.reshape(B, Hkv, Hq // Hkv, D).float(), k) * D ** -0.5
    pos = torch.arange(k.shape[1])
    ln = lens.long()[:, None, None, None]
    live = (pos < ln) & (pos >= ln - win)
    state = None
    for z in range(splits):
        run = (pos >= z * bps * bs) & (pos < (z + 1) * bps * bs)
        p, m, l = ref.softmax_state(s, live & run)
        part = (torch.einsum("bhrs,bshd->bhrd", p, v), m, l)
        state = part if state is None else \
            ref.merge_softmax_states(*state, *part)
    acc, _, l = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(va.dtype)


# (B, Sq, Sk, Hq, Hkv, q_offset, window, tiles per split): a fold chunk
# split per tile (later splits hold keys past the chunk's early rows), a
# window with GQA 4:1 (splits in which most rows see no key), a one-shot
# prompt split per tile (the causal band's last splits are all masked for
# the early rows)
FLASH_EMU = [
    (1, 16, 208, 4, 4, 192, 0, 1),
    (2, 64, 320, 8, 2, 256, 8, 1),
    (1, 150, 150, 4, 1, 0, 0, 1),
    (1, 40, 300, 4, 2, 260, 100, 2),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,q_offset,window,tps", FLASH_EMU)
def test_flash_split_emulation_equals_unsplit_plain(B, Sq, Sk, Hq, Hkv,
                                                    q_offset, window, tps):
    gen = torch.Generator().manual_seed(Sq + Sk)
    q = torch.randn((B, Sq, Hq, 40), generator=gen)
    k = torch.randn((B, Sk, Hkv, 40), generator=gen)
    v = torch.randn((B, Sk, Hkv, 40), generator=gen)
    plan = forced_flash_plan(B, Sq, Sk, Hq, q_offset, window, True, tps)
    assert plan[0] > 1
    got = flash_split_emulation(q, k, v, True, window, q_offset, plan)
    want = ref.flash_attention_chunked(q, k, v, True, window, q_offset)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # and the plan the wrapper picks on its own
    auto = flash_attn.flash_split_plan(B, Sq, Sk, Hq, q_offset, window)
    torch.testing.assert_close(
        flash_split_emulation(q, k, v, True, window, q_offset, auto), want,
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("BH,S,D,causal,dtype", [
    (4, 256, 64, True, "float32"), (2, 256, 128, False, "float32"),
    (8, 512, 64, True, "bfloat16")])
def test_flash_split_emulation_matches_pallas_kernel(BH, S, D, causal, dtype):
    """The TPU kernel's cases, split one tile per CTA: for causal rows
    before a split's first key that split is all masked."""
    rng = np.random.default_rng(BH * S + 1)
    arrs = [rng.normal(0, 1, (BH, S, D)).astype(np.float32)
            for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))[:, :, None]
               for a in arrs)
    want = jflash.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    plan = forced_flash_plan(BH, S, S, 1, 0, None, causal, 1)
    assert plan[0] == S // flash_attn.TILE_K
    got = flash_split_emulation(q, k, v, causal, None, 0, plan)[:, :, 0]
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_flash_split_emulation_first_tile_quirk_matches_reference():
    """A window of 3 at offset 34: the split of keys [0, 64) holds a real
    key for every row, the one-tile splits of a forced plan leave the early
    splits all masked; the reference's chunked attention (whose first key
    chunk is all masked for these rows, p = 1 until the rescale) agrees."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (1, 6, 2, 16)).astype(np.float32)
    k = rng.normal(0, 1, (1, 140, 2, 16)).astype(np.float32)
    v = rng.normal(0, 50, (1, 140, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=3, q_offset=130, q_chunk=6, kv_chunk=8)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    for plan in ((3, 0, 64), (2, 64, 64), (1, 0, 192)):
        got = flash_split_emulation(*map(torch.from_numpy, (q, k, v)), True,
                                    3, 130, plan)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _paged_case(rng, B, nb, bs, Hq, Hkv, D, dtype, lens):
    num_blocks = B * nb + 1

    def arr(*shape):
        a = rng.normal(0, 1, shape).astype(np.float32)
        return np.array(jnp.asarray(a, dtype).astype(jnp.float32))
    q, ka, va = arr(B, Hq, D), arr(num_blocks, bs, Hkv, D), \
        arr(num_blocks, bs, Hkv, D)
    tables = np.zeros((B, nb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    for b, n in enumerate(lens):
        used = -(-n // bs)
        tables[b, :used] = perm[b * nb:b * nb + used]
    return (q, ka, va, tables, np.asarray(lens, np.int32), arr(B, Hkv, D),
            arr(B, Hkv, D))


# (B, nb, bs, Hq, Hkv, D, lens, window, splice, blocks per split): lens 0,
# 1, a partial block, exactly nb*bs and a lane longer than one split;
# windows 3 and 17 (splits before the window are empty)
PAGED_EMU = [
    (5, 6, 4, 4, 4, 32, (0, 1, 6, 24, 13), None, True, 1),
    (3, 5, 8, 8, 2, 64, (40, 17, 9), 3, True, 2),
    (3, 4, 16, 4, 1, 16, (64, 33, 1), 17, False, 1),
    (2, 7, 4, 6, 6, 80, (28, 5), None, False, 3),
]


@pytest.mark.parametrize("B,nb,bs,Hq,Hkv,D,lens,window,splice,bps",
                         PAGED_EMU)
def test_paged_split_emulation_equals_unsplit_plain(B, nb, bs, Hq, Hkv, D,
                                                    lens, window, splice,
                                                    bps):
    rng = np.random.default_rng(B * nb + D)
    q, ka, va, tables, ln, k1, v1 = (torch.from_numpy(a) for a in _paged_case(
        rng, B, nb, bs, Hq, Hkv, D, "float32", lens))
    nk = (k1, v1) if splice else None
    plan = forced_paged_plan(nb, bs, bps)
    assert plan[0] > 1
    got = paged_split_emulation(q, ka, va, tables, ln, window, nk, plan)
    want = ref.paged_decode_attention(q, ka, va, tables, ln, window, nk)
    live = ln > 0                 # a lens == 0 lane is garbage in the plain
    torch.testing.assert_close(got[live], want[live], rtol=1e-6, atol=1e-6)
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


@pytest.mark.parametrize("B,nb,bs,Hq,Hkv,D,lens,window,splice,bps",
                         PAGED_EMU[1:])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_emulation_matches_pallas_kernel(B, nb, bs, Hq, Hkv, D,
                                                     lens, window, splice,
                                                     bps, dtype):
    rng = np.random.default_rng(B * nb + D + 1)
    arrs = _paged_case(rng, B, nb, bs, Hq, Hkv, D, dtype, lens)
    q, ka, va, tables, ln, k1, v1 = (
        torch.from_numpy(a).to(getattr(torch, dtype))
        if a.dtype == np.float32 else torch.from_numpy(a) for a in arrs)
    jq, jka, jva, jt, jl, jk1, jv1 = (
        jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
        for a in arrs)
    nk = (k1, v1) if splice else None
    got = paged_split_emulation(q, ka, va, tables, ln, window, nk,
                                forced_paged_plan(nb, bs, bps))
    want = jpaged.paged_decode_attention(
        jq, jka, jva, jt, jl, window=window,
        new_kv=(jk1, jv1) if splice else None, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- the cascade's split plan and state combine ---------------------------------

def forced_cascade_plan(rows, Hkv, nb, bs, bps):
    """``cascade_split_plan`` at its own constants (``bps`` None) or forced
    to runs of ``bps`` blocks through them, as the card checks force it."""
    if bps is None:
        return paged_attn.cascade_split_plan(rows, Hkv, nb, bs)
    with mock.patch.object(paged_attn, "MIN_CTAS", 1 << 30), \
            mock.patch.object(paged_attn, "MIN_SPLIT_POSITIONS", bps * bs):
        return paged_attn.cascade_split_plan(rows, Hkv, nb, bs)


# (rows, Hkv, nb, bs, forced blocks per split): load (c)'s prefix pass and
# its suffix pass, the smoke fixture's group and suffix tables, a chain
# that does not divide evenly, one block per split
CASCADE_PLANS = [(1, 32, 64, 16, None), (8, 32, 8, 16, None),
                 (1, 2, 4, 4, None), (4, 4, 4, 4, None), (2, 8, 37, 16, None),
                 (1, 8, 37, 16, 5), (1, 2, 4, 4, 1), (3, 1, 9, 8, 2)]


@pytest.mark.parametrize("rows,Hkv,nb,bs,bps", CASCADE_PLANS)
def test_cascade_split_plan_covers_the_chain_on_block_boundaries(
        rows, Hkv, nb, bs, bps):
    splits, per = forced_cascade_plan(rows, Hkv, nb, bs, bps)
    if bps is not None:
        assert per == min(bps, nb)
    entries = np.zeros(splits * per, np.int64)
    for z in range(splits):
        entries[z * per:(z + 1) * per] += 1      # whole table entries
    assert (entries[:nb] == 1).all() and (splits - 1) * per < nb
    # the fewest splits that fill the card, each of two ring chunks or
    # the whole table
    if bps is None:
        assert per * bs >= paged_attn.MIN_SPLIT_POSITIONS or per == nb
        assert splits == 1 or \
            rows * Hkv * (splits - 1) < paged_attn.MIN_CTAS
    # a function of the shapes: lens and group_len never enter it
    assert forced_cascade_plan(rows, Hkv, nb, bs, bps) == (splits, per)


def test_cascade_split_plan_at_load_c():
    """Load (c)'s last tick: the prefix pass over 64 blocks in 8 runs of 8
    (256 CTAs), the suffix pass over 8-entry tables in one run (a split of
    one 64-position chunk measured slower than none on the card)."""
    assert paged_attn.cascade_split_plan(1, 32, 64, 16) == (8, 8)
    assert paged_attn.cascade_split_plan(8, 32, 8, 16) == (1, 8)
    with mock.patch.object(paged_attn, "MIN_CTAS", 0):
        assert paged_attn.cascade_split_plan(1, 32, 64, 16) == (1, 64)


def state_combine_emulation(states):
    """The kernels' state combine (``attn::combine_states``, state
    epilogue) in plain PyTorch: M = max of m, then l and acc weighted by
    exp(m_s - M), summed in split order."""
    M = states[0][1]
    for _, m, _ in states[1:]:
        M = torch.maximum(M, m)
    acc = torch.zeros_like(states[0][0])
    l = torch.zeros_like(states[0][2])
    for a, m, ls in states:
        w = torch.exp(m - M)
        acc = acc + w[..., None] * a
        l = l + w * ls
    return acc, M, l


def test_state_combine_of_empty_splits_is_the_empty_state_exactly():
    empty = (torch.zeros((2, 3, 8)), torch.full((2, 3), ref.NEG_INF),
             torch.zeros((2, 3)))
    for n in (1, 2, 8):
        acc, m, l = state_combine_emulation([empty] * n)
        assert torch.equal(acc, empty[0]) and torch.equal(l, empty[2])
        assert torch.equal(m, empty[1])
    # an empty split drops out of a real one exactly
    rng = np.random.default_rng(0)
    real = (torch.from_numpy(rng.normal(size=(2, 3, 8)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)),
            torch.from_numpy(rng.uniform(1, 2, (2, 3)).astype(np.float32)))
    for states in ([empty, real], [real, empty, empty]):
        for g, w in zip(state_combine_emulation(states), real):
            assert torch.equal(g, w)


def prefix_split_emulation(qg, ka, va, gt, glen, ll, window, plan):
    """Split z of the prefix pass is the plain pass over table entries
    ``[z * bps, (z + 1) * bps)``, its positions shifted by the run's first
    (``group_len`` and ``lane_lens`` shifted alike); the splits' states
    merged by the state combine."""
    splits, bps = plan
    bs = ka.shape[1]
    states = []
    for z in range(splits):
        off = z * bps * bs
        states.append(ref.cascade_prefix_attention(
            qg, ka, va, gt[:, z * bps:(z + 1) * bps].contiguous(),
            glen - off, ll - off, window))
    return state_combine_emulation(states)


def suffix_split_emulation(q, ka, va, tables, lens, window, q0, new_kv,
                           plan):
    """Split z of the suffix pass is the plain sweep over table entries
    ``[z * bps, (z + 1) * bps)`` from ``q0 + z * bps * bs``."""
    splits, bps = plan
    bs = ka.shape[1]
    states = [ref.paged_decode_attention_with_state(
        q, ka, va, tables[:, z * bps:(z + 1) * bps].contiguous(), lens,
        window, q0 + z * bps * bs, new_kv) for z in range(splits)]
    return state_combine_emulation(states)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("window", [0, 8, 2])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)])
@pytest.mark.parametrize("bps", [1, 2, None])
def test_prefix_split_emulation_matches_unsplit_and_pallas(window, heads,
                                                          bps):
    """``tests/test_cascade.py``'s fixture: a 3-block chain in a 4-entry
    table whose last entry is trash, so at one block per split the last
    split lies wholly past ``group_len``; window 2 leaves every lane's
    prefix empty, window 8 clips lane 1's."""
    q, ka, va, _, cl, _, meta = _fixture(seed=1, Hq=heads[0], Hkv=heads[1])
    lanes = meta["group_lanes"]
    args = (q[:, 0][lanes], ka, va, meta["group_tables"], meta["group_len"],
            cl[lanes])
    plan = forced_cascade_plan(1, heads[1], 4, ka.shape[1], bps)
    got = prefix_split_emulation(*map(_t, args), window, plan)
    want = ref.cascade_prefix_attention(*map(_t, args), window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    pallas = jpaged.cascade_prefix_attention(
        *map(jnp.asarray, args), window=window, interpret=True)
    for g, w in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("window", [0, 8, 2])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)])
@pytest.mark.parametrize("splice", [False, True])
@pytest.mark.parametrize("bps", [1, 3])
def test_suffix_split_emulation_matches_unsplit_and_pallas(window, heads,
                                                          splice, bps):
    """The fixture's suffix tables from ``q0`` (12 for the grouped lanes,
    0 for lane 3), the new row spliced in or not; later splits hold no
    position of the short lanes."""
    q, ka, va, _, cl, nk, meta = _fixture(Hq=heads[0], Hkv=heads[1])
    st, q0 = meta["suffix_tables"], meta["lane_q0"]
    args = (q[:, 0], ka, va, st, cl)
    plan = forced_cascade_plan(4, heads[1], st.shape[1], ka.shape[1], bps)
    assert plan[0] > 1
    tnk = tuple(map(_t, nk)) if splice else None
    got = suffix_split_emulation(*map(_t, args), window, _t(q0), tnk, plan)
    want = ref.paged_decode_attention_with_state(*map(_t, args), window,
                                                 _t(q0), tnk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    pallas = jpaged.paged_decode_attention_with_state(
        *map(jnp.asarray, args), window=window, q0=jnp.asarray(q0),
        new_kv=tuple(map(jnp.asarray, nk)) if splice else None,
        interpret=True)
    for g, w in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
