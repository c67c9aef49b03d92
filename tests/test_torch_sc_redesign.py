"""The redesigned SC kernels' arithmetic and launch plans on the CPU.

``csrc/sc_dot.cu`` pairs two leaves per popcount at N <= 16 (the odd leaf's
word 16 bits above the even one's), packs 32 / N leaves per popcount for the
ideal adder, and folds the TFF tree chunk by chunk (32 leaves, then the
chunk roots) with s0 picked by the parity of (index + level);
``csrc/sng_pack.cu`` builds the (N + 1)-row stream table with one ballot
per word and looks levels up in it, comparing directly outside [0, N].
Plain emulations of both, step for step, are held bit for bit against the
reference (``repro.kernels.ref``, the reference's comparator SNG, and its
Pallas kernels in interpret mode).  The launch plans are checked to fit
shared memory and to cover each (window, output) and each level once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from repro.core import sng as jsng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.arith import tree_depth
from repro_torch.core.bitstream import n_words
from repro_torch.kernels import ops
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

S0 = {"zero": (0, 0), "one": (1, 1), "alt": (0, 1)}   # (s_even, s_odd)
CASES = [("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")]


def _popcount(v: np.ndarray) -> np.ndarray:
    return np.bitwise_count(v.astype(np.uint32)).astype(np.int64)


def emulate_sc_dot(x, w, s0_mode, adder, length=None, *, depth=None,
                   c0=0):
    """``sc_dot.cu``'s arithmetic on numpy uint32 words x (M, K, Wd), w (K, O,
    Wd): leaves in chunks of 32 (zero past K), ``pack`` leaves per popcount
    32 / pack bits apart, the TFF tree folded as the units stream in with a
    stack of pending nodes, several outputs' nodes in the lanes of one
    register, the chunk roots folded into an upper stack.  A subtree of a
    larger tree (``depth`` 10, its first chunk ``c0`` of the whole tree)
    takes s0 in the upper stack by the global index and, for the ideal
    adder, returns the raw sum."""
    M, K, Wd = x.shape
    pack = sc_dot_kernel.leaves_per_popcount(length, Wd, adder)
    shift = 32 // pack
    subtree = depth is not None
    depth = tree_depth(K) if depth is None else depth
    kp = 1 << depth
    s_even, s_odd = S0[s0_mode]
    n_chunks = max(1, kp // 32)
    units = 32 // pack
    stop = min(max(kp, pack) // pack, units)

    def leaf(k):                        # (M, Wd), (O, Wd) words, 0 past K
        if k < K:
            return x[:, k].astype(np.uint64), w[k].astype(np.uint64)
        return np.zeros((M, Wd), np.uint64), np.zeros((w.shape[1], Wd),
                                                      np.uint64)

    # the TFF tree keeps several outputs' nodes in one 32-bit register, in
    # lanes of B bits: bytes at N <= 16 (a node is at most 16, a sum 33),
    # half-words up to N = 256 (a node at most 256, a sum 513); (l + r +
    # s0) >> 1 runs on the register, masked so no bit crosses lanes
    O = w.shape[1]
    B = 8 if pack == 2 else 16
    L = 32 // B
    shifts = np.arange(L, dtype=np.uint32) * B
    ones = int(sum(1 << int(b) for b in shifts))
    top = np.uint32(sum((1 << (B - 1)) << int(b) for b in shifts))
    mask = np.uint32(sum(((1 << (B - 1)) - 1) << int(b) for b in shifts))
    if adder == "tff":
        s_even, s_odd = s_even * ones, s_odd * ones

    def lanes(cnt):                     # (M, O) -> (M, ceil(O / L)) uint32
        assert cnt.max(initial=0) < 1 << (B - 2)
        c = np.pad(cnt, ((0, 0), (0, -O % L))).reshape(M, -1, L)
        return (c << shifts.astype(np.int64)).sum(-1).astype(np.uint32)

    def unlanes(v):
        b = (v[..., None] >> shifts) & np.uint32((1 << B) - 1)
        return b.reshape(M, -1)[:, :O].astype(np.int32)

    def step(total_, s):                # (l + r + s0) >> 1, lane by lane
        total_ = (total_ + np.uint32(s)).astype(np.uint32)
        assert (total_ & top == 0).all()
        return (total_ >> np.uint32(1)) & mask

    total = 0
    up = {}
    for c in range(n_chunks):
        live = min(K - 32 * c, 32)
        s4 = s_odd if c & 1 else s_even
        pend = {}
        for u in range(stop):
            if u * pack < live:
                xs = np.zeros((M, Wd), np.uint64)
                wsum = np.zeros((w.shape[1], Wd), np.uint64)
                for t in range(pack):
                    xl, wl = leaf(32 * c + u * pack + t)
                    xs |= xl << np.uint64(t * shift)
                    wsum |= wl << np.uint64(t * shift)
                cnt = _popcount((xs[:, None, :] & wsum[None]).astype(
                    np.uint32)).sum(-1)
            else:
                cnt = np.zeros((M, w.shape[1]), np.int64)
            if adder == "ideal":
                total = total + cnt
                continue
            level, idx, node = 0, u, lanes(cnt)
            if pack == 2:
                node = step(node, s_odd if u & 1 else s_even)
                level = 1
            while level < 5 and idx & 1:
                s = s4 if level == 4 else \
                    (s_odd if ((idx >> 1) + level) & 1 else s_even)
                node = step(pend[level] + node, s)
                idx >>= 1
                level += 1
            pend[level] = node
        if adder == "ideal":
            continue
        if n_chunks == 1:
            return unlanes(pend[depth])
        # the carry follows the block's chunk index, s0 the global one
        node, idx, gidx, level = pend[5], c, c0 + c, 0
        while idx & 1:
            s = s_odd if ((gidx >> 1) + 5 + level) & 1 else s_even
            node = step(up[level] + node, s)
            idx >>= 1
            gidx >>= 1
            level += 1
        up[level] = node
    if adder == "ideal":
        return (total >> (0 if subtree else depth)).astype(np.int64)
    return unlanes(up[depth - 5])


def emulate_sc_dot_subtrees(x, w, s0_mode, adder, length=None):
    """``sc_dot.cu`` at K > 1,024: each subtree of 1,024 leaves (zero past
    K) reduced on its own, as one block of the subtrees' launch reduces it
    (:func:`emulate_sc_dot` at depth 10 from its global first chunk), then
    ``sc_dot_fold_kernel``: the roots at level 10, node j the subtree j,
    folded with a stack of pending left siblings, zero roots past the
    subtrees that hold leaves; the ideal adder's sums added and shifted by
    the whole tree's depth."""
    K = x.shape[1]
    sub = sc_dot_kernel.SUB_LEAVES
    live = sc_dot_kernel.subtrees(K)
    assert live > 1
    depth = tree_depth(K)
    roots = [emulate_sc_dot(x[:, j * sub:(j + 1) * sub],
                            w[j * sub:(j + 1) * sub], s0_mode, adder, length,
                            depth=10, c0=j * sub // 32) for j in range(live)]
    if adder == "ideal":
        return (sum(roots) >> depth).astype(np.int32)
    s_even, s_odd = S0[s0_mode]
    up = {}
    for j in range(1 << (depth - 10)):
        node = roots[j].astype(np.int64) if j < live else \
            np.zeros_like(roots[0], np.int64)
        c, level = j, 0
        while c & 1:
            s = s_odd if ((c >> 1) + 10 + level) & 1 else s_even
            node = (up[level] + node + s) >> 1
            c >>= 1
            level += 1
        up[level] = node
    return up[depth - 10].astype(np.int32)


def _streams(rng, M, K, O, Wd, N):
    x = rng.integers(0, 2**32, (M, K, Wd), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 2**32, (K, O, Wd), dtype=np.uint64).astype(np.uint32)
    if N < 32:                      # packed streams keep the bits above N 0
        x &= np.uint32((1 << N) - 1)
        w &= np.uint32((1 << N) - 1)
    return x, w


def _reference(x, w, s0_mode, adder):
    K = x.shape[1]
    kp = 1 << tree_depth(K)
    xp = np.pad(x, ((0, 0), (0, kp - K), (0, 0)))
    wp = np.pad(w, ((0, kp - K), (0, 0), (0, 0)))
    return np.asarray(jref.sc_dot(jnp.asarray(xp), jnp.asarray(wp),
                                  s0_mode=s0_mode, adder=adder))


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("K", [1, 2, 3, 25, 32, 33, 1024])
@pytest.mark.parametrize("s0_mode,adder", CASES)
def test_pair_packed_tree_vs_reference(N, K, s0_mode, adder):
    rng = np.random.default_rng(N * 1000 + K)
    M, O = (3, 2) if K == 1024 else (7, 5)
    x, w = _streams(rng, M, K, O, 1, N)
    expect_pack = (2 if adder == "tff" else 32 // N)
    assert sc_dot_kernel.leaves_per_popcount(N, 1, adder) == expect_pack
    got = emulate_sc_dot(x, w, s0_mode, adder, length=N)
    np.testing.assert_array_equal(got, _reference(x, w, s0_mode, adder))


@pytest.mark.parametrize("N,K", [(32, 25), (32, 33), (64, 64), (256, 25),
                                 (256, 33)])
@pytest.mark.parametrize("s0_mode,adder", CASES)
def test_chunked_tree_vs_pallas(N, K, s0_mode, adder):
    """One leaf per popcount (N % 32 == 0): the chunked fold against the
    reference's Pallas kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(N + K)
    x, w = _streams(rng, 5, K, 3, N // 32, N)
    got = emulate_sc_dot(x, w, s0_mode, adder, length=N)
    np.testing.assert_array_equal(got, _reference(x, w, s0_mode, adder))
    want_k = np.asarray(jops.sc_dot(jnp.asarray(x), jnp.asarray(w),
                                    s0_mode=s0_mode, adder=adder))
    np.testing.assert_array_equal(got, want_k)


@pytest.mark.parametrize("K", [1025, 2560])
@pytest.mark.parametrize("N", [16, 32])
@pytest.mark.parametrize("s0_mode,adder", CASES)
def test_subtree_fold_vs_reference(K, N, s0_mode, adder):
    """K > 1,024: the subtrees and the fold against the reference's oracle
    and its Pallas kernel in interpret mode.  K = 2,560 has three subtrees
    of leaves (the last one half full) and a fourth of zero leaves, so
    subtrees 1 and 3 are odd: their last merge (level 9) makes node 1 and
    3, whose alt s0 differs from that of a tree of 1,024 leaves alone."""
    rng = np.random.default_rng(K + N)
    x, w = _streams(rng, 3, K, 2, max(1, N // 32), N)
    got = emulate_sc_dot_subtrees(x, w, s0_mode, adder, length=N)
    np.testing.assert_array_equal(got, _reference(x, w, s0_mode, adder))
    want_k = np.asarray(jops.sc_dot(jnp.asarray(x), jnp.asarray(w),
                                    s0_mode=s0_mode, adder=adder))
    np.testing.assert_array_equal(got, want_k)


@pytest.mark.parametrize("K", [1025, 2560])
@pytest.mark.parametrize("s0_mode,adder", CASES)
def test_plain_sc_dot_beyond_1024_vs_pallas(K, s0_mode, adder):
    """The plain version the kernel is held against on the card
    (``kernels/ref.py``, through ``ops.sc_dot`` and ``sc_dot_posneg`` on
    CPU tensors) at K > 1,024 against the reference's Pallas kernel in
    interpret mode, every s0 mode and both adders."""
    rng = np.random.default_rng(K)
    x, w = _streams(rng, 4, K, 6, 1, 16)
    want = np.asarray(jops.sc_dot(jnp.asarray(x), jnp.asarray(w),
                                  s0_mode=s0_mode, adder=adder))
    xt, wt = torch.from_numpy(x.view(np.int32)), torch.from_numpy(
        w.view(np.int32))
    got = ops.sc_dot(xt, wt, s0_mode=s0_mode, adder=adder, length=16)
    np.testing.assert_array_equal(got.numpy(), want)
    pos, neg = ops.sc_dot_posneg(xt, wt, s0_mode=s0_mode, adder=adder,
                                 length=16)
    np.testing.assert_array_equal(torch.cat([pos, neg], 1).numpy(), want)


def test_subtree_root_takes_the_global_index():
    """The level-9 trap: subtree 1's root computed as a tree of 1,024
    leaves alone (node 0 at its last merge) differs, in mode alt, from the
    same subtree at its global index, which the fold needs."""
    rng = np.random.default_rng(9)
    x, w = _streams(rng, 16, 1024, 8, 1, 16)
    alone = emulate_sc_dot(x, w, "alt", "tff", 16)
    at_one = emulate_sc_dot(x, w, "alt", "tff", 16, depth=10, c0=32)
    assert (alone != at_one).any()
    np.testing.assert_array_equal(
        emulate_sc_dot(x, w, "one", "tff", 16),
        emulate_sc_dot(x, w, "one", "tff", 16, depth=10, c0=32))


def test_pairing_needs_the_stream_length():
    """Full 32-bit words (no length) take one leaf per popcount; a stated
    length above 16 bits does too."""
    assert sc_dot_kernel.leaves_per_popcount(None, 1, "tff") == 1
    assert sc_dot_kernel.leaves_per_popcount(32, 1, "tff") == 1
    assert sc_dot_kernel.leaves_per_popcount(16, 2, "ideal") == 1
    assert sc_dot_kernel.leaves_per_popcount(5, 1, "ideal") == 4
    rng = np.random.default_rng(5)
    x, w = _streams(rng, 6, 25, 4, 1, 32)
    for s0_mode, adder in CASES:
        np.testing.assert_array_equal(emulate_sc_dot(x, w, s0_mode, adder),
                                      _reference(x, w, s0_mode, adder))


# --------------------------------------------------------------------------
# sng_pack: the stream table plus lookup
# --------------------------------------------------------------------------

def emulate_sng_pack(levels: np.ndarray, codes: np.ndarray, length: int
                     ) -> np.ndarray:
    """``sng_pack.cu``: table row L, word v = the ballot over lanes of
    ``codes[32 v + lane] < L`` (lanes past N vote 0); a level in [0, N]
    reads its row, any other compares directly."""
    nw = n_words(length)
    lanes = np.arange(32)
    table = np.zeros((length + 1, nw), np.uint64)
    for v in range(nw):
        t = 32 * v + lanes
        code = np.where(t < length, codes[np.minimum(t, length - 1)],
                        np.iinfo(np.int32).max)
        for L in range(length + 1):
            table[L, v] = int(((code < L).astype(np.uint64) <<
                               lanes.astype(np.uint64)).sum())
    flat = levels.reshape(-1).astype(np.int64)
    out = np.zeros((flat.size, nw), np.uint64)
    inside = (flat >= 0) & (flat <= length)
    out[inside] = table[flat[inside]]
    for i in np.flatnonzero(~inside):
        for v in range(nw):
            for t in range(min(32, length - 32 * v)):
                out[i, v] |= np.uint64(int(codes[32 * v + t] < flat[i])) << \
                    np.uint64(t)
    return out.astype(np.uint32).reshape(levels.shape + (nw,))


@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("scheme", jsng.SCHEMES)
def test_stream_table_vs_reference(bits, scheme):
    N = 1 << bits
    rng = np.random.default_rng(bits)
    lv = rng.integers(0, N + 1, (5, 9)).astype(np.int32)
    lv[0, :4] = [-1, N + 1, -2**31, 2**31 - 1]          # outside [0, N]
    lv[1, :3] = [0, N, N // 2]
    for codes in jsng.codes_for_scheme(scheme, bits):
        codes = codes.astype(np.int32)
        got = emulate_sng_pack(lv, codes, N)
        want = np.asarray(jsng.generate(jnp.asarray(lv), codes, N))
        np.testing.assert_array_equal(got, want)
        port = ops.sng_pack(torch.from_numpy(lv), torch.from_numpy(codes), N)
        np.testing.assert_array_equal(got, port.numpy().view(np.uint32))
        if N % 32 == 0:                # the reference's Pallas kernel
            want_k = np.asarray(jops.sng_pack(jnp.asarray(lv),
                                              jnp.asarray(codes), N))
            np.testing.assert_array_equal(got, want_k)


def test_stream_table_with_arbitrary_codes():
    """Codes outside [0, N) and repeated: still the direct comparison."""
    rng = np.random.default_rng(11)
    for N in (16, 100, 256):
        codes = rng.integers(-5, N + 6, N).astype(np.int32)
        lv = rng.integers(-8, N + 9, 200).astype(np.int32)
        got = emulate_sng_pack(lv, codes, N)
        want = np.asarray(jsng.generate(jnp.asarray(lv), codes, N))
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# launch plans
# --------------------------------------------------------------------------

PLAN_SHAPES = [(25088, 25, 64, 1, 2), (25088, 25, 16, 1, 2),
               (25088, 32, 64, 8, 1), (25088, 25, 16, 8, 1),
               (6272, 25, 64, 1, 2), (1000, 25, 37, 1, 1), (517, 1000, 37, 8, 1),
               (517, 1000, 37, 3, 1), (1001, 25, 200, 8, 1), (300, 1000, 16, 1, 8),
               (129, 1024, 40, 8, 1), (77, 25, 1, 1, 2), (9, 1024, 5, 2, 1),
               (1, 1, 1, 1, 1), (5000, 64, 1000, 4, 1), (33, 3, 33, 1, 4)]


def _plans(M, K, O, Wd, pack, sms):
    yield sc_dot_kernel.sc_dot_plan(M, K, O, Wd, pack, False, sms)
    if Wd == 8 and 1 << tree_depth(K) <= sc_dot_kernel.MMA_MAX_LEAVES:
        yield sc_dot_kernel.sc_dot_plan(M, K, O, Wd, pack, True, sms)


def _covered(plan, M, O) -> np.ndarray:
    """How often the kernel's work assignment under ``plan`` writes each
    (window, output): every CTA's tiles, every thread's values."""
    hits = np.zeros((M, O), np.int64)
    for cta in range(plan.grid_x):
        tiles = np.arange(cta, plan.m_tiles, plan.grid_x)
        for y in range(plan.grid_y):
            if plan.mma:
                nt, mt = plan.nt, 4 // plan.nt
                wo = plan.ot // (8 * nt)
                warp, lane = np.divmod(np.arange(plan.threads), 32)
                wm_i, wo_i = np.divmod(warp, wo)
                rows = (wm_i[:, None, None] * mt * 16 +
                        16 * np.arange(mt)[None, :, None] +
                        (lane // 4)[:, None, None] +
                        8 * np.arange(2)[None, None, :])     # (T, mt, 2)
                cols = (wo_i[:, None, None] * nt * 8 +
                        8 * np.arange(nt)[None, :, None] +
                        2 * (lane % 4)[:, None, None] +
                        np.arange(2)[None, None, :])         # (T, nt, 2)
                r = rows[:, :, None, :, None]
                c = cols[:, None, :, None, :]
                r, c = np.broadcast_arrays(r, c)
                active = (wm_i < plan.groups)[:, None, None, None, None]
                active = np.broadcast_to(active, r.shape)
            else:
                lo = plan.ot // 4
                g, q = np.divmod(np.arange(plan.threads), lo)
                r = (np.arange(4)[None, :, None] * plan.groups +
                     g[:, None, None])
                c = 4 * q[:, None, None] + np.arange(4)[None, None, :]
                r, c = np.broadcast_arrays(r, c)
                active = np.broadcast_to((g < plan.groups)[:, None, None],
                                         r.shape)
            r, c = r[active], c[active]
            for t in tiles:
                m = t * plan.tm + r
                o = y * plan.ot + c
                ok = (m < M) & (o < O)
                np.add.at(hits, (m[ok], o[ok]), 1)
    return hits


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 7])
def test_sc_dot_plan_fits_and_covers_once(shape, sms):
    M, K, O, Wd, pack = shape
    for plan in _plans(M, K, O, Wd, pack, sms):
        assert plan.smem <= sc_dot_kernel.SMEM_MAX == 227 * 1024
        assert 32 <= plan.threads <= sc_dot_kernel.MAX_THREADS
        assert plan.threads % 32 == 0
        assert plan.grid_x <= max(plan.m_tiles, 1)
        # persistent: about one or two CTAs' worth of threads per SM
        assert plan.grid_x * plan.grid_y * plan.threads <= \
            sms * sc_dot_kernel.MAX_THREADS + plan.threads * plan.grid_y
        kp = 1 << tree_depth(K)
        if plan.mma:
            assert plan.ot % (8 * plan.nt) == 0 and plan.tm == \
                plan.groups * 64 // plan.nt
            assert plan.w_words * 4 == kp * plan.ot * 32
        else:
            assert plan.ot % 4 == 0 and plan.tm == 4 * plan.groups
            assert plan.groups * plan.ot // 4 <= plan.threads
            assert plan.x_stride % 4 == 0 and \
                plan.x_stride >= max(min(kp, 32), pack) * Wd
        assert plan.smem == 4 * (plan.w_words + 2 * plan.stage_words)
        if shape[0] * shape[2] <= 400_000:
            assert (_covered(plan, M, O) == 1).all()


@pytest.mark.parametrize("mma", [True, False])
def test_sc_dot_plan_every_tree_fits(mma):
    """Every K the kernel takes (1 .. 1,024), at every Wd and O up to 1,024
    columns, has a plan within shared memory: W tiles O on the grid where
    it must; the tensor-core route up to MMA_MAX_LEAVES leaves."""
    for depth in range(1, 11):
        K = 1 << depth
        for Wd in ((8,) if mma else range(1, 9)):
            if mma and K > sc_dot_kernel.MMA_MAX_LEAVES:
                continue
            for O in (1, 9, 64, 1024):
                for pack in ((1, 2, 4, 8) if Wd == 1 and not mma else (1,)):
                    plan = sc_dot_kernel.sc_dot_plan(25088, K, O, Wd, pack,
                                                     mma, 132)
                    assert plan.smem <= sc_dot_kernel.SMEM_MAX
                    assert plan.grid_y * plan.ot >= O


def test_sc_dot_plan_o_tile_from_o():
    """The O tile follows O: O = 16 (the gateway's default FrontendSpec)
    gives 4 output groups per window group, so a warp holds 8 window groups
    and no lane idles; O = 64 (the full LeNet-5) keeps W whole."""
    p16 = sc_dot_kernel.sc_dot_plan(25088, 25, 16, 1, 2, False, 132)
    assert (p16.ot, p16.grid_y) == (16, 1)
    assert p16.groups * p16.ot // 4 == p16.threads
    p64 = sc_dot_kernel.sc_dot_plan(25088, 25, 64, 1, 2, False, 132)
    assert (p64.ot, p64.grid_y) == (64, 1)
    m64 = sc_dot_kernel.sc_dot_plan(25088, 25, 64, 8, 1, True, 132)
    assert (m64.ot, m64.grid_y, m64.w_words * 4) == (64, 1, 65536)
    # W too large for one CTA: O tiled on the grid
    big = sc_dot_kernel.sc_dot_plan(100, 1024, 64, 8, 1, False, 132)
    assert big.grid_y > 1 and big.w_words * 4 <= sc_dot_kernel.W_BUDGET


def _levels_covered(n, length, route, items, ctas):
    """How often ``sng_pack.cu`` writes each word of each level."""
    nw = n_words(length)
    hits = np.zeros((n, nw), np.int64)
    stride = ctas * sng_pack_kernel.THREADS
    first = np.arange(stride)
    if route == 0:
        for i in range(n):
            hits[i] += 1
        return hits
    levels_per = 4 // nw if nw <= 4 else 1
    shift = 1 if nw == 8 else 0
    for i in range(items):                    # chunk i: 4 words of output
        words = np.arange(4 * i, 4 * i + 4)
        np.add.at(hits.reshape(-1), words, 1)
    done = (items >> shift) * levels_per
    for i in range(done, n):
        assert i - done in first              # one thread stores the tail
        hits[i] += 1
    return hits


@pytest.mark.parametrize("n", [1, 3, 4, 5, 17, 4097, 25088 * 25 // 64])
@pytest.mark.parametrize("length", [4, 16, 32, 64, 100, 128, 200, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_sng_pack_plan_covers_each_level_once(n, length, aligned):
    route, items, ctas = sng_pack_kernel.sng_pack_plan(n, length, 132,
                                                       aligned)
    nw = n_words(length)
    assert route == (nw if aligned and nw in (1, 2, 4, 8) else 0)
    assert 1 <= ctas <= 132
    assert (_levels_covered(n, length, route, items, ctas) == 1).all()
    # the table fits a CTA's static shared memory: (N + 1) x nw words
    assert (length + 1) * nw * 4 <= 8224
    assert sng_pack_kernel.sng_pack_plan(n, length, 7, aligned)[2] <= 7


# --------------------------------------------------------------------------
# ops: no pad copy, no concatenation
# --------------------------------------------------------------------------

def _spy():
    calls = []
    real = sc_dot_kernel.sc_dot

    def spy(x, w, s0_mode="alt", adder="tff", **kw):
        calls.append((tuple(x.shape), tuple(w.shape), kw.get("length")))
        return real(x, w, s0_mode, adder, **kw)
    return calls, spy


@pytest.mark.parametrize("K", [1, 9, 25, 33])
@pytest.mark.parametrize("s0_mode,adder", CASES)
def test_ops_sc_dot_unpadded_equals_padded_reference(K, s0_mode, adder):
    rng = np.random.default_rng(K)
    x, w = _streams(rng, 11, K, 6, 1, 16)
    calls, spy = _spy()
    with mock.patch.object(sc_dot_kernel, "sc_dot", spy):
        got = ops.sc_dot(torch.from_numpy(x.view(np.int32)),
                         torch.from_numpy(w.view(np.int32)),
                         s0_mode=s0_mode, adder=adder, length=16)
    assert calls == [((11, K, 1), (K, 6, 1), 16)]    # K as it came
    np.testing.assert_array_equal(got.numpy(),
                                  _reference(x, w, s0_mode, adder))


def test_ops_posneg_passes_both_banks():
    """The SC layer's one (K, 2 O, Wd) operand reaches the kernel as it
    came, and the result splits into the two banks' counts."""
    rng = np.random.default_rng(2)
    x, wp = _streams(rng, 9, 25, 5, 1, 16)
    _, wn = _streams(rng, 1, 25, 5, 1, 16)
    calls, spy = _spy()
    with mock.patch.object(sc_dot_kernel, "sc_dot", spy):
        cp, cn = ops.sc_dot_posneg(
            torch.from_numpy(x.view(np.int32)),
            torch.from_numpy(np.concatenate([wp, wn], axis=1).view(np.int32)),
            length=16)
    assert calls == [((9, 25, 1), (25, 10, 1), 16)]
    np.testing.assert_array_equal(cp.numpy(), _reference(x, wp, "alt", "tff"))
    np.testing.assert_array_equal(cn.numpy(), _reference(x, wn, "alt", "tff"))


def test_sc_layer_streams_both_banks_in_one_sng_pack():
    """``sc_dot_sign`` quantizes the two weight banks as one tensor and
    generates their streams in one ``sng_pack``: two calls per layer (X and
    the banks), and the same signs as the reference's table route."""
    from repro.core import sc_layer as jsc
    from repro_torch.core import sc_layer
    rng = np.random.default_rng(5)
    x01 = rng.random((3, 25), dtype=np.float32)
    w = rng.normal(size=(25, 6)).astype(np.float32)
    calls = []
    real = sng_pack_kernel.sng_pack

    def spy(levels, codes, length):
        calls.append(tuple(levels.shape))
        return real(levels, codes, length)
    cfg = sc_layer.SCConfig(bits=4)
    with mock.patch.object(sng_pack_kernel, "sng_pack", spy):
        got = sc_layer.sc_dot_sign(torch.from_numpy(x01), torch.from_numpy(w),
                                   cfg)
    assert calls == [(3, 25), (25, 12)]
    want = jsc.sc_dot_sign(jnp.asarray(x01), jnp.asarray(w),
                           jsc.SCConfig(bits=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
