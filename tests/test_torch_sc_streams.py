"""The port's gate-level and stream-level SC paths against the reference, bit
for bit: the bit-stream layout, the TFF adder (gate, packed, count), the
adder trees (TFF and MUX), the product-count table, both count routes for
the ``tff``, ``ideal`` and ``mux`` adders and the SC layer's kernel route
(plain versions on the CPU); then the paper's Tables 1 and 2 through the
port, the bipolar design and the energy model's component shares."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arith as jarith
from repro.core import bipolar as jbipolar
from repro.core import bitstream as jbs
from repro.core import energy as jenergy
from repro.core import sc_layer as jsc
from repro.core import sng as jsng
from repro_torch.core import arith, bipolar, bitstream as bs, energy, sc_layer
from repro_torch.core import sng

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BITS = range(2, 9)


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 words as the reference's uint32."""
    return t.numpy().view(np.uint32)


def _bits(s: str) -> torch.Tensor:
    return torch.tensor([int(c) for c in s], dtype=torch.bool)


# -- bitstream ------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 16, 33, 100, 256])
def test_masks_and_pack_round_trip(N):
    assert bs.tail_mask(N) == int(np.uint32(jbs.tail_mask(N)).view(np.int32))
    np.testing.assert_array_equal(_u32(bs.word_masks(N, "cpu")),
                                  jbs.word_masks(N))
    rng = np.random.default_rng(N)
    bits = rng.integers(0, 2, (3, 4, N)).astype(bool)
    packed = bs.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(packed),
                                  np.asarray(jbs.pack_bits(jnp.asarray(bits))))
    assert torch.equal(bs.unpack_bits(packed, N), torch.from_numpy(bits))
    np.testing.assert_array_equal(
        bs.popcount(packed).numpy(), np.asarray(jbs.popcount(
            jnp.asarray(_u32(packed)))))
    np.testing.assert_array_equal(
        bs.popcount_per_word(packed).numpy(),
        np.asarray(jbs.popcount_per_word(jnp.asarray(_u32(packed)))))
    np.testing.assert_array_equal(
        bs.value(packed, N).numpy(),
        np.asarray(jbs.value(jnp.asarray(_u32(packed)), N)))
    np.testing.assert_array_equal(
        _u32(bs.ones((2, 3), N, "cpu").contiguous()),
        np.asarray(jbs.ones((2, 3), N)))
    np.testing.assert_array_equal(_u32(bs.zeros((2,), N, "cpu")),
                                  np.asarray(jbs.zeros((2,), N)))


@pytest.mark.parametrize("make", [
    lambda: bs.word_masks(8), lambda: bs.zeros((2,), 8),
    lambda: bs.ones((2,), 8), lambda: arith.tff_select_stream(8),
    lambda: bipolar.decision_point_errors(4, n=8)],
    ids=["word_masks", "zeros", "ones", "tff_select_stream",
         "decision_point_errors"])
def test_stream_makers_default_to_the_card(make):
    """Functions that make streams from no input default to "cuda" and
    raise without a card instead of building them on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        make()


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
def test_encode_comparator_and_streams(bits):
    N = 1 << bits
    lv = np.arange(-1, N + 2, dtype=np.int32).reshape(-1, 1)
    codes = jsng.lfsr_sequence(bits, which=1, seed=9)
    got = bs.encode_comparator(torch.from_numpy(lv),
                               torch.from_numpy(codes), N)
    want = jbs.encode_comparator(jnp.asarray(lv), jnp.asarray(codes), N)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    lv = torch.arange(N + 1, dtype=torch.int32)
    np.testing.assert_array_equal(
        _u32(sng.ramp_stream(lv, N)),
        np.asarray(jsng.ramp_stream(jnp.asarray(lv.numpy()), N)))
    np.testing.assert_array_equal(
        _u32(sng.vdc_stream(lv, N)),
        np.asarray(jsng.vdc_stream(jnp.asarray(lv.numpy()), N)))


# -- the TFF adder -------------------------------------------------------------

def test_tff_add_gate_paper_fig2b():
    """X=1/2, Y=4/5 over N=20 -> Z=13/20, bit for bit (paper Fig. 2b)."""
    z, state = arith.tff_add_gate(_bits("01100011010101111000"),
                                  _bits("10111111010101111111"), 0)
    assert "".join(str(int(v)) for v in z) == "01101011010101111101"
    assert int(z.sum()) == 13
    jz, jstate = jarith.tff_add_gate(
        jnp.asarray(_bits("01100011010101111000").numpy()),
        jnp.asarray(_bits("10111111010101111111").numpy()), 0)
    assert bool(state) == bool(jstate)


@pytest.mark.parametrize("s0,want", [(0, 2), (1, 3)])
def test_tff_add_gate_paper_fig2c_rounding(s0, want):
    """3/8 + 1/4 at N=8: 5/16 rounds down (s0=0) or up (s0=1)."""
    z, _ = arith.tff_add_gate(_bits("10100010"), _bits("01000100"), s0)
    assert int(z.sum()) == want


@pytest.mark.parametrize("n", [1, 20, 32, 33, 100])
@pytest.mark.parametrize("s0", [0, 1])
def test_tff_adder_gate_packed_count_equal_reference(n, s0):
    """Gate sim == packed == the count identity, each bitwise the
    reference's, final state included, over 16 random stream pairs."""
    rng = np.random.default_rng(n * 2 + s0)
    xb = rng.integers(0, 2, (16, n)).astype(bool)
    yb = rng.integers(0, 2, (16, n)).astype(bool)
    zg, st_g = arith.tff_add_gate(torch.from_numpy(xb), torch.from_numpy(yb),
                                  s0)
    jzg, jst_g = jarith.tff_add_gate(jnp.asarray(xb), jnp.asarray(yb), s0)
    np.testing.assert_array_equal(zg.numpy(), np.asarray(jzg))
    np.testing.assert_array_equal(st_g.numpy(), np.asarray(jst_g))
    xp, yp = bs.pack_bits(torch.from_numpy(xb)), bs.pack_bits(
        torch.from_numpy(yb))
    zp, st_p = arith.tff_add_packed(xp, yp, n, s0=s0)
    jzp, jst_p = jarith.tff_add_packed(jnp.asarray(_u32(xp)),
                                       jnp.asarray(_u32(yp)), n, s0=s0)
    np.testing.assert_array_equal(_u32(zp), np.asarray(jzp))
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(jst_p))
    assert torch.equal(bs.unpack_bits(zp, n), zg)
    np.testing.assert_array_equal(st_p.numpy(), st_g.numpy().astype(np.int32))
    cz = arith.tff_add_count(torch.from_numpy(xb.sum(-1)),
                             torch.from_numpy(yb.sum(-1)), s0)
    np.testing.assert_array_equal(cz.numpy(), zg.sum(-1).numpy())


@pytest.mark.parametrize("m", [2, 5, 25, 33])
@pytest.mark.parametrize("mode", ["zero", "one", "alt"])
def test_tff_tree_gate_equals_reference_and_counts(m, mode):
    N = 64 if m != 25 else 16
    rng = np.random.default_rng(m)
    streams = bs.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (3, m, N)).astype(bool)))
    root = arith.tff_tree_gate(streams, N, s0_mode=mode)
    want = jarith.tff_tree_gate(jnp.asarray(_u32(streams)), N, s0_mode=mode)
    np.testing.assert_array_equal(_u32(root), np.asarray(want))
    np.testing.assert_array_equal(
        bs.popcount(root).numpy(),
        arith.tff_tree_counts(bs.popcount(streams), s0_mode=mode).numpy())


@pytest.mark.parametrize("m", [3, 25])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_mux_tree_counts_bitwise(m, bits):
    N = 1 << bits
    rng = np.random.default_rng(m + bits)
    streams = bs.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (5, m, N)).astype(bool)))
    codes = jsng.lfsr_sequence(bits)
    got = arith.mux_tree_counts(streams, N, codes)
    want = jarith.mux_tree_counts(jnp.asarray(_u32(streams)), N, codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N", [4, 16, 20, 64, 256])
def test_gates_and_converters_bitwise(N):
    rng = np.random.default_rng(N)
    x, y, sel = (bs.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (6, N)).astype(bool))) for _ in range(3))
    jx, jy, jsel = (jnp.asarray(_u32(t)) for t in (x, y, sel))
    for got, want in ((arith.mult(x, y), jarith.mult(jx, jy)),
                      (arith.or_add(x, y), jarith.or_add(jx, jy)),
                      (arith.mux_add(x, y, sel), jarith.mux_add(jx, jy, jsel)),
                      (arith.tff_select_stream(N, "cpu"),
                       jarith.tff_select_stream(N))):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    c = arith.counter(x)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jarith.counter(jx)))
    np.testing.assert_array_equal(
        arith.scaled_value(c, N, 3).numpy(),
        np.asarray(jarith.scaled_value(jnp.asarray(c.numpy()), N, 3)))


# -- the SC layer's count routes ---------------------------------------------

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("scheme", jsng.SCHEMES)
def test_product_count_table_equal(scheme, bits):
    np.testing.assert_array_equal(sc_layer.product_count_table(scheme, bits),
                                  jsc.product_count_table(scheme, bits))


def _levels(bits, K, O, seed, M=(3,)):
    N = 1 << bits
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N + 1, M + (K,)).astype(np.int32),
            rng.integers(0, N + 1, (K, O)).astype(np.int32))


@pytest.mark.parametrize("adder,scheme", [
    ("tff", "ramp_lowdisc"), ("tff", "lfsr_shared"), ("ideal", "lowdisc"),
    ("mux", "lfsr_pair"), ("mux", "ramp_lowdisc")])
@pytest.mark.parametrize("bits,K", [(2, 25), (4, 7), (8, 25)])
def test_count_routes_bitwise(adder, scheme, bits, K):
    """``counts_via_table`` and ``counts_via_streams`` equal the reference's
    for every adder (the table has no MUX route: for ``"mux"`` it reduces
    through the TFF tree, as the reference's does)."""
    xl, wl = _levels(bits, K, 6, bits * K, M=(2, 3))
    kw = dict(bits=bits, scheme=scheme, adder=adder)
    cfg, jcfg = sc_layer.SCConfig(**kw), jsc.SCConfig(**kw)
    got = sc_layer.counts_via_streams(torch.from_numpy(xl),
                                      torch.from_numpy(wl), cfg)
    want = jsc.counts_via_streams(jnp.asarray(xl), jnp.asarray(wl), jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = sc_layer.counts_via_table(torch.from_numpy(xl),
                                    torch.from_numpy(wl), cfg)
    want = jsc.counts_via_table(jnp.asarray(xl), jnp.asarray(wl), jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("adder", ["tff", "ideal", "mux"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bank_counts_route_equals_reference(adder, bits):
    """The layer's route (the kernels' plain versions here; for ``mux`` the
    streams route) on both banks at once equals the reference's table (its
    streams route for ``mux``) on each bank."""
    scheme = "lfsr_pair" if adder == "mux" else "ramp_lowdisc"
    xl, wl = _levels(bits, 25, 10, bits, M=(40,))
    cfg = sc_layer.SCConfig(bits=bits, scheme=scheme, adder=adder)
    jcfg = jsc.SCConfig(bits=bits, scheme=scheme, adder=adder)
    jf = jsc.counts_via_streams if adder == "mux" else jsc.counts_via_table
    cp, cn = sc_layer.bank_counts(torch.from_numpy(xl),
                                  torch.from_numpy(wl), cfg)
    np.testing.assert_array_equal(
        cp.numpy(), np.asarray(jf(jnp.asarray(xl), jnp.asarray(wl[:, :5]),
                                  jcfg)))
    np.testing.assert_array_equal(
        cn.numpy(), np.asarray(jf(jnp.asarray(xl), jnp.asarray(wl[:, 5:]),
                                  jcfg)))


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("impl", ["table", "streams"])
def test_mux_layer_bitwise(bits, impl):
    """The old design's layer (LFSR pair + MUX tree): no longer refused,
    and bitwise the reference's."""
    rng = np.random.default_rng(bits)
    x = rng.random((2, 9, 9, 1)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 1, 6)) * 0.3).astype(np.float32)
    kw = dict(bits=bits, scheme="lfsr_pair", adder="mux")
    got = sc_layer.sc_conv2d_sign(torch.from_numpy(x), torch.from_numpy(w),
                                  sc_layer.SCConfig(**kw), impl=impl)
    want = jsc.sc_conv2d_sign(jnp.asarray(x), jnp.asarray(w),
                              jsc.SCConfig(**kw), impl="streams")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_impl_validated_and_dequantize_equal():
    with pytest.raises(ValueError):
        sc_layer.sc_dot_sign(torch.zeros(1, 4), torch.zeros(4, 1),
                             sc_layer.SCConfig(), impl="pallas")
    w = np.asarray([[0.5, -0.25], [1.0, 0.75], [-0.1, 0.0]], np.float32)
    pos, neg, scale = sc_layer.quantize_weights(torch.from_numpy(w), 4)
    jpos, jneg, jscale = jsc.quantize_weights(jnp.asarray(w), 4)
    np.testing.assert_array_equal(
        sc_layer.dequantize_weights(pos, neg, scale, 4).numpy(),
        np.asarray(jsc.dequantize_weights(jpos, jneg, jscale, 4)))


# -- the paper's Tables 1 and 2, through the port -------------------------------

def _mult_mse(scheme, bits, ref=False):
    """Table 1's multiplier MSE over every pair of levels, through the port
    (or, with ``ref``, the reference, as ``tests/test_arith.py`` has it)."""
    N = 1 << bits
    if ref:
        ca, cb = jsng.codes_for_scheme(scheme, bits)
        a = jnp.arange(N)
        SA, SB = jsng.generate(a, ca, N), jsng.generate(a, cb, N)
        prod = np.asarray(jbs.popcount(jarith.mult(SA[:, None], SB[None])),
                          np.float64)
    else:
        ca, cb = sng.codes_for_scheme(scheme, bits)
        a = torch.arange(N, dtype=torch.int32)
        SA, SB = sng.generate(a, ca, N), sng.generate(a, cb, N)
        prod = bs.popcount(arith.mult(SA[:, None], SB[None])).numpy() \
            .astype(np.float64)
    av = np.arange(N)[:, None] / N
    bv = np.arange(N)[None, :] / N
    return float(((prod / N - av * bv) ** 2).mean())


@pytest.mark.parametrize("bits", [4, 8])
def test_table1_ordering_and_reference_values(bits):
    mses = [_mult_mse(s, bits) for s in sng.SCHEMES]
    assert mses[0] > mses[1] > mses[2] > mses[3], (bits, mses)
    assert mses == [_mult_mse(s, bits, ref=True) for s in jsng.SCHEMES]


def test_table1_magnitudes_8bit():
    """ramp+LD lands within ~3x of the paper's 8.66e-6."""
    assert 8.66e-6 / 3 < _mult_mse("ramp_lowdisc", 8) < 8.66e-6 * 3


@pytest.mark.parametrize("bits,paper", [(8, 1.91e-6), (4, 4.88e-4)])
def test_table2_new_adder_exact(bits, paper):
    """The new adder's MSE is exactly 1/(8 N^2)."""
    N = 1 << bits
    a = torch.arange(N)
    cz = arith.tff_add_count(a[:, None], a[None, :], 0).numpy()
    exact = (np.arange(N)[:, None] + np.arange(N)[None, :]) / (2 * N)
    mse = float(((cz.astype(np.float64) / N - exact) ** 2).mean())
    assert mse == pytest.approx(1 / (8 * N * N), rel=1e-9)
    assert mse == pytest.approx(paper, rel=5e-3)


def test_table2_new_beats_old_and_equals_reference():
    """New adder MSE << MUX adder MSE; the MUX sums are the reference's."""
    bits, N = 6, 64
    rng = np.random.default_rng(0)
    a = np.arange(N)
    draws_a = rng.random((4, N, N)) < (a[:, None] / N)
    draws_b = rng.random((4, N, N)) < (a[:, None] / N)
    SA, SB = (bs.pack_bits(torch.from_numpy(d)) for d in (draws_a, draws_b))
    sel = sng.generate(torch.tensor(N // 2), sng.lfsr_sequence(bits), N)
    z = arith.mux_add(SA[:, :, None], SB[:, None, :], sel)
    jsel = jsng.generate(jnp.asarray(N // 2), jsng.lfsr_sequence(bits), N)
    jz = jarith.mux_add(jnp.asarray(_u32(SA))[:, :, None],
                        jnp.asarray(_u32(SB))[:, None, :], jsel)
    np.testing.assert_array_equal(_u32(z), np.asarray(jz))
    exact = (a[:, None] + a[None, :]) / (2 * N)
    mse_old = float(((bs.popcount(z).numpy().astype(np.float64) / N
                      - exact[None]) ** 2).mean())
    assert mse_old > 10 * (1 / (8 * N * N))


def test_or_adder_biased():
    """OR of identical streams adds nothing."""
    hi = sng.ramp_stream(torch.tensor(48), 64)
    assert int(bs.popcount(arith.or_add(hi, hi))) == 48


# -- bipolar and the energy model's shares ------------------------------------

def test_bipolar_levels_and_xnor_equal():
    bits, N = 6, 64
    v = torch.linspace(-1, 1, 41)
    lv = bipolar.to_level(v, bits)
    np.testing.assert_array_equal(
        lv.numpy(), np.asarray(jbipolar.to_level(jnp.asarray(v.numpy()),
                                                 bits)))
    xa = sng.generate(lv, sng.ramp_sequence(bits), N)
    xb = sng.generate(lv.flip(0), sng.revgray_sequence(bits), N)
    z = bipolar.mult(xa, xb, N)
    np.testing.assert_array_equal(
        _u32(z), np.asarray(jbipolar.mult(jnp.asarray(_u32(xa)),
                                          jnp.asarray(_u32(xb)), N)))
    np.testing.assert_array_equal(
        bipolar.from_count(bs.popcount(z), N).numpy(),
        np.asarray(jbipolar.from_count(jnp.asarray(bs.popcount(z).numpy()),
                                       N)))


@pytest.mark.parametrize("bits,K", [(4, 8), (6, 5), (8, 8)])
def test_dot_bipolar_within_1e6(bits, K):
    rng = np.random.default_rng(bits)
    x = rng.uniform(-1, 1, (8, K)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (K, 2)).astype(np.float32)
    got = bipolar.dot_bipolar(torch.from_numpy(x), torch.from_numpy(w), bits)
    want = jbipolar.dot_bipolar(jnp.asarray(x), jnp.asarray(w), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bits,n", [(6, 512)])
def test_decision_point_errors_equal(bits, n):
    """The split-unipolar side through the layer's kernel route equals the
    reference's table route; the bipolar side within float32 rounding."""
    eb, es = bipolar.decision_point_errors(bits, n=n, device="cpu")
    jeb, jes = jbipolar.decision_point_errors(bits, n=n)
    np.testing.assert_array_equal(es, np.asarray(jes))
    np.testing.assert_allclose(eb, np.asarray(jeb), rtol=0, atol=1e-6)
    if bits == 6:       # §IV.B: the split design is less noisy there
        assert es.mean() < eb.mean()


@pytest.mark.parametrize("bits", BITS)
def test_component_shares_equal(bits):
    assert energy.component_shares(bits) == jenergy.component_shares(bits)
    assert energy.report(bits).efficiency_gain == \
        jenergy.report(bits).efficiency_gain
