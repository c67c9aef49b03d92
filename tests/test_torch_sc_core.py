"""The port's SC core (repro_torch.core) against the reference (repro.core):
code sequences, quantization, the TFF tree, im2col and the SC conv layer,
bit for bit on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arith as jarith
from repro.core import sc_layer as jsc
from repro.core import sng as jsng
from repro_torch.core import arith, sc_layer, sng

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BITS = range(2, 9)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("scheme", jsng.SCHEMES)
def test_codes_for_scheme_equal(scheme, bits):
    for got, want in zip(sng.codes_for_scheme(scheme, bits),
                         jsng.codes_for_scheme(scheme, bits)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_levels_bitwise(bits):
    rng = np.random.default_rng(bits)
    x = np.concatenate([rng.random(500, dtype=np.float32),
                        np.arange(256, dtype=np.float32) / 255.0,
                        (np.arange(2 * (1 << bits) + 1, dtype=np.float32)
                         / (2 * (1 << bits)))])           # exact half-ties
    got = sc_layer.quantize_levels(torch.from_numpy(x), bits).numpy()
    want = np.asarray(jsc.quantize_levels(jnp.asarray(x), bits))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("scale", [True, False])
def test_quantize_weights_bitwise(bits, scale):
    rng = np.random.default_rng(10 + bits)
    w = (rng.standard_normal((5, 5, 2, 7)) * 0.3).astype(np.float32)
    w[0, 0, 0, 3] = 0.0
    got = sc_layer.quantize_weights(torch.from_numpy(w), bits, scale)
    want = jsc.quantize_weights(jnp.asarray(w), bits, scale)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("s0_mode", ["zero", "one", "alt"])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 25, 32, 50])
def test_tff_tree_counts_bitwise(s0_mode, K):
    rng = np.random.default_rng(K)
    counts = rng.integers(0, 257, (6, K)).astype(np.int32)
    got = arith.tff_tree_counts(torch.from_numpy(counts), s0_mode).numpy()
    want = np.asarray(jarith.tff_tree_counts(jnp.asarray(counts), s0_mode))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 25, 32, 33, 1024])
def test_tree_depth(k):
    assert sc_layer.tree_depth(k) == jsc.tree_depth(k)


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_extract_patches_equal(C, padding):
    rng = np.random.default_rng(C)
    x = rng.random((2, 9, 8, C), dtype=np.float32)
    got = sc_layer.extract_patches(torch.from_numpy(x), 5, padding).numpy()
    want = np.asarray(jsc.extract_patches(jnp.asarray(x), 5, padding))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _frames(B, C, seed):
    """uint8 sensor frames scaled to [0, 1] as the gateway scales them."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (B, 12, 12, C), dtype=np.uint8)
    return u8.astype(np.float32) / 255.0


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
@pytest.mark.parametrize("C", [1, 2])
def test_sc_conv2d_sign_bitwise_vs_table(bits, C):
    x = _frames(2, C, bits)
    w = (np.random.default_rng(100 + bits).standard_normal((5, 5, C, 6))
         * 0.2).astype(np.float32)
    cfg = sc_layer.SCConfig(bits=bits)
    got = sc_layer.sc_conv2d_sign(torch.from_numpy(x), torch.from_numpy(w),
                                  cfg).numpy()
    want = np.asarray(jsc.sc_conv2d_sign(
        jnp.asarray(x), jnp.asarray(w), jsc.SCConfig(bits=bits),
        impl="table"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s0_mode,adder,tau", [
    ("zero", "tff", 0.0), ("one", "tff", 0.0), ("alt", "ideal", 0.0),
    ("alt", "tff", 0.05)])
def test_sc_dot_sign_configs_bitwise(s0_mode, adder, tau):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (40, 25)).astype(np.float32) / 255.0
    w = (rng.standard_normal((25, 9)) * 0.2).astype(np.float32)
    kw = dict(bits=4, scheme="lowdisc", s0_mode=s0_mode, adder=adder,
              soft_threshold=tau)
    got = sc_layer.sc_dot_sign(torch.from_numpy(x), torch.from_numpy(w),
                               sc_layer.SCConfig(**kw)).numpy()
    want = np.asarray(jsc.sc_dot_sign(jnp.asarray(x), jnp.asarray(w),
                                      jsc.SCConfig(**kw), impl="table"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_binary_conv2d_sign_bitwise(bits):
    x = _frames(2, 1, 50 + bits)
    w = (np.random.default_rng(bits).standard_normal((5, 5, 1, 6))
         * 0.2).astype(np.float32)
    got = sc_layer.binary_conv2d_sign(torch.from_numpy(x),
                                      torch.from_numpy(w), bits).numpy()
    want = np.asarray(jsc.binary_conv2d_sign(jnp.asarray(x), jnp.asarray(w),
                                             bits))
    np.testing.assert_array_equal(got, want)
