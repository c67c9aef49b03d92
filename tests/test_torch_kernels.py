"""The port's kernel wrappers on the CPU (where they run the kernels' plain
versions) against the reference's oracles and its Pallas kernels (interpret
mode off-TPU), bit for bit.  Packed words are int32 bit patterns in the port
and uint32 in the reference; they are compared through ``.view(np.uint32)``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sc_layer as jsc
from repro.core import sng as jsng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitstream, sng
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel
from repro_torch.models import lenet
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.gateway import GatewayConfig, MicroBatchGateway

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.fixture
def counters():
    sng_pack_kernel.sng_pack.launches = 0
    sc_dot_kernel.sc_dot.launches = 0
    yield
    assert sng_pack_kernel.sng_pack.launches == 0
    assert sc_dot_kernel.sc_dot.launches == 0


def test_popcount32_and_bit_patterns():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 1, 2**31, 2**32 - 1]
    got = ref.popcount32(_i32(words)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))
    # the words' bits unpacked and packed again: the same bit patterns
    back = bitstream.pack_bits(bitstream.unpack_bits(_i32(words)[:, None],
                                                     32))
    np.testing.assert_array_equal(_u32(back[:, 0]), words)


@pytest.mark.parametrize("bits", [5, 6, 7, 8])
@pytest.mark.parametrize("scheme", jsng.SCHEMES)
def test_sng_pack_vs_reference_kernel(bits, scheme, counters):
    N = 1 << bits
    rng = np.random.default_rng(bits)
    lv = rng.integers(0, N + 1, (3, 19)).astype(np.int32)
    for codes in jsng.codes_for_scheme(scheme, bits):
        codes = codes.astype(np.int32)
        got = _u32(ops.sng_pack(torch.from_numpy(lv), torch.from_numpy(codes),
                                N))
        want_ref = np.asarray(jref.sng_pack(jnp.asarray(lv),
                                            jnp.asarray(codes), N))
        want_kernel = np.asarray(jops.sng_pack(jnp.asarray(lv),
                                               jnp.asarray(codes), N))
        np.testing.assert_array_equal(got, want_ref)
        np.testing.assert_array_equal(got, want_kernel)


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("scheme", jsng.SCHEMES)
def test_sng_pack_short_streams_vs_generate(bits, scheme, counters):
    """N < 32: one word, N valid low bits, zeros above — what the
    reference's comparator SNG (``sng.generate``) returns."""
    N = 1 << bits
    lv = np.arange(N + 1, dtype=np.int32).repeat(3)
    for codes in jsng.codes_for_scheme(scheme, bits):
        got = _u32(sng.generate(torch.from_numpy(lv), codes, N))
        want = np.asarray(jsng.generate(jnp.asarray(lv), codes, N))
        np.testing.assert_array_equal(got, want)
        assert (got >> N == 0).all()


def test_sng_pack_rejects_unsupported_length():
    lv = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.sng_pack(lv, torch.arange(24, dtype=torch.int32), 24)
    with pytest.raises(ValueError):
        ops.sng_pack(lv, torch.arange(512, dtype=torch.int32), 512)


def _packed(rng, M, K, O, Wd, N):
    x = rng.integers(0, 2**32, (M, K, Wd), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 2**32, (K, O, Wd), dtype=np.uint64).astype(np.uint32)
    if N < 32:                      # short streams keep the upper bits zero
        x &= np.uint32((1 << N) - 1)
        w &= np.uint32((1 << N) - 1)
    return x, w


def _pad_pow2(x, w):
    K = x.shape[1]
    Kp = 1 << max(1, int(np.ceil(np.log2(max(K, 2)))))
    return (np.pad(x, ((0, 0), (0, Kp - K), (0, 0))),
            np.pad(w, ((0, Kp - K), (0, 0), (0, 0))))


@pytest.mark.parametrize("M,K,O,N", [
    (37, 25, 11, 32), (7, 9, 3, 64), (5, 32, 16, 256), (1, 2, 1, 32),
    (9, 3, 4, 16), (20, 25, 6, 4)])
@pytest.mark.parametrize("s0_mode,adder", [
    ("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")])
def test_sc_dot_vs_reference(M, K, O, N, s0_mode, adder, counters):
    rng = np.random.default_rng(M * 31 + K)
    x, w = _packed(rng, M, K, O, max(1, N // 32), N)
    got = ops.sc_dot(_i32(x), _i32(w), s0_mode=s0_mode, adder=adder).numpy()
    xp, wp = _pad_pow2(x, w)
    want = np.asarray(jref.sc_dot(jnp.asarray(xp), jnp.asarray(wp),
                                  s0_mode=s0_mode, adder=adder))
    np.testing.assert_array_equal(got, want)
    if N % 32 == 0 and s0_mode == "alt":   # the reference's Pallas kernel
        want_k = np.asarray(jops.sc_dot(jnp.asarray(x), jnp.asarray(w),
                                        s0_mode=s0_mode, adder=adder))
        np.testing.assert_array_equal(got, want_k)


@pytest.mark.parametrize("s0_mode", ["zero", "one", "alt"])
def test_sc_dot_posneg_vs_reference(s0_mode, counters):
    rng = np.random.default_rng(3)
    x, wp = _packed(rng, 21, 25, 7, 2, 64)
    _, wn = _packed(rng, 1, 25, 7, 2, 64)
    # the port takes both banks as one (K, 2 O, Wd) operand
    got_p, got_n = ops.sc_dot_posneg(_i32(x),
                                     _i32(np.concatenate([wp, wn], axis=1)),
                                     s0_mode=s0_mode)
    want_p, want_n = jops.sc_dot_posneg(jnp.asarray(x), jnp.asarray(wp),
                                        jnp.asarray(wn), s0_mode=s0_mode)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [9, 25])
@pytest.mark.parametrize("adder", ["tff", "ideal"])
def test_sc_dot_from_levels_vs_table(bits, K, adder, counters):
    N = 1 << bits
    rng = np.random.default_rng(bits + K)
    x_lvl = rng.integers(0, N + 1, (33, K)).astype(np.int32)
    w_lvl = rng.integers(0, N + 1, (K, 12)).astype(np.int32)
    got = ops.sc_dot_from_levels(torch.from_numpy(x_lvl),
                                 torch.from_numpy(w_lvl), bits,
                                 adder=adder).numpy()
    want = np.asarray(jsc.counts_via_table(
        jnp.asarray(x_lvl), jnp.asarray(w_lvl),
        jsc.SCConfig(bits=bits, adder=adder)))
    np.testing.assert_array_equal(got, want)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        lenet.init(0, lenet.LeNetConfig(8, 8, 8), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        MicroBatchGateway(GatewayConfig(), fe.FrontendSpec())   # default cuda
    assert sng_pack_kernel.sng_pack.launches == 0
