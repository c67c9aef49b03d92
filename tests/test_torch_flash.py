"""The port's prompt attention against the reference on the same inputs
(numpy, seeded): the ``flash_attention`` kernel's plain version against the
Pallas ``flash_attention`` in interpret mode on the five cases of
``tests/test_flash_kernel.py`` (2e-5 float32, 2e-2 bfloat16, its own
tolerances), the oracle against the reference's oracle, and
``attend_chunked`` against the reference's at the fold's and the one-shot
prefill's forms (offsets, longer key ranges, windows, GQA 4:1, ragged
lengths) within 1e-5.  On CPU tensors the wrapper runs the plain version
and never counts a launch; the kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro_torch.kernels import flash_attn, ref
from repro_torch.nn import attention

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

PALLAS_CASES = [
    (4, 256, 64, 128, 128, True, "float32"),
    (2, 256, 128, 64, 128, False, "float32"),
    (8, 512, 64, 128, 64, True, "bfloat16"),
    (1, 128, 64, 64, 64, True, "float32"),
    (3, 384, 128, 128, 128, True, "bfloat16"),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax and a torch array (float32 to bfloat16
    rounds to nearest even in both)."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(j, np.float32),
                                  t.float().numpy())
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("BH,S,D,qc,kc,causal,dtype", PALLAS_CASES)
def test_plain_version_matches_pallas_kernel(BH, S, D, qc, kc, causal,
                                             dtype):
    rng = np.random.default_rng(BH * S)
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.normal(0, 1, (BH, S, D)).astype(np.float32), dtype)
        for _ in range(3))
    want = jflash.flash_attention(jq, jk, jv, causal=causal, qc=qc, kc=kc,
                                  interpret=True)
    before = flash_attn.flash_attention.launches
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert flash_attn.flash_attention.launches == before
    assert got.dtype == q.dtype and got.shape == (BH, S, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got.float(), want, tol)
    _close(ref.flash_attention(q, k, v, causal).float(),
           jref.flash_attention(jq, jk, jv, causal=causal), tol)


# (Sq, Sk, q_offset, Hq, Hkv, window): the fold's chunks (full and
# partial, at offsets into a longer key range, a window shorter than the
# prefix), one-shot prefill, GQA 4:1, lengths no chunk size divides
ATTEND_CASES = [
    (4, 4, 0, 4, 4, 0),
    (4, 12, 8, 4, 4, 0),
    (3, 11, 8, 4, 1, 0),
    (4, 20, 16, 8, 2, 8),
    (3, 23, 20, 4, 1, 8),
    (13, 13, 0, 8, 2, 8),
    (37, 37, 0, 8, 2, 0),
    (16, 1072, 1056, 4, 1, 0),
]


@pytest.mark.parametrize("Sq,Sk,q_offset,Hq,Hkv,window", ATTEND_CASES)
def test_attend_chunked_matches_reference(Sq, Sk, q_offset, Hq, Hkv,
                                          window):
    rng = np.random.default_rng(Sq * 7 + Sk)
    D = 40
    q = rng.normal(0, 1, (2, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (2, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (2, Sk, Hkv, D)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset, q_chunk=8,
              kv_chunk=16)
    got = attention.attend_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, 1e-5)
    # the chunking is the plain version's own: one chunk gives the same
    whole = attention.attend_chunked(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, window=window,
                                     q_offset=q_offset, q_chunk=Sq,
                                     kv_chunk=Sk)
    _close(whole, want, 1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor never reaches the kernel: the wrapper returns the plain
    version bit for bit, for the (BH, S, D) and the (B, S, H, D) forms,
    and leaves the launch count where it was."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 9, 8, 40), generator=gen)
    k = torch.randn((2, 25, 2, 40), generator=gen)
    v = torch.randn((2, 25, 2, 40), generator=gen)
    flash_attn.flash_attention.launches = 0
    got = flash_attn.flash_attention(q, k, v, window=8, q_offset=16,
                                     q_chunk=4, kv_chunk=8)
    assert torch.equal(got, ref.flash_attention_chunked(
        q, k, v, True, 8, 16, 4, 8))
    q3, k3 = q[:, :, 0].contiguous(), k[:, :9, 0].contiguous()
    v3 = v[:, :9, 0].contiguous()
    got3 = flash_attn.flash_attention(q3, k3, v3, causal=False)
    assert torch.equal(got3, ref.flash_attention_chunked(
        q3[:, :, None], k3[:, :, None], v3[:, :, None], False)[:, :, 0])
    assert flash_attn.flash_attention.launches == 0


def test_plain_version_first_tile_quirk_matches_reference():
    """Rows whose first key chunk is wholly outside their window get p = 1
    on it while their max is still -1e30; the first real key wipes that
    (corr = 0), in the port's plain version as in the reference."""
    rng = np.random.default_rng(5)
    q = rng.normal(0, 1, (1, 6, 2, 16)).astype(np.float32)
    k = rng.normal(0, 1, (1, 40, 2, 16)).astype(np.float32)
    v = rng.normal(0, 50, (1, 40, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=3, q_offset=34, q_chunk=6, kv_chunk=8)
    got = attention.attend_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, 1e-5)
    naive = ref.flash_attention_chunked(
        *map(torch.from_numpy, (q, k, v)), True, 3, 34, 6, 40)
    _close(got, naive, 1e-5)
