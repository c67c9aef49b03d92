"""The paged-attention kernels' plain versions (what the wrappers run for
CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernels against on
the card) against the reference's Pallas kernels in interpret mode, and the
port's plain paged attention against the reference's XLA body: float32
within 2e-5, bfloat16 within 2e-2, the row scatter bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attn as jpaged
from repro.nn import attention as jattn
from repro_torch.kernels import paged_attn, ref
from repro_torch.nn import attention

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

CASES = [                              # B, nb, bs, Hq, Hkv, D, dtype
    (3, 4, 8, 4, 4, 32, "float32"),    # MHA
    (2, 3, 16, 8, 2, 64, "float32"),   # GQA 4:1
    (4, 2, 8, 6, 6, 16, "bfloat16"),
    (1, 5, 4, 4, 1, 32, "float32"),    # MQA
    (3, 4, 16, 4, 4, 80, "bfloat16"),  # stablelm-3b's head width
]


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _case(rng, B, nb, bs, Hq, Hkv, D, dtype, full=False):
    """Inputs as numpy float32 (rounded to ``dtype``): each lane owns a
    distinct set of arena blocks (block 0 = trash); ``full`` gives every
    lane all nb blocks and lens of 1, a partial block and nb*bs."""
    num_blocks = B * nb + 1

    def arr(*shape):
        a = rng.normal(0, 1, shape).astype(np.float32)
        return np.array(jnp.asarray(a, dtype).astype(jnp.float32))
    q, ka, va = arr(B, Hq, D), arr(num_blocks, bs, Hkv, D), \
        arr(num_blocks, bs, Hkv, D)
    tables = np.zeros((B, nb), np.int32)
    lens = np.zeros((B,), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    for b in range(B):
        if full:
            lens[b] = (1, bs + 3, nb * bs)[b % 3]
        else:
            lens[b] = int(rng.integers(1, nb * bs + 1))
        used = nb if full else -(-int(lens[b]) // bs)
        tables[b, :used] = perm[b * nb:b * nb + used]
    k1, v1 = arr(B, Hkv, D), arr(B, Hkv, D)
    return q, ka, va, tables, lens, k1, v1


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) \
        if a.dtype == np.float32 else torch.from_numpy(np.array(a))


def _jax(a, dtype):
    return jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("window,splice,full", [
    (None, False, False), (3, True, False), (17, True, True),
    (None, True, True)])
def test_plain_kernel_matches_pallas_interpret(case, window, splice, full):
    B, nb, bs, Hq, Hkv, D, dtype = case
    rng = np.random.default_rng(B * nb * bs + D)
    q, ka, va, tables, lens, k1, v1 = _case(rng, *case, full=full)
    nk = (k1, v1) if splice else None
    got = paged_attn.paged_decode_attention(
        *(_torch(a, dtype) for a in (q, ka, va, tables, lens)),
        window=window,
        new_kv=None if nk is None else tuple(_torch(a, dtype) for a in nk))
    want = jpaged.paged_decode_attention(
        *(_jax(a, dtype) for a in (q, ka, va, tables, lens)), window=window,
        new_kv=None if nk is None else tuple(_jax(a, dtype) for a in nk),
        interpret=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


def test_plain_kernel_ignores_trash_block_contents():
    """Positions masked by ``lens`` never reach the result, whatever the
    trash block holds — not even NaN."""
    rng = np.random.default_rng(3)
    q, ka, va, tables, lens, _, _ = _case(rng, 2, 3, 4, 2, 2, 16, "float32")
    lens = np.array([5, 2], np.int32)
    tables[:, 2:] = 0
    tables[1, 1:] = 0
    args = [torch.from_numpy(a) for a in (q, ka, va, tables, lens)]
    base = paged_attn.paged_decode_attention(*args)
    args[1][0], args[2][0] = float("nan"), 1e9
    got = paged_attn.paged_decode_attention(*args)
    torch.testing.assert_close(got, base, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [0, 3])
def test_plain_paged_attention_matches_reference_xla(window):
    """attend_decode_paged(backend="plain") == the reference's XLA body,
    splice included; the last lane is at capacity (its splice index is
    past the view and is dropped, as the reference's mode="drop")."""
    rng = np.random.default_rng(11)
    B, nb, bs, Hq, Hkv, D = 3, 3, 4, 4, 2, 16
    q, ka, va, tables, _, k1, v1 = _case(rng, B, nb, bs, Hq, Hkv, D,
                                         "float32", full=True)
    lens = np.array([5, 11, nb * bs + 1], np.int32)
    got = attention.attend_decode_paged(
        torch.from_numpy(q[:, None]), *(torch.from_numpy(a) for a in
                                         (ka, va, tables, lens)),
        window=window, new_kv=(torch.from_numpy(k1), torch.from_numpy(v1)))
    want = jattn.attend_decode_paged(
        jnp.asarray(q[:, None]), *(jnp.asarray(a) for a in
                                   (ka, va, tables, lens)),
        window=window, new_kv=(jnp.asarray(k1), jnp.asarray(v1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_kernel_backend_on_cpu_runs_the_plain_kernel_version():
    rng = np.random.default_rng(5)
    q, ka, va, tables, lens, k1, v1 = _case(rng, 2, 3, 4, 4, 2, 16,
                                            "float32")
    t = [torch.from_numpy(a) for a in (q, ka, va, tables, lens, k1, v1)]
    before = paged_attn.paged_decode_attention.launches
    got = attention.attend_decode_paged(t[0][:, None], *t[1:5],
                                        new_kv=(t[5], t[6]), backend="cuda")
    want = ref.paged_decode_attention(*t[:5], None, (t[5], t[6]))
    assert torch.equal(got[:, 0], want)
    assert paged_attn.paged_decode_attention.launches == before
    with pytest.raises(ValueError):
        attention.attend_decode_paged(t[0][:, None], *t[1:5],
                                      backend="pallas")


def _scatter_case(rng, L, nb, bs, H, D, S, dtype):
    def arr(*shape):
        return jnp.asarray(rng.normal(size=shape), dtype)
    return arr(L, nb, 1, bs, H, D), arr(L, nb, 1, bs, H, D), \
        arr(L, S, H, D), arr(L, S, H, D)


def _to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wbids,offs", [
    ([2, 5, 1, 3], [1, 3, 0, 2]),          # unique targets
    ([0, 0, 2, 0], [1, 1, 3, 2]),          # trash-routed lanes collide
])
@pytest.mark.parametrize("form", ["stacked", "layers"])
def test_plain_scatter_matches_pallas_interpret_bitwise(dtype, wbids, offs,
                                                        form):
    """The rows stacked (L, S, Hkv, D), as the reference takes them, or as
    the tick passes them, one (S, Hkv, D) tensor per layer."""
    rng = np.random.default_rng(7)
    L, nb, bs, H, D, S = 3, 6, 4, 2, 8, 4
    ka, va, kr, vr = _scatter_case(rng, L, nb, bs, H, D, S, dtype)
    w, o = np.asarray(wbids, np.int32), np.asarray(offs, np.int32)
    nk, nv = jpaged.scatter_kv_rows(ka, va, kr, vr, jnp.asarray(w),
                                    jnp.asarray(o), interpret=True)
    tk, tv = _to_torch(ka), _to_torch(va)
    before = (tk.clone(), tv.clone())
    rows = (_to_torch(kr), _to_torch(vr))
    if form == "layers":
        rows = tuple([r[i].clone() for i in range(L)] for r in rows)
    out = paged_attn.scatter_kv_rows(tk, tv, *rows, torch.from_numpy(w),
                                     torch.from_numpy(o))
    assert out[0] is tk and out[1] is tv            # in place
    real = [b for b in range(1, nb)]                 # every non-trash block
    for got, want in ((tk, nk), (tv, nv)):
        assert torch.equal(got[:, real].float(),
                           torch.from_numpy(np.asarray(
                               want[:, real].astype(jnp.float32))))
    for b in set(range(1, nb)) - set(wbids):         # untouched, bit for bit
        assert torch.equal(tk[:, b], before[0][:, b])
        assert torch.equal(tv[:, b], before[1][:, b])
