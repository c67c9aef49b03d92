"""The attention backward of the training slice against the reference: the
plain version of the ``flash_attention_bwd`` kernel
(``ref.flash_attention_bwd_chunked``, which CPU tensors run) against
``jax.vjp`` of the reference's ``attend_chunked`` (its FA2 custom VJP,
``_flash_bwd``) and ``attend_sliding`` (``_sliding_bwd``), float32 within
1e-5 of each gradient's max |value|; the forward's log-sum-exp;
``attend_chunked`` without grad bit for bit the serving call; and the
kernel's head split plan (``bwd_head_split_plan``)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro_torch.kernels import flash_attn as flash_kernels
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attn import MIN_CTAS
from repro_torch.nn import attention

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

TOL = 1e-5
# the reference's programs are compiled with XLA's cheap optimization
# level: the same operations, at a third of the compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
CASES = {  # Sq, Sk, Hq, Hkv, causal, window, q_offset
    "causal": (40, 40, 4, 4, True, 0, 0),
    "windowed": (40, 40, 4, 4, True, 8, 0),
    "offset": (16, 48, 4, 4, True, 0, 32),
    "gqa_2to1": (40, 40, 4, 2, True, 0, 0),
    "noncausal_longer_keys": (20, 70, 4, 2, False, 0, 0),
}


def _inputs(Sq, Sk, Hq, Hkv, seed, D=16, B=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, Hkv, D)).astype(np.float32)
    g = rng.normal(0, 1, (B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.attend_chunked(*leaves, **kw)
    return out.detach(), torch.autograd.grad(out, leaves, torch.from_numpy(g))


def _reference_vjp(f, q, k, v, g):
    """(f(q, k, v), its vjp at g) through the reference, jitted and
    compiled at the ``FAST`` level."""
    def run(a, b, c, d):
        out, vjp = jax.vjp(f, a, b, c)
        return out, vjp(d)
    args = tuple(jnp.asarray(x) for x in (q, k, v, g))
    return jax.jit(run).lower(*args).compile(compiler_options=FAST)(*args)


def _assert_grads(got, want):
    for gt, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(gt.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (err, np.abs(w).max())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    Sq, Sk, Hq, Hkv, causal, window, q_offset = CASES[case]
    q, k, v, g = _inputs(Sq, Sk, Hq, Hkv, seed=len(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=16,
              kv_chunk=32)
    out, grads = _port_grads(q, k, v, g, **kw)
    jout, jgrads = _reference_vjp(
        lambda a, b, c: jattn.attend_chunked(a, b, c, **kw), q, k, v, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("q_offset", [0, 16])
def test_plain_backward_matches_reference_sliding(q_offset):
    """The reference's sliding layers (``attend_sliding``, true key
    skipping and its own VJP) compute the function the port's masked
    window computes: one Function covers both.  ``attend_sliding``'s
    ``q_offset`` shifts queries and keys together, so the port's call
    (which offsets the queries alone) is at offset 0 for both."""
    window = 12
    q, k, v, g = _inputs(48, 48, 4, 2, seed=7 + q_offset)
    _, grads = _port_grads(q, k, v, g, causal=True, window=window,
                           q_chunk=16)
    _, jgrads = _reference_vjp(
        lambda a, b, c: jattn.attend_sliding(a, b, c, window=window,
                                             q_offset=q_offset, q_chunk=16),
        q, k, v, g)
    _assert_grads(grads, jgrads)


@pytest.mark.parametrize("case", ["causal", "windowed",
                                  "noncausal_longer_keys"])
def test_forward_lse_is_the_rows_logsumexp(case):
    """``return_lse`` gives each row's float32 log-sum-exp of its masked
    scores (within 1e-5 of a float64 log-sum-exp) and leaves the output's
    bits as they were."""
    Sq, Sk, Hq, Hkv, causal, window, q_offset = CASES[case]
    q, k, v, _ = _inputs(Sq, Sk, Hq, Hkv, seed=3)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_kernels.flash_attention(
        qt, kt, vt, causal=causal, window=window, q_offset=q_offset,
        q_chunk=16, kv_chunk=32, return_lse=True)
    assert torch.equal(out, flash_kernels.flash_attention(
        qt, kt, vt, causal=causal, window=window, q_offset=q_offset,
        q_chunk=16, kv_chunk=32))
    kr = ref.repeat_kv(kt, Hq // Hkv).double()
    s = torch.einsum("bqhd,bkhd->bqhk", qt.double(), kr) * 16 ** -0.5
    rel = (q_offset + torch.arange(Sq))[:, None] - torch.arange(Sk)[None]
    mask = rel < (window or 1 << 30)
    if causal:
        mask &= rel >= 0
    s = torch.where(mask[None, :, None, :], s, -torch.inf)
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_forward_is_the_serving_call(dtype):
    """Without grad ``attend_chunked`` is the plain forward call; with grad
    its forward (``FlashAttention``) gives the same bits."""
    q, k, v, _ = _inputs(33, 33, 4, 2, seed=5)
    qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    kw = dict(causal=True, window=7, q_offset=0, q_chunk=16, kv_chunk=32)
    want = flash_kernels.flash_attention(qt, kt, vt, **kw)
    with torch.no_grad():
        assert torch.equal(attention.attend_chunked(qt, kt, vt, **kw), want)
    assert torch.equal(attention.attend_chunked(qt, kt, vt, **kw), want)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = attention.attend_chunked(*leaves, **kw)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), want)


def test_bf16_backward_rounds_ds_to_the_inputs_dtype():
    """In bf16 the plain backward keeps the reference's roundings (ds in
    the inputs' dtype, dout widened to float32): within 1e-2 of each
    gradient's max |value| of the float32 backward on the same rounded
    inputs, each gradient in bf16."""
    q, k, v, g = _inputs(40, 40, 4, 2, seed=11)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g)]
    kw = dict(causal=True, window=0, q_offset=0, q_chunk=16, kv_chunk=32)
    out, lse = flash_kernels.flash_attention(*bf[:3], return_lse=True, **kw)
    got = flash_kernels.flash_attention_bwd(*bf[:3], out, bf[3], lse, **kw)
    f32 = [t.float() for t in bf]
    out32, lse32 = flash_kernels.flash_attention(*f32[:3], return_lse=True,
                                                 **kw)
    want = flash_kernels.flash_attention_bwd(*f32[:3], out32, f32[3], lse32,
                                             **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) <= \
            1e-2 * float(b.abs().max())


# (B, Sk, Hkv, n_rep) over batch rows, key lengths (ragged last tiles
# included), KV heads and group sizes
PLAN_GRID = list(itertools.product((1, 2, 8), (1, 64, 130, 300, 1024, 1500,
                                               2048, 8192),
                                   (1, 2, 4, 5, 8, 32), (1, 2, 3, 5, 8, 12,
                                                         16)))


def _runs(B, Sk, Hkv, n_rep):
    """The plan's runs of each group's heads, as the dK/dV kernel takes
    them: split s covers ``[s * run, min(n_rep, (s + 1) * run))``."""
    splits, run = flash_kernels.bwd_head_split_plan(B, Sk, Hkv, n_rep)
    return splits, [range(s * run, min(n_rep, (s + 1) * run))
                    for s in range(splits)]


def _unsplit_ctas(B, Sk, Hkv):
    return -(-Sk // flash_kernels.TILE_K) * Hkv * B


def test_bwd_head_split_plan_covers_each_group_once_in_order():
    for shape in PLAN_GRID:
        splits, runs = _runs(*shape)
        assert splits >= 1 and all(len(r) > 0 for r in runs), shape
        assert [h for r in runs for h in r] == list(range(shape[3])), shape


def test_bwd_head_split_plan_keeps_full_grids_whole():
    """One split whenever the unsplit grid fills ``MIN_CTAS`` CTAs, and
    for MHA: stablelm-3b's train step (8 x 256, 32 heads) is never
    split."""
    for B, Sk, Hkv, n_rep in PLAN_GRID:
        if _unsplit_ctas(B, Sk, Hkv) >= MIN_CTAS or n_rep == 1:
            assert _runs(B, Sk, Hkv, n_rep)[0] == 1, (B, Sk, Hkv, n_rep)
    assert flash_kernels.bwd_head_split_plan(8, 256, 32, 1) == (1, 1)


def test_bwd_head_split_plan_fills_the_card():
    """A split grid reaches ``MIN_CTAS`` CTAs, or gives every head a CTA
    of its own."""
    for B, Sk, Hkv, n_rep in PLAN_GRID:
        splits, _ = _runs(B, Sk, Hkv, n_rep)
        if splits > 1:
            assert (splits * _unsplit_ctas(B, Sk, Hkv) >= MIN_CTAS
                    or splits == n_rep), (B, Sk, Hkv, n_rep)


def test_bwd_head_split_plan_is_a_function_of_the_shapes():
    """The same shapes give the same plan, whatever integer type carries
    them; the plans of the card's backward shapes (``chip_smoke.py``
    ``BWD_SHAPES`` and the split ``BWD_CASES`` of
    ``tests/test_torch_cuda.py``)."""
    for shape in PLAN_GRID[::7]:
        plan = flash_kernels.bwd_head_split_plan(*shape)
        assert flash_kernels.bwd_head_split_plan(
            *(np.int64(x) for x in shape)) == plan
        assert flash_kernels.bwd_head_split_plan(*shape) == plan
    want = {(8, 256, 32, 1): (1, 1), (1, 1024, 8, 8): (4, 2),
            (1, 1024, 4, 12): (6, 2), (1, 2048, 5, 5): (3, 2),
            (1, 1500, 16, 1): (1, 1), (1, 256, 2, 8): (8, 1),
            (1, 1500, 2, 4): (4, 1)}
    assert {s: flash_kernels.bwd_head_split_plan(*s) for s in want} == want
