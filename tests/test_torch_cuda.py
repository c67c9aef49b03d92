"""The port's CUDA kernels against their plain versions on the card, bit for
bit, the frame stages on the card against the CPU, and the captured steps
(frame buckets, the flat and cascade ticks) against their eager calls.
Without a CUDA device every test here skips; on a card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import configs, kernels
from repro_torch.core import sng
from repro_torch.kernels import flash_attn as flash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attn as paged_attn_kernel
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel
from repro_torch.models import lenet, lm
from repro_torch.nn import attention
from repro_torch.serve import capture
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.gateway import GatewayConfig, MicroBatchGateway
from repro_torch.serve.gateway.slots import Request, make_adapter
from repro_torch.serve.spec import ServeSpec, make_gateway

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(gen, *shape, dev):
    return torch.randint(-2**31, 2**31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)


@pytest.mark.parametrize("bits", [2, 4, 5, 8])
def test_sng_pack_kernel_bitwise(dev, bits):
    """Both LFSR schemes (codes that skip 0; ``lfsr_shared`` rolls), levels
    outside [0, N] (direct comparison), and a level tensor off 16-byte
    alignment (the level-by-level kernel)."""
    N = 1 << bits
    gen = torch.Generator().manual_seed(bits)
    lv = torch.randint(-2, N + 3, (517, 25), generator=gen,
                       dtype=torch.int32)
    lv.view(-1)[:4] = torch.tensor([-1, N + 1, -2**31, 2**31 - 1])
    lv = lv.to(dev)
    before = sng_pack_kernel.sng_pack.launches
    for scheme in ("lfsr_pair", "lfsr_shared"):
        for codes in sng.codes_tensors(scheme, bits, dev):
            for levels in (lv, lv.view(-1)[3:]):
                got = ops.sng_pack(levels, codes, N)
                assert torch.equal(got, ref.sng_pack(levels, codes, N))
    assert sng_pack_kernel.sng_pack.launches == before + 8


@pytest.mark.parametrize("M,K,O,Wd", [
    (1, 2, 1, 1), (77, 25, 40, 1), (300, 64, 33, 8), (9, 1024, 5, 2),
    (517, 1, 16, 3), (1001, 3, 200, 8), (333, 1000, 64, 5), (2049, 25, 16, 4),
    (130, 33, 1, 6), (65, 25, 64, 7)])
@pytest.mark.parametrize("s0_mode,adder", [
    ("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")])
def test_sc_dot_kernel_bitwise(dev, M, K, O, Wd, s0_mode, adder):
    """K not a power of two (no pad: the kernel's zero leaves), every Wd
    from 1 to 8, O from 1 to 200, M off every tile."""
    gen = torch.Generator().manual_seed(M + K)
    x, w = _words(gen, M, K, Wd, dev=dev), _words(gen, K, O, Wd, dev=dev)
    before = sc_dot_kernel.sc_dot.launches
    got = ops.sc_dot(x, w, s0_mode=s0_mode, adder=adder)
    assert sc_dot_kernel.sc_dot.launches == before + 1
    assert torch.equal(got, ops.sc_dot(x.cpu(), w.cpu(), s0_mode=s0_mode,
                                       adder=adder).to(dev))


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("K", [1, 3, 25, 1000])
@pytest.mark.parametrize("s0_mode,adder", [
    ("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")])
def test_sc_dot_kernel_packed_streams_bitwise(dev, N, K, s0_mode, adder):
    """Streams of N <= 16 bits with their length stated: two leaves (the
    ideal adder 32 / N) per popcount."""
    gen = torch.Generator().manual_seed(N * K)
    x = _words(gen, 301, K, 1, dev=dev) & ((1 << N) - 1)
    w = _words(gen, K, 16, 1, dev=dev) & ((1 << N) - 1)
    got = ops.sc_dot(x, w, s0_mode=s0_mode, adder=adder, length=N)
    assert torch.equal(got, ref.sc_dot(x, w, s0_mode, adder))


@pytest.mark.parametrize("mma", [True, False])
@pytest.mark.parametrize("K,O", [(25, 64), (25, 16), (33, 37), (512, 9)])
def test_sc_dot_kernel_routes_bitwise(dev, mma, K, O, monkeypatch):
    """N = 256 on the b1 tensor cores and on the popcounts (the tensor-core
    route's leaf limit patched to 0, as the timing does), and the two weight
    banks of the split-weight layer as one operand; K = 512 and an X off
    16-byte alignment take the popcounts in any case."""
    if not mma:
        monkeypatch.setattr(sc_dot_kernel, "MMA_MAX_LEAVES", 0)
    gen = torch.Generator().manual_seed(K + O)
    x, w = _words(gen, 1000, K, 8, dev=dev), _words(gen, K, O, 8, dev=dev)
    want = ref.sc_dot(x, w, "alt", "tff")
    assert torch.equal(sc_dot_kernel.sc_dot(x, w, length=256), want)
    if O % 2 == 0:
        pos, neg = ops.sc_dot_posneg(x, w, length=256)
        h = O // 2
        assert torch.equal(pos, want[:, :h]) and torch.equal(neg, want[:, h:])
    shifted = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
    x_off = shifted[1:].view(x.shape)
    x_off.copy_(x)
    assert torch.equal(sc_dot_kernel.sc_dot(x_off, w, length=256), want)


def test_sc_kernels_never_reach_ref_on_card(dev, monkeypatch):
    """A CUDA tensor launches the kernel or raises: the plain versions are
    not called, and nothing moves to the CPU."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    gen = torch.Generator().manual_seed(3)
    x, w = _words(gen, 64, 25, 1, dev=dev), _words(gen, 25, 8, 1, dev=dev)
    lv = torch.randint(0, 17, (64, 25), generator=gen,
                       dtype=torch.int32).to(dev)
    codes = sng.codes_tensors("ramp_lowdisc", 4, dev)[0]
    monkeypatch.setattr(ref, "sc_dot", refuse)
    monkeypatch.setattr(ref, "sng_pack", refuse)
    assert ops.sng_pack(lv, codes, 16).is_cuda
    assert ops.sc_dot(x, w).is_cuda
    assert all(t.is_cuda for t in ops.sc_dot_posneg(x, w, length=16))
    with pytest.raises(ValueError):
        sc_dot_kernel.sc_dot(x, torch.zeros((25, 3, 2), dtype=torch.int32,
                                            device=dev))


def test_sc_dot_kernel_refuses_bad_shapes(dev):
    """Any K is taken now (K = 1,025 as the plain version computes it);
    mismatched K or Wd and Wd past 8 are refused."""
    x = torch.zeros((4, 24, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc_dot_kernel.sc_dot(x, torch.zeros((23, 3, 1), dtype=torch.int32,
                                            device=dev))
    gen = torch.Generator().manual_seed(1025)
    x, w = _words(gen, 4, 1025, 1, dev=dev), _words(gen, 1025, 3, 1, dev=dev)
    assert torch.equal(sc_dot_kernel.sc_dot(x, w),
                       ref.sc_dot(x, w, "alt", "tff"))
    with pytest.raises(ValueError):
        sc_dot_kernel.sc_dot(torch.zeros((4, 2, 9), dtype=torch.int32,
                                         device=dev),
                             torch.zeros((2, 3, 9), dtype=torch.int32,
                                         device=dev))


@pytest.mark.parametrize("K,Wd,N", [(1025, 1, 16), (2560, 1, 16),
                                    (2560, 1, None), (2560, 8, 256),
                                    (4096, 2, None)])
@pytest.mark.parametrize("s0_mode,adder", [
    ("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")])
def test_sc_dot_kernel_beyond_1024_bitwise(dev, K, Wd, N, s0_mode, adder):
    """K > 1,024 (subtrees of 1,024 leaves, then the fold): stablelm-3b's
    d_model K = 2,560 as the SC frontend calls it, both banks as one
    operand, and a power of two; one launch count per call."""
    gen = torch.Generator().manual_seed(K + Wd)
    x, w = _words(gen, 37, K, Wd, dev=dev), _words(gen, K, 10, Wd, dev=dev)
    if N is not None and N < 32:
        x, w = x & ((1 << N) - 1), w & ((1 << N) - 1)
    want = ref.sc_dot(x, w, s0_mode, adder)
    before = sc_dot_kernel.sc_dot.launches
    pos, neg = ops.sc_dot_posneg(x, w, s0_mode=s0_mode, adder=adder,
                                 length=N)
    assert sc_dot_kernel.sc_dot.launches == before + 1
    assert torch.equal(torch.cat([pos, neg], 1), want)


@pytest.mark.parametrize("bits", [4, 8])
def test_frame_stages_on_card_match_cpu(dev, bits):
    cfg = lenet.LeNetConfig()
    params = lenet.init(0, cfg, device="cpu")
    spec = fe.FrontendSpec(mode="sc", bits=bits, lenet=cfg)
    frames = torch.from_numpy(np.random.default_rng(bits).integers(
        0, 256, (4, 28, 28, 1), dtype=np.uint8))
    on_card = {k: {n: t.to(dev) for n, t in v.items()}
               for k, v in params.items()}
    payload = fe.sensor_stage(on_card, frames.to(dev), spec)
    cpu_payload = fe.sensor_stage(params, frames, spec)
    assert torch.equal(payload.cpu(), cpu_payload)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        logits = fe.gateway_stage(on_card, payload, spec).cpu()
    torch.testing.assert_close(logits, fe.gateway_stage(params, cpu_payload,
                                                        spec),
                               atol=1e-4, rtol=1e-4)


# -- paged KV cache kernels ---------------------------------------------------

def _paged_case(gen, B, nb, bs, Hq, Hkv, D, dtype, dev):
    num_blocks = B * nb + 1

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    tables = torch.randperm(num_blocks - 1, generator=gen)[:B * nb].add(1) \
        .reshape(B, nb).to(torch.int32)
    lens = torch.randint(1, nb * bs + 1, (B,), generator=gen,
                         dtype=torch.int32)
    lens[0] = nb * bs
    return (arr(B, Hq, D), arr(num_blocks, bs, Hkv, D),
            arr(num_blocks, bs, Hkv, D), tables.to(dev), lens.to(dev),
            arr(B, Hkv, D), arr(B, Hkv, D))


@pytest.mark.parametrize("B,nb,bs,Hq,Hkv,D", [
    (3, 4, 8, 4, 4, 32), (2, 3, 16, 8, 2, 64), (1, 5, 4, 4, 1, 32),
    (8, 6, 16, 32, 32, 80), (2, 3, 16, 4, 4, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,splice", [(None, False), (3, True),
                                           (17, True)])
def test_paged_decode_attention_kernel(dev, B, nb, bs, Hq, Hkv, D, dtype,
                                       window, splice):
    gen = torch.Generator().manual_seed(B * D + bs)
    q, ka, va, tables, lens, k1, v1 = _paged_case(gen, B, nb, bs, Hq, Hkv,
                                                  D, dtype, dev)
    nk = (k1, v1) if splice else None
    before = paged_attn_kernel.paged_decode_attention.launches
    got = paged_attn_kernel.paged_decode_attention(
        q, ka, va, tables, lens, window=window, new_kv=nk)
    assert paged_attn_kernel.paged_decode_attention.launches == before + 1
    want = ref.paged_decode_attention(q, ka, va, tables, lens, window, nk)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_scatter_kv_rows_kernel_bitwise(dev):
    gen = torch.Generator().manual_seed(0)
    L, nbk, bs, H, D, S = 4, 9, 16, 4, 80, 5
    ka = torch.randn((L, nbk, 1, bs, H, D), generator=gen).bfloat16().to(dev)
    va = torch.randn((L, nbk, 1, bs, H, D), generator=gen).bfloat16().to(dev)
    kr = torch.randn((L, S, H, D), generator=gen).bfloat16().to(dev)
    vr = torch.randn((L, S, H, D), generator=gen).bfloat16().to(dev)
    wbids = torch.tensor([3, 0, 7, 0, 1], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 5, 15, 5, 9], dtype=torch.int32, device=dev)
    rk, rv = ref.scatter_kv_rows(ka.clone(), va.clone(), kr, vr, wbids, offs)
    paged_attn_kernel.scatter_kv_rows(ka, va, kr, vr, wbids, offs)
    assert torch.equal(ka[:, 1:], rk[:, 1:]) and torch.equal(va[:, 1:],
                                                             rv[:, 1:])


@pytest.mark.parametrize("L,H,D", [(32, 32, 80), (130, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kv_rows_kernel_from_layers_bitwise(dev, L, H, D, dtype):
    """The rows as the tick passes them, one (S, Hkv, D) tensor per layer:
    bit for bit the stacked form and the plain version, at stablelm-3b's
    32 layers and at 130 (two launches of at most 128 layers' pointers);
    one wrapper call each."""
    gen = torch.Generator().manual_seed(L)
    nbk, bs, S = 9, 16, 5

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    ka, va = arr(L, nbk, 1, bs, H, D), arr(L, nbk, 1, bs, H, D)
    kr, vr = arr(L, S, H, D), arr(L, S, H, D)
    layers = ([r.clone() for r in kr], [r.clone() for r in vr])
    wbids = torch.tensor([3, 0, 7, 0, 1], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 5, 15, 5, 9], dtype=torch.int32, device=dev)
    rk, rv = ref.scatter_kv_rows(ka.clone(), va.clone(), kr, vr, wbids, offs)
    out = {}
    for form, rows in (("stacked", (kr, vr)), ("layers", layers)):
        a, b = ka.clone(), va.clone()
        n = paged_attn_kernel.scatter_kv_rows.launches
        paged_attn_kernel.scatter_kv_rows(a, b, *rows, wbids, offs)
        assert paged_attn_kernel.scatter_kv_rows.launches == n + 1
        out[form] = (a, b)
    for a, b in out.values():
        assert torch.equal(a[:, 1:], rk[:, 1:]) and \
            torch.equal(b[:, 1:], rv[:, 1:])
    # the trash block 0 takes colliding lanes in either order
    assert all(torch.equal(x[:, 1:], y[:, 1:])
               for x, y in zip(out["stacked"], out["layers"]))


def test_paged_kernels_refuse_bad_inputs(dev):
    q = torch.zeros((2, 4, 20), dtype=torch.bfloat16, device=dev)
    a = torch.zeros((5, 4, 4, 20), dtype=torch.bfloat16, device=dev)
    t = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):               # 40-byte rows
        paged_attn_kernel.paged_decode_attention(q, a, a, t, t[:, 0].clone())
    with pytest.raises(TypeError):
        paged_attn_kernel.paged_decode_attention(
            q.float()[..., :16].contiguous(), a[..., :16].contiguous(),
            a[..., :16].contiguous(), t, t[:, 0].clone())


# -- cascade decode kernels ---------------------------------------------------

def _cascade_case(gen, Hq, Hkv, D, dtype, dev, bs=16):
    """``tests/test_cascade.py``'s fixture at a 16-token block: lanes 0-2
    share a 3-block prefix (lane 1 ends 3 positions past it, lane 4 exactly
    at it), lane 3 is ungrouped, the group's slots 5-7 are padding, and
    the trash block 0 holds NaN."""
    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    ka, va = arr(25, bs, Hkv, D), arr(25, bs, Hkv, D)
    ka[0], va[0] = float("nan"), float("nan")
    i32 = dict(dtype=torch.int32, device=dev)
    q0 = 3 * bs
    meta = {"group_tables": torch.tensor([[1, 2, 3, 0]], **i32),
            "group_len": torch.tensor([q0], **i32),
            "group_lanes": torch.tensor([[0, 1, 2, 4, 0, 0, 0, 0]], **i32),
            "group_mask": torch.tensor([[1, 1, 1, 1, 0, 0, 0, 0]],
                                       device=dev) != 0,
            "lane_q0": torch.tensor([q0, q0, q0, 0, q0], **i32),
            "suffix_tables": torch.tensor(
                [[10, 11, 0, 0], [12, 0, 0, 0], [13, 14, 15, 0],
                 [4, 5, 6, 7], [16, 0, 0, 0]], **i32)}
    cl = torch.tensor([q0 + 22, q0 + 3, q0 + 40, 50, q0], **i32)
    return (arr(5, Hq, D), ka, va, cl, (arr(5, Hkv, D), arr(5, Hkv, D)),
            meta)


@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 80), (8, 8, 80), (4, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 8, 2])
def test_cascade_kernels_match_plain(dev, Hq, Hkv, D, dtype, window):
    gen = torch.Generator().manual_seed(Hq * D + window)
    q, ka, va, cl, nk, meta = _cascade_case(gen, Hq, Hkv, D, dtype, dev)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    lanes = meta["group_lanes"].long()
    pre_args = (q[lanes].contiguous(), ka, va, meta["group_tables"],
                meta["group_len"], cl[lanes].contiguous())
    suf_args = (q, ka, va, meta["suffix_tables"], cl)
    launches = (paged_attn_kernel.cascade_prefix_attention.launches,
                paged_attn_kernel.paged_decode_attention_with_state.launches)
    got_pre = paged_attn_kernel.cascade_prefix_attention(*pre_args,
                                                         window=window)
    got_suf = paged_attn_kernel.paged_decode_attention_with_state(
        *suf_args, window=window, q0=meta["lane_q0"], new_kv=nk)
    assert (paged_attn_kernel.cascade_prefix_attention.launches,
            paged_attn_kernel.paged_decode_attention_with_state.launches) == \
        (launches[0] + 1, launches[1] + 1)
    want_pre = ref.cascade_prefix_attention(*pre_args, window)
    want_suf = ref.paged_decode_attention_with_state(
        *suf_args, window, meta["lane_q0"], nk)
    for g, w in zip(got_pre + got_suf, want_pre + want_suf):
        assert g.dtype == torch.float32 and not torch.isnan(g).any()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    # lane 4's suffix is empty: the exact empty state
    assert torch.equal(got_suf[0][4], torch.zeros_like(got_suf[0][4]))
    assert torch.equal(got_suf[2][4], torch.zeros_like(got_suf[2][4]))
    assert bool((got_suf[1][4] == ref.NEG_INF).all())
    # the whole cascade against flat attention for lanes 0-3 (the plain
    # flat version multiplies the trash block's rows by 0, so it gets a
    # clean one; lane 4's new row would fall inside the prefix there)
    out = attention.attend_decode_cascade(
        q[:, None], ka, va, attention.with_lane_meta(meta, cl), cl,
        window=window, new_kv=nk)
    ka[0], va[0] = 0, 0
    tables = torch.tensor([[1, 2, 3, 10, 11, 0], [1, 2, 3, 12, 0, 0],
                           [1, 2, 3, 13, 14, 15], [4, 5, 6, 7, 0, 0]],
                          dtype=torch.int32, device=dev)
    flat = ref.paged_decode_attention(q[:4], ka, va, tables, cl[:4], window,
                                      (nk[0][:4], nk[1][:4]))
    torch.testing.assert_close(out[:4, 0].float(), flat.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_kernels_forced_plans(monkeypatch, dev, plan, Hq, Hkv,
                                      dtype):
    """``cascade_prefix_attention`` over a 19-block chain in a 20-entry
    table (the last entry trash, so a one-block split lies past
    ``group_len``) and ``paged_decode_attention_with_state`` over 8-entry
    suffix tables from q0 = 304 (lens from q0 to q0 + 64, so later splits
    hold no position of short lanes), windows 0, 100 (clipping inside the
    chain) and 2 (most prefix states empty), at each forced plan against
    the plain versions; empty states exactly; the NaN trash block bitwise;
    one launch per call and no host synchronization."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    gen = torch.Generator().manual_seed(Hq * 7 + Hkv)
    bs, npre, nsuf, D, q0 = 16, 20, 8, 80, 304
    Lc, B = 4, 5
    num_blocks = npre + B * nsuf + 1

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ka, va = arr(num_blocks, bs, Hkv, D), arr(num_blocks, bs, Hkv, D)
    perm = (torch.randperm(num_blocks - 1, generator=gen) + 1).to(dev)
    gt = perm[:npre].to(torch.int32)[None].contiguous()
    gt[0, -1] = 0
    suf = torch.tensor([0, 1, 17, 40, 64], **i32)
    lens = q0 + suf
    st = perm[npre:npre + B * nsuf].to(torch.int32).reshape(B, nsuf)
    st[torch.arange(nsuf, device=dev)[None] * bs >= suf[:, None]] = 0
    q, nk = arr(B, Hq, D), (arr(B, Hkv, D), arr(B, Hkv, D))
    pre = (q[1:].contiguous()[None], ka, va, gt,
           torch.tensor([q0], **i32), lens[1:].contiguous()[None])
    sfx = (q, ka, va, st.contiguous(), lens)
    q0s = torch.full((B,), q0, **i32)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for window in (0, 100, 2):
        got = {}
        for trash in (1e9, float("nan")):
            ka[0], va[0] = trash, -trash
            counts = (
                paged_attn_kernel.cascade_prefix_attention.launches,
                paged_attn_kernel.paged_decode_attention_with_state.launches)
            torch.cuda.set_sync_debug_mode("error")
            try:
                got[trash == trash] = paged_attn_kernel \
                    .cascade_prefix_attention(*pre, window=window) + \
                    paged_attn_kernel.paged_decode_attention_with_state(
                        *sfx, window=window, q0=q0s, new_kv=nk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert (paged_attn_kernel.cascade_prefix_attention.launches,
                    paged_attn_kernel.paged_decode_attention_with_state
                    .launches) == (counts[0] + 1, counts[1] + 1)
        want = ref.cascade_prefix_attention(*pre, window) + \
            ref.paged_decode_attention_with_state(*sfx, window, q0s, nk)
        for g, w in zip(got[True], want):
            assert g.dtype == torch.float32 and not torch.isnan(g).any()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
        for acc, m, l in (got[True][:3], got[True][3:]):
            empty = m == ref.NEG_INF
            assert bool((l[empty] == 0).all() and (acc[empty] == 0).all())
        # lane 0's suffix is empty at every window
        assert bool((got[True][4][0] == ref.NEG_INF).all())
        if window == 2:           # lanes 2-4 attend no prefix position
            assert bool((got[True][1][0, 1:] == ref.NEG_INF).all())


@pytest.mark.parametrize("Lc,Hq,Hkv,D", [(64, 32, 32, 80), (16, 64, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_prefix_kernel_large_groups(dev, Lc, Hq, Hkv, D, dtype):
    """Groups whose queries overflow one CTA's shared memory, swept in
    tiles of queries: 64 stablelm-3b lanes (MHA, D = 80) and 16 lanes at
    GQA 8:1 and D = 128, over a 128-position chain ending 5 short of its
    last block, lanes ending up to 63 positions past it, windows 0 and 100,
    against the plain version; one launch per call."""
    gen = torch.Generator().manual_seed(Lc + D)
    bs = 16

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ka, va = arr(9, bs, Hkv, D), arr(9, bs, Hkv, D)
    gt = torch.arange(1, 9, **i32)[None]
    glen = torch.tensor([8 * bs - 5], **i32)
    ll = (glen.cpu() + torch.randint(0, 64, (1, Lc), generator=gen,
                                     dtype=torch.int32)).to(dev)
    pre = (arr(1, Lc, Hq, D), ka, va, gt, glen, ll)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    lib = paged_attn_kernel._cascade_lib()
    assert lib.cascade_prefix_smem_bytes(Lc, Hq // Hkv, D,
                                         paged_attn_kernel.DTYPES[dtype]) \
        <= paged_attn_kernel.MAX_SMEM_BYTES
    for window in (0, 100):
        n = paged_attn_kernel.cascade_prefix_attention.launches
        got = paged_attn_kernel.cascade_prefix_attention(*pre, window=window)
        assert paged_attn_kernel.cascade_prefix_attention.launches == n + 1
        want = ref.cascade_prefix_attention(*pre, window)
        for g, w in zip(got, want):
            assert not torch.isnan(g).any()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def _fused_against_composition(prefix, meta, suffix, window, q0, nk, tol):
    """The suffix pass with the merge fused in, on the prefix states
    ``prefix``: one wrapper call and one fused merge, no standalone merge
    launch and no host synchronization; bit for bit the state, the placed
    group states, ``merge_attn_states`` and the cast; within ``tol`` of
    its plain version."""
    wrap = paged_attn_kernel.paged_decode_attention_with_state
    counts = (wrap.launches, wrap.fused_merges,
              paged_attn_kernel.merge_attn_states.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = wrap(*suffix, window=window, q0=q0, new_kv=nk,
                   prefix=prefix + (meta["lane_slot"],))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (wrap.launches, wrap.fused_merges,
            paged_attn_kernel.merge_attn_states.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2])
    state = wrap(*suffix, window=window, q0=q0, new_kv=nk)
    want = paged_attn_kernel.merge_attn_states(
        *attention.place_group_states(meta, *prefix, suffix[0].shape[0]),
        *state).to(got.dtype)
    assert got.dtype == suffix[1].dtype and torch.equal(got, want)
    plain = ref.paged_decode_attention_merged(
        *suffix, window, q0, nk, prefix + (meta["lane_slot"],))
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol,
                               atol=tol)
    return got


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_fused_merge_bitwise_forced_plans(monkeypatch, dev, plan, Hq,
                                                  Hkv, dtype):
    """The merge fused into the suffix pass's epilogue, at each forced plan
    of the pass, on the fixture: padded group slots, lane 3 in no group,
    lane 4's empty suffix, windows 0, 8 and 2 (2 empties the lanes'
    prefixes), and lane 3 at length 0 (both sides empty: exactly 0)."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    gen = torch.Generator().manual_seed(Hq * 5 + Hkv)
    q, ka, va, cl, nk, meta = _cascade_case(gen, Hq, Hkv, 80, dtype, dev)
    meta = attention.with_lane_meta(meta, cl)
    lanes = meta["group_lanes"].long()
    cl0 = cl.clone()
    cl0[3] = 0
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for window in (0, 8, 2):
        prefix = paged_attn_kernel.cascade_prefix_attention(
            q[lanes].contiguous(), ka, va, meta["group_tables"],
            meta["group_len"], meta["lane_lens"], window=window)
        for lens in (cl, cl0):
            got = _fused_against_composition(
                prefix, meta, (q, ka, va, meta["suffix_tables"], lens),
                window, meta["lane_q0"], nk, tol)
            assert not torch.isnan(got).any()
        assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("Lc,Hq,Hkv,D", [(64, 32, 32, 80), (16, 64, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_fused_merge_large_groups(monkeypatch, dev, plan, Lc, Hq,
                                          Hkv, D, dtype):
    """The fused merge on the groups of
    ``test_cascade_prefix_kernel_large_groups`` (64 stablelm-3b lanes; GQA
    8:1 at D = 128), each lane's suffix from the chain's end up to 63
    positions on in its own 4-entry table, windows 0 and 100, at each
    forced plan: bit for bit the composition."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    gen = torch.Generator().manual_seed(Lc * 3 + D)
    bs = 16

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ka, va = arr(9 + 4 * Lc, bs, Hkv, D), arr(9 + 4 * Lc, bs, Hkv, D)
    gt = torch.arange(1, 9, **i32)[None]
    glen = torch.tensor([8 * bs - 5], **i32)
    ll = (glen.cpu() + torch.randint(0, 64, (1, Lc), generator=gen,
                                     dtype=torch.int32)).to(dev)
    meta = attention.with_lane_meta(
        {"group_lanes": torch.arange(Lc, **i32)[None],
         "group_mask": torch.ones((1, Lc), dtype=torch.bool, device=dev)},
        ll[0])
    qg = arr(1, Lc, Hq, D)
    nk = (arr(Lc, Hkv, D), arr(Lc, Hkv, D))
    st = torch.arange(9, 9 + 4 * Lc, **i32).reshape(Lc, 4)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for window in (0, 100):
        prefix = paged_attn_kernel.cascade_prefix_attention(
            qg, ka, va, gt, glen, ll, window=window)
        _fused_against_composition(
            prefix, meta, (qg[0], ka, va, st, ll[0]), window,
            glen.expand(Lc).contiguous(), nk, tol)


def test_merge_attn_states_kernel(dev):
    gen = torch.Generator().manual_seed(3)
    B, Hq, D = 8, 32, 80

    def state():
        return (torch.randn((B, Hq, D), generator=gen).to(dev),
                torch.randn((B, Hq), generator=gen).to(dev),
                torch.rand((B, Hq), generator=gen).add(0.5).to(dev))
    a, b = state(), state()
    e = (torch.zeros_like(a[0]), torch.full_like(a[1], ref.NEG_INF),
         torch.zeros_like(a[2]))
    before = paged_attn_kernel.merge_attn_states.launches
    got = paged_attn_kernel.merge_attn_states(*a, *b)
    assert paged_attn_kernel.merge_attn_states.launches == before + 1
    torch.testing.assert_close(got, ref.merge_attn_states(*a, *b),
                               rtol=2e-5, atol=2e-5)
    for args in (e + b, a + e, e + e):          # an empty side drops out
        assert torch.equal(paged_attn_kernel.merge_attn_states(*args),
                           ref.merge_attn_states(*args))
    assert torch.equal(paged_attn_kernel.merge_attn_states(*e, *e),
                       torch.zeros_like(a[0]))


def test_cascade_kernels_refuse_bad_inputs(dev):
    q = torch.zeros((1, 2, 4, 20), dtype=torch.bfloat16, device=dev)
    a = torch.zeros((5, 4, 4, 20), dtype=torch.bfloat16, device=dev)
    t = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):               # 40-byte rows
        paged_attn_kernel.cascade_prefix_attention(q, a, a, t, t[:, 0],
                                                   t.clone())
    with pytest.raises(ValueError):               # lane_lens (1, 1)
        paged_attn_kernel.cascade_prefix_attention(
            q[..., :16].contiguous(), a[..., :16].contiguous(),
            a[..., :16].contiguous(), t, t[:, 0], t[:, :1].contiguous())
    s = torch.zeros((2, 4), device=dev)
    with pytest.raises(TypeError):
        paged_attn_kernel.merge_attn_states(s[..., None].double(), s, s,
                                            s[..., None], s, s)


# -- prompt attention kernel ----------------------------------------------------

def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("BH,S,D,causal,dtype", [
    (4, 256, 64, True, torch.float32), (2, 256, 128, False, torch.float32),
    (8, 512, 64, True, torch.bfloat16), (1, 128, 64, True, torch.float32),
    (3, 384, 128, True, torch.bfloat16)])
def test_flash_attention_kernel_pallas_cases(dev, BH, S, D, causal, dtype):
    """The TPU kernel's own cases (``tests/test_flash_kernel.py``): the
    kernel against its plain version and against the oracle."""
    gen = torch.Generator().manual_seed(BH * S)
    q, k, v = (torch.randn((BH, S, D), generator=gen).to(dtype).to(dev)
               for _ in range(3))
    before = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    assert flash_kernel.flash_attention.launches == before + 1
    plain = ref.flash_attention_chunked(q[:, :, None], k[:, :, None],
                                        v[:, :, None], causal)[:, :, 0]
    for want in (plain, ref.flash_attention(q, k, v, causal)):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("Sq,q_offset,Hq,Hkv,D,window", [
    (16, 0, 8, 8, 80, 0), (7, 512, 8, 8, 80, 0), (16, 1072, 4, 4, 80, 0),
    (40, 0, 8, 2, 40, 8), (16, 48, 8, 2, 64, 8), (100, 0, 4, 4, 80, 0),
    (65, 3, 4, 1, 128, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_fold_shapes(dev, Sq, q_offset, Hq, Hkv, D,
                                            window, dtype):
    """Queries at an offset into a longer key range, windows, GQA by index
    and ragged lengths against the plain version; a second call is
    bitwise equal (the chunked resume relies on it)."""
    gen = torch.Generator().manual_seed(Sq + q_offset)
    Sk = q_offset + Sq
    q = torch.randn((2, Sq, Hq, D), generator=gen).to(dtype).to(dev)
    k = torch.randn((2, Sk, Hkv, D), generator=gen).to(dtype).to(dev)
    v = torch.randn((2, Sk, Hkv, D), generator=gen).to(dtype).to(dev)
    got = flash_kernel.flash_attention(q, k, v, window=window,
                                       q_offset=q_offset)
    want = ref.flash_attention_chunked(q, k, v, True, window, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(
        q, k, v, window=window, q_offset=q_offset))


@pytest.mark.parametrize("Sq,q_offset,Hq,Hkv,window,min_ctas", [
    (16, 0, 8, 8, 0, 1 << 30), (16, 512, 8, 8, 0, 1 << 30),
    (16, 1072, 8, 8, 0, 1 << 30), (16, 1072, 8, 8, 0, 0),
    (200, 0, 4, 4, 0, 1 << 30), (64, 256, 8, 2, 8, 1 << 30),
    (7, 300, 4, 1, 100, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_forced_splits(monkeypatch, dev, Sq, q_offset,
                                              Hq, Hkv, window, min_ctas,
                                              dtype):
    """The key band split one tile per CTA (``MIN_CTAS`` 1 << 30), kept
    whole (0) or as planned (None): some splits hold no key of some rows
    (the causal prompt's last splits, a window of 8 at GQA 4:1); against
    the plain version, a repeated call bitwise, and no host
    synchronization in the call."""
    if min_ctas is not None:
        monkeypatch.setattr(flash_kernel, "MIN_CTAS", min_ctas)
    gen = torch.Generator().manual_seed(Sq * 3 + q_offset)
    Sk = q_offset + Sq
    q = torch.randn((1, Sq, Hq, 80), generator=gen).to(dtype).to(dev)
    k = torch.randn((1, Sk, Hkv, 80), generator=gen).to(dtype).to(dev)
    v = torch.randn((1, Sk, Hkv, 80), generator=gen).to(dtype).to(dev)
    kw = dict(window=window, q_offset=q_offset)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = flash_kernel.flash_attention(q, k, v, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = ref.flash_attention_chunked(q, k, v, True, window, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("bps", [1, 4, 12, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_kernel_forced_splits(monkeypatch, dev, bps,
                                                    dtype):
    """lens 0, 1, a partial block, exactly nb*bs and a lane longer than
    one split, the chain split one block per CTA, four, twelve (one split)
    and as planned; windows None, 3 and 17 with the splice off and on; a
    lens == 0 lane is exactly 0; NaN in the trash block and a repeated
    call bitwise; no host read of lens (no synchronization)."""
    gen = torch.Generator().manual_seed(bps or 0)
    B, nb, bs, Hq, Hkv, D = 5, 12, 16, 8, 2, 80
    if bps is not None:
        monkeypatch.setattr(paged_attn_kernel, "SPLIT_POSITIONS", bps * bs)
    lens = torch.tensor([0, 1, 24, nb * bs, 150], dtype=torch.int32)
    num_blocks = B * nb + 1
    perm = torch.randperm(num_blocks - 1, generator=gen) + 1
    tables = torch.zeros((B, nb), dtype=torch.int32)
    for b in range(B):
        used = -(-int(lens[b]) // bs)
        tables[b, :used] = perm[b * nb:b * nb + used].to(torch.int32)

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    q, ka, va = arr(B, Hq, D), arr(num_blocks, bs, Hkv, D), \
        arr(num_blocks, bs, Hkv, D)
    nk = (arr(B, Hkv, D), arr(B, Hkv, D))
    tables, lens = tables.to(dev), lens.to(dev)
    live = lens > 0
    for window in (None, 3, 17):
        for new_kv in (None, nk):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = paged_attn_kernel.paged_decode_attention(
                    q, ka, va, tables, lens, window=window, new_kv=new_kv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = ref.paged_decode_attention(q, ka, va, tables, lens,
                                              window, new_kv)
            torch.testing.assert_close(got[live].float(),
                                       want[live].float(), rtol=_tol(dtype),
                                       atol=_tol(dtype))
            assert bool((got[~live] == 0).all())
    base = paged_attn_kernel.paged_decode_attention(
        q, ka, va, tables, lens, new_kv=nk)
    ka[0], va[0] = float("nan"), float("nan")
    for _ in range(2):
        assert torch.equal(base, paged_attn_kernel.paged_decode_attention(
            q, ka, va, tables, lens, new_kv=nk))


def test_flash_attention_kernel_refuses_bad_inputs(dev):
    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=dev)
    with pytest.raises(ValueError):               # 40-byte rows
        flash_kernel.flash_attention(z(1, 4, 2, 20), z(1, 4, 2, 20),
                                     z(1, 4, 2, 20))
    with pytest.raises(ValueError):               # D > 128
        flash_kernel.flash_attention(z(1, 4, 2, 136), z(1, 4, 2, 136),
                                     z(1, 4, 2, 136))
    with pytest.raises(ValueError):               # Hq not a multiple
        flash_kernel.flash_attention(z(1, 4, 3, 16), z(1, 4, 2, 16),
                                     z(1, 4, 2, 16))
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(*(z(1, 4, 2, 16, dtype=torch.float16)
                                       for _ in range(3)))
    with pytest.raises(ValueError):               # not contiguous
        flash_kernel.flash_attention(z(1, 2, 4, 16).transpose(1, 2),
                                     z(1, 4, 2, 16), z(1, 4, 2, 16))


# -- the attention kernels at 16 heads of 128 (deepseek-moe-16b, MHA) ---------

MOE_H, MOE_D, MOE_L = 16, 128, 28


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_kernel_moe_heads(monkeypatch, dev, split,
                                                 dtype):
    """The flat tick's call at 8 lanes x ~1k positions: split as planned
    (512-position splits and their combine) and in one split, windows None
    and 100, with the tick's new rows spliced in, against the plain
    version."""
    if not split:
        monkeypatch.setattr(paged_attn_kernel, "SPLIT_POSITIONS", 1 << 20)
    gen = torch.Generator().manual_seed(128 + split)
    B, nb, bs = 8, 66, 16
    q, ka, va, tables, lens, k1, v1 = _paged_case(
        gen, B, nb, bs, MOE_H, MOE_H, MOE_D, dtype, dev)
    lens = torch.arange(1024, 1024 + B, dtype=torch.int32, device=dev)
    assert (paged_attn_kernel.paged_split_plan(nb, bs)[0] > 1) == split
    for window in (None, 100):
        n = paged_attn_kernel.paged_decode_attention.launches
        got = paged_attn_kernel.paged_decode_attention(
            q, ka, va, tables, lens, window=window, new_kv=(k1, v1))
        assert paged_attn_kernel.paged_decode_attention.launches == n + 1
        want = ref.paged_decode_attention(q, ka, va, tables, lens, window,
                                          (k1, v1))
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kv_rows_kernel_moe_heads_bitwise(dev, dtype):
    """The tick's write at 28 layers of 16 x 128 rows, one tensor per
    layer, bit for bit the plain version; one wrapper call."""
    gen = torch.Generator().manual_seed(28)
    nbk, bs, S = 17, 16, 8

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    ka, va = (arr(MOE_L, nbk, 1, bs, MOE_H, MOE_D) for _ in range(2))
    kr, vr = (arr(MOE_L, S, MOE_H, MOE_D) for _ in range(2))
    wbids = torch.tensor([3, 0, 7, 16, 1, 9, 0, 12], dtype=torch.int32,
                         device=dev)
    offs = torch.tensor([0, 5, 15, 5, 9, 1, 2, 14], dtype=torch.int32,
                        device=dev)
    rk, rv = ref.scatter_kv_rows(ka.clone(), va.clone(), kr, vr, wbids, offs)
    n = paged_attn_kernel.scatter_kv_rows.launches
    paged_attn_kernel.scatter_kv_rows(ka, va, list(kr), list(vr), wbids,
                                      offs)
    assert paged_attn_kernel.scatter_kv_rows.launches == n + 1
    assert torch.equal(ka[:, 1:], rk[:, 1:]) and torch.equal(va[:, 1:],
                                                             rv[:, 1:])


@pytest.mark.parametrize("Sq,q_offset", [(16, 512), (7, 1072), (1000, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_moe_heads(dev, Sq, q_offset, dtype):
    """Fold chunks (16 queries at 512, a partial chunk at 1,072) and a
    1,000-token one-shot prompt at 16 heads of 128, causal, against the
    plain version; a second call bitwise."""
    gen = torch.Generator().manual_seed(Sq + q_offset)
    Sk = q_offset + Sq
    q = torch.randn((1, Sq, MOE_H, MOE_D), generator=gen).to(dtype).to(dev)
    k = torch.randn((1, Sk, MOE_H, MOE_D), generator=gen).to(dtype).to(dev)
    v = torch.randn((1, Sk, MOE_H, MOE_D), generator=gen).to(dtype).to(dev)
    n = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, q_offset=q_offset)
    assert flash_kernel.flash_attention.launches == n + 1
    want = ref.flash_attention_chunked(q, k, v, True, 0, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(
        q, k, v, q_offset=q_offset))


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_kernels_moe_heads(monkeypatch, dev, plan, dtype):
    """Load (c)'s cascade tick at 16 heads of 128: eight lanes sharing a
    1,024-position chain, each with its own suffix of 1 to 64 positions in
    a 4-entry table, windows 0 and 100, at each forced plan: the prefix
    pass against its plain version, the suffix pass with the merge fused
    bit for bit the composition and within the tolerance of its plain
    version."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    gen = torch.Generator().manual_seed(MOE_D)
    bs, Lc, npre = 16, 8, 64

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    nblk = 1 + npre + 4 * Lc
    ka, va = arr(nblk, bs, MOE_H, MOE_D), arr(nblk, bs, MOE_H, MOE_D)
    gt = torch.arange(1, 1 + npre, **i32)[None]
    glen = torch.tensor([npre * bs], **i32)
    ll = glen + torch.tensor([[1, 7, 16, 17, 33, 48, 63, 64]], **i32)
    meta = attention.with_lane_meta(
        {"group_lanes": torch.arange(Lc, **i32)[None],
         "group_mask": torch.ones((1, Lc), dtype=torch.bool, device=dev)},
        ll[0])
    qg = arr(1, Lc, MOE_H, MOE_D)
    nk = (arr(Lc, MOE_H, MOE_D), arr(Lc, MOE_H, MOE_D))
    st = torch.arange(1 + npre, nblk, **i32).reshape(Lc, 4)
    tol = _tol(dtype)
    for window in (0, 100):
        n = paged_attn_kernel.cascade_prefix_attention.launches
        prefix = paged_attn_kernel.cascade_prefix_attention(
            qg, ka, va, gt, glen, ll, window=window)
        assert paged_attn_kernel.cascade_prefix_attention.launches == n + 1
        for g, w in zip(prefix, ref.cascade_prefix_attention(
                qg, ka, va, gt, glen, ll, window)):
            assert not torch.isnan(g).any()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        _fused_against_composition(
            prefix, meta, (qg[0], ka, va, st, ll[0]), window,
            glen.expand(Lc).contiguous(), nk, tol)


# -- the attention kernels at 25 heads over 5 KV heads of 64 (hymba-1.5b) -----

HY_HQ, HY_HKV, HY_D, HY_WIN = 25, 5, 64, 1024


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_kernel_hymba_heads(monkeypatch, dev, split,
                                                   dtype):
    """The hybrid flat tick's call at GQA 5:1: 8 lanes of 1,201 to 1,208
    positions, split as planned and in one split, with the sliding
    layers' window of 1,024 (which cuts every lane's chain, so a split
    before it is empty) and without (the global layers), the new rows
    spliced in, against the plain version."""
    if not split:
        monkeypatch.setattr(paged_attn_kernel, "SPLIT_POSITIONS", 1 << 20)
    gen = torch.Generator().manual_seed(HY_D + split)
    B, nb, bs = 8, 96, 16
    q, ka, va, tables, _, k1, v1 = _paged_case(
        gen, B, nb, bs, HY_HQ, HY_HKV, HY_D, dtype, dev)
    lens = torch.arange(1201, 1201 + B, dtype=torch.int32, device=dev)
    for window in (HY_WIN, None, lm._GLOBAL_WINDOW):
        got = paged_attn_kernel.paged_decode_attention(
            q, ka, va, tables, lens, window=window, new_kv=(k1, v1))
        want = ref.paged_decode_attention(q, ka, va, tables, lens, window,
                                          (k1, v1))
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("Sq,q_offset,window", [
    (16, 1072, HY_WIN), (16, 1072, None), (7, 1184, HY_WIN),
    (1024, 0, HY_WIN), (1024, 0, None), (2048, 0, HY_WIN)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_hymba_heads(dev, Sq, q_offset, window,
                                            dtype):
    """Fold chunks past the window (16 queries at 1,072, a partial chunk
    at 1,184), one-shot prompts of 1,024 tokens and of 2,048 (where the
    window cuts) at 25 query heads over 5 KV heads of 64, against the
    plain version; a second call bitwise."""
    gen = torch.Generator().manual_seed(Sq + q_offset)
    Sk = q_offset + Sq

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    q, k, v = arr(1, Sq, HY_HQ, HY_D), arr(1, Sk, HY_HKV, HY_D), \
        arr(1, Sk, HY_HKV, HY_D)
    n = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, window=window,
                                       q_offset=q_offset)
    assert flash_kernel.flash_attention.launches == n + 1
    want = ref.flash_attention_chunked(q, k, v, True, window, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(
        q, k, v, window=window, q_offset=q_offset))


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_kernels_hymba_heads(monkeypatch, dev, plan, dtype):
    """Load (c)'s cascade tick at GQA 5:1 (8 lanes x 5 queries per KV
    head in the prefix pass): eight lanes sharing a 1,024-position chain
    with suffixes of 1 to 64 positions, windows 1,024 (which drops the
    chain's first rows on the sliding layers) and none, at each forced
    plan, as ``test_cascade_kernels_moe_heads`` holds them."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    gen = torch.Generator().manual_seed(HY_HQ)
    bs, Lc, npre = 16, 8, 64

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    nblk = 1 + npre + 5 * Lc
    ka, va = arr(nblk, bs, HY_HKV, HY_D), arr(nblk, bs, HY_HKV, HY_D)
    gt = torch.arange(1, 1 + npre, **i32)[None]
    glen = torch.tensor([npre * bs], **i32)
    ll = glen + torch.tensor([[1, 7, 16, 17, 33, 48, 63, 64]], **i32) + 1
    meta = attention.with_lane_meta(
        {"group_lanes": torch.arange(Lc, **i32)[None],
         "group_mask": torch.ones((1, Lc), dtype=torch.bool, device=dev)},
        ll[0])
    qg = arr(1, Lc, HY_HQ, HY_D)
    nk = (arr(Lc, HY_HKV, HY_D), arr(Lc, HY_HKV, HY_D))
    st = torch.arange(1 + npre, nblk, **i32).reshape(Lc, 5)
    tol = _tol(dtype)
    for window in (HY_WIN, None):
        prefix = paged_attn_kernel.cascade_prefix_attention(
            qg, ka, va, gt, glen, ll, window=window)
        for g, w in zip(prefix, ref.cascade_prefix_attention(
                qg, ka, va, gt, glen, ll, window)):
            assert not torch.isnan(g).any()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        _fused_against_composition(
            prefix, meta, (qg[0], ka, va, st, ll[0]), window,
            glen.expand(Lc).contiguous(), nk, tol)


def _hymba_lm(dev, dtype):
    cfg = dataclasses.replace(configs.smoke_config("hymba-1.5b"),
                              param_dtype=dtype)
    return cfg, lm.init(cfg, torch.Generator(device=dev).manual_seed(0))


@pytest.mark.parametrize("backend", ["cuda", "cascade"])
def test_hymba_tick_replay_and_kernels_match_plain(dev, backend):
    """The hybrid family on the card, float32 at its smoke size, chunked
    admission of four prompts sharing 32 tokens: the captured tick (flat
    or cascade) bit for bit its eager step in logits, arena and the lanes'
    state, with the kernels launched; then ticks whose tokens equal the
    plain tick's on the same admissions, logits within 2e-4."""
    cfg, params = _hymba_lm(dev, "float32")
    rng = np.random.default_rng(23)
    shared = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)]
                              ).astype(np.int32) for n in (3, 9, 17, 30)]

    def adapter(b):
        ad = make_adapter(cfg, params, n_slots=4, max_len=96, paged=True,
                          block_size=16, backend=b)
        for s, p in enumerate(prompts):
            ad.insert(s, p, max_new=12)
        return ad
    ad, plain = adapter(backend), adapter("plain")
    active = np.ones(4, bool)
    forced = rng.integers(0, cfg.vocab, (6, 4)).astype(np.int32)
    ad.decode(forced[0], active)                     # captures the tick
    plain.decode(forced[0], active)
    step, inputs, _ = ad._tick_inputs(forced[1], active)
    state = {**ad.arena, **ad.state}
    start = {k: a.clone() for k, a in state.items()}
    out = {}
    for name, run in (("replay", lambda: step(*inputs).clone()),
                      ("eager", lambda: step.fn(*step.load(*inputs)))):
        for key, a in state.items():
            a.copy_(start[key])
        logits, counts = _counted(run)
        out[name] = (logits, {k: a.clone() for k, a in state.items()},
                     counts)
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    assert torch.equal(lr, le) and cr == ce
    for key in ar:
        assert torch.equal(ar[key], ae[key]), key
    name = "cascade_prefix_attention" if backend == "cascade" else \
        "paged_decode_attention"
    assert cr[name] == cfg.n_layers and cr["scatter_kv_rows"] == 1
    for key, a in state.items():
        a.copy_(start[key])
    for row in forced[1:]:
        np.testing.assert_array_equal(ad.decode(row, active),
                                      plain.decode(row, active))
        torch.testing.assert_close(ad.last_logits, plain.last_logits,
                                   rtol=2e-4, atol=2e-4)


def test_hymba_chunked_resume_bitwise_after_ticks(dev):
    """On the card, bf16: a prompt resumed from another slot's boundary
    state after that slot ticked on (its state written in place by six
    captured ticks) gives the cold admission's logits, blocks and state
    bit for bit."""
    cfg, params = _hymba_lm(dev, "bfloat16")
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, cfg.vocab, 48)
    pa, pb = (np.concatenate([prefix, rng.integers(0, cfg.vocab, 9)]
                             ).astype(np.int32) for _ in range(2))

    def adapter():
        return make_adapter(cfg, params, n_slots=2, max_len=96, paged=True,
                            block_size=16)
    cold = adapter()
    cold.insert(0, pb, max_new=8)
    warm = adapter()
    tok = warm.insert(0, pa, max_new=16)
    lane = np.array([True, False])
    for _ in range(6):
        tok = warm.decode(np.array([tok, 0], np.int32), lane)[0]
    warm.insert(1, pb, max_new=8)
    assert warm.slot_stats(1)["prefill_tokens_skipped"] == 48
    assert torch.equal(cold.last_prefill_logits, warm.last_prefill_logits)
    for bc, bw in zip(cold.slot_bids[0], warm.slot_bids[1]):
        for key in cold.seq_keys:
            assert torch.equal(cold.arena_block(key, bc),
                               warm.arena_block(key, bw))
    for key in cold.state:
        assert torch.equal(cold.state[key][:, 0], warm.state[key][:, 1])


# -- the encdec family at 16 heads of 64 (whisper-medium) --------------------

WH_H, WH_D, WH_ENC = 16, 64, 1500


@pytest.mark.parametrize("Sq", [WH_ENC, 1000, 16, 7])
@pytest.mark.parametrize("min_ctas", [None, 0, 1 << 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_noncausal_whisper(monkeypatch, dev, Sq,
                                                  min_ctas, dtype):
    """Non-causal prompt attention over whisper's 1,500 frames (23 whole
    64-key tiles and a partial one of 28): the encoder's 1,500 queries over
    themselves, the cross-attention of a 1,000-token prompt, of a 16-token
    fold chunk and of a partial chunk, as planned (None), unsplit (0) and
    one tile per split (1 << 30), so that the last split holds the partial
    tile; against the plain version, a repeated call bitwise, and the
    splits covering the band once."""
    if min_ctas is not None:
        monkeypatch.setattr(flash_kernel, "MIN_CTAS", min_ctas)
    splits, lo, keys = flash_kernel.flash_split_plan(
        1, Sq, WH_ENC, WH_H, 0, None, causal=False)
    assert lo == 0 and (splits - 1) * keys < WH_ENC <= splits * keys
    gen = torch.Generator().manual_seed(Sq + (min_ctas or 1))

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    q, k, v = arr(1, Sq, WH_H, WH_D), arr(1, WH_ENC, WH_H, WH_D), \
        arr(1, WH_ENC, WH_H, WH_D)
    n = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, causal=False)
    assert flash_kernel.flash_attention.launches == n + 1
    want = ref.flash_attention_chunked(q, k, v, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(q, k, v,
                                                         causal=False))


def _whisper_lm(dev, dtype):
    cfg = dataclasses.replace(configs.smoke_config("whisper-medium"),
                              param_dtype=dtype)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    # random biases, so that a misplaced one shows
    gen = torch.Generator(device=dev).manual_seed(1)
    for blocks in (params["enc_blocks"], params["dec_blocks"]):
        for part in ("attn", "mlp"):
            for name, b in blocks[part].items():
                if name.startswith("b"):
                    b.copy_(0.1 * torch.randn(b.shape, generator=gen,
                                              device=dev))
    return cfg, params


def _frames(cfg, dev, seed=99):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, (1, cfg.enc_len, cfg.d_model))
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("backend", ["cuda", "cascade"])
def test_encdec_tick_replay_and_kernels_match_plain(dev, backend):
    """The encdec family on the card, float32 at its smoke size, one-shot
    admission of four prompts sharing 32 tokens: the captured tick (flat
    or cascade) bit for bit its eager step in logits, arena and the lanes'
    cross K/V, with the kernels launched; the admissions' prompt and
    cross-attention through ``flash_attention`` (non-causal for the
    encoder and the cross-attention); then ticks whose tokens equal the
    plain tick's on the same admissions, logits within 2e-4."""
    cfg, params = _whisper_lm(dev, "float32")
    enc = _frames(cfg, dev)
    rng = np.random.default_rng(23)
    shared = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)]
                              ).astype(np.int32) for n in (3, 9, 17, 30)]

    def adapter(b):
        ad = make_adapter(cfg, params, n_slots=4, max_len=96,
                          extras=lambda: {"enc_embed": enc}, paged=True,
                          block_size=16, chunked=False, backend=b)
        for s, p in enumerate(prompts):
            ad.insert(s, p, max_new=12)
        return ad
    (ad, plain), admit = _counted(lambda: (adapter(backend),
                                           adapter("plain")))
    # per admission: the encoder's layers, and each decoder layer's self-
    # and cross-attention
    assert admit["flash_attention"] == 2 * 4 * (cfg.enc_layers
                                                + 2 * cfg.n_layers)
    active = np.ones(4, bool)
    forced = rng.integers(0, cfg.vocab, (6, 4)).astype(np.int32)
    ad.decode(forced[0], active)                     # captures the tick
    plain.decode(forced[0], active)
    step, inputs, _ = ad._tick_inputs(forced[1], active)
    state = {**ad.arena, **ad.state}
    start = {k: a.clone() for k, a in state.items()}
    out = {}
    for name, run in (("replay", lambda: step(*inputs).clone()),
                      ("eager", lambda: step.fn(*step.load(*inputs)))):
        for key, a in state.items():
            a.copy_(start[key])
        logits, counts = _counted(run)
        out[name] = (logits, {k: a.clone() for k, a in state.items()},
                     counts)
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    assert torch.equal(lr, le) and cr == ce
    for key in ar:
        assert torch.equal(ar[key], ae[key]), key
    for key in ("xk", "xv"):
        assert torch.equal(ar[key], start[key])
    name = "cascade_prefix_attention" if backend == "cascade" else \
        "paged_decode_attention"
    assert cr[name] == cfg.n_layers and cr["scatter_kv_rows"] == 1
    assert cr["flash_attention"] == 0
    for key, a in state.items():
        a.copy_(start[key])
    for row in forced[1:]:
        np.testing.assert_array_equal(ad.decode(row, active),
                                      plain.decode(row, active))
        torch.testing.assert_close(ad.last_logits, plain.last_logits,
                                   rtol=2e-4, atol=2e-4)


def test_encdec_chunked_resume_bitwise(dev):
    """On the card, bf16: a prompt resumed from another slot's prefix (the
    encoder run again for it) gives the cold admission's logits, blocks
    and cross K/V bit for bit, also after the first slot ticked on."""
    cfg, params = _whisper_lm(dev, "bfloat16")
    enc = _frames(cfg, dev)
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, cfg.vocab, 48)
    pa, pb = (np.concatenate([prefix, rng.integers(0, cfg.vocab, 9)]
                             ).astype(np.int32) for _ in range(2))

    def adapter():
        return make_adapter(cfg, params, n_slots=2, max_len=96,
                            extras=lambda: {"enc_embed": enc}, paged=True,
                            block_size=16)
    cold = adapter()
    cold.insert(0, pb, max_new=8)
    warm = adapter()
    tok = warm.insert(0, pa, max_new=16)
    lane = np.array([True, False])
    for _ in range(6):
        tok = warm.decode(np.array([tok, 0], np.int32), lane)[0]
    warm.insert(1, pb, max_new=8)
    assert warm.slot_stats(1)["prefill_tokens_skipped"] == 48
    assert torch.equal(cold.last_prefill_logits, warm.last_prefill_logits)
    for bc, bw in zip(cold.slot_bids[0], warm.slot_bids[1]):
        for key in cold.seq_keys:
            assert torch.equal(cold.arena_block(key, bc),
                               warm.arena_block(key, bw))
    for key in cold.state:
        assert torch.equal(cold.state[key][:, 0], warm.state[key][:, 1])


@pytest.mark.parametrize("paged", [True, False])
def test_encdec_replay_after_readmission_reads_new_cross_kv(dev, paged):
    """A captured tick (dense or paged flat) replayed after its slot was
    cleared and admitted again with other frames: the graph reads the new
    cross K/V (copied into the lane's tensors in place), so the tick
    equals that of an adapter that admitted those frames first, bit for
    bit."""
    cfg, params = _whisper_lm(dev, "float32")
    frames = {"enc": _frames(cfg, dev)}
    other = _frames(cfg, dev, seed=7)
    rng = np.random.default_rng(31)
    p0, p1, p2 = (rng.integers(0, cfg.vocab, n).astype(np.int32)
                  for n in (6, 19, 13))

    def adapter():
        return make_adapter(cfg, params, n_slots=2, max_len=48,
                            extras=lambda: {"enc_embed": frames["enc"]},
                            paged=paged, block_size=16)
    ad = adapter()
    ad.insert(0, p0, max_new=8)
    ad.insert(1, p1, max_new=8)
    both = np.ones(2, bool)
    ad.decode(np.array([3, 4], np.int32), both)      # captures the tick
    ad.decode(np.array([5, 6], np.int32), both)      # a replay
    assert ad._decode._cache_size() == 1
    ad.clear(0)
    frames["enc"] = other
    tok = ad.insert(0, p2, max_new=8)
    got = ad.decode(np.array([tok, 7], np.int32), both)
    assert ad._decode._cache_size() == 1
    fresh = adapter()
    assert fresh.insert(0, p2, max_new=8) == tok
    lane = ad.state if paged else ad.cache
    fresh_lane = fresh.state if paged else fresh.cache
    for key in ("xk", "xv"):
        assert torch.equal(lane[key][:, 0], fresh_lane[key][:, 0])
    fresh.decode(np.array([tok, 7], np.int32), np.array([True, False]))
    assert got[0] == int(fresh.last_logits[0].argmax())
    assert torch.equal(ad.last_logits[0], fresh.last_logits[0])


# -- the vlm family at 64 heads of 128 over 8 KV heads (llama-3.2-vision) ----

VLM_H, VLM_HKV, VLM_D, VLM_VIS = 64, 8, 128, 1024


@pytest.mark.parametrize("Sq,q_offset", [(1000, 0), (16, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vlm_heads_causal(dev, Sq, q_offset, dtype):
    """Causal prompt attention at GQA 8:1 over heads of 128: a
    1,000-token one-shot prompt and a 16-query chunk at offset 512,
    against the plain version, a repeated call bitwise."""
    gen = torch.Generator().manual_seed(Sq + q_offset)
    Sk = q_offset + Sq

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    q, k, v = arr(1, Sq, VLM_H, VLM_D), arr(1, Sk, VLM_HKV, VLM_D), \
        arr(1, Sk, VLM_HKV, VLM_D)
    got = flash_kernel.flash_attention(q, k, v, q_offset=q_offset)
    want = ref.flash_attention_chunked(q, k, v, True, None, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(
        q, k, v, q_offset=q_offset))


@pytest.mark.parametrize("Sq", [1000, 16])
@pytest.mark.parametrize("min_ctas", [None, 0, 1 << 30])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vlm_vision_keys(monkeypatch, dev, Sq,
                                                min_ctas, dtype):
    """The vlm cross-attention: 1,000 and 16 queries over 1,024 vision
    keys (16 whole 64-key tiles), not causal, at GQA 8:1 over heads of
    128, as planned (None), unsplit (0) and one tile per split (1 << 30);
    against the plain version, a repeated call bitwise, the splits
    covering the keys once."""
    if min_ctas is not None:
        monkeypatch.setattr(flash_kernel, "MIN_CTAS", min_ctas)
    splits, lo, keys = flash_kernel.flash_split_plan(
        1, Sq, VLM_VIS, VLM_H, 0, None, causal=False)
    assert lo == 0 and (splits - 1) * keys < VLM_VIS <= splits * keys
    gen = torch.Generator().manual_seed(Sq + (min_ctas or 1))

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    q, k, v = arr(1, Sq, VLM_H, VLM_D), arr(1, VLM_VIS, VLM_HKV, VLM_D), \
        arr(1, VLM_VIS, VLM_HKV, VLM_D)
    got = flash_kernel.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_chunked(q, k, v, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(q, k, v,
                                                         causal=False))


@pytest.mark.parametrize("paged", [True, False])
def test_vlm_serving_on_card(dev, paged):
    """The vlm family on the card, float32 at its smoke size with every
    gate at 0.5: one-shot admissions launch ``flash_attention`` once per
    layer and once per cross layer (L + G a prompt) and the ticks none;
    the captured tick (dense, or the paged ``"plain"`` tick) is bit for
    bit its eager step in logits, cache or arena, and leaves the lanes'
    vision K/V as they were; the ticks' tokens equal those of the same
    load with the prefill's attention through the plain version, logits
    within 2e-4."""
    from types import SimpleNamespace
    from unittest import mock
    cfg = dataclasses.replace(configs.smoke_config("llama-3.2-vision-90b"),
                              param_dtype="float32")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    params["cross_blocks"]["gate_attn"].fill_(0.5)
    rng = np.random.default_rng(37)
    vis = torch.from_numpy(rng.normal(0, 1, (1, cfg.n_vision_tokens,
                                             cfg.d_model)).astype(
        np.float32)).to(dev)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 17, 30)]
    forced = rng.integers(0, cfg.vocab, (6, 3)).astype(np.int32)

    def adapter():
        ad = make_adapter(cfg, params, n_slots=3, max_len=64,
                          extras=lambda: {"vision_embed": vis}, paged=paged,
                          block_size=16)
        first = [ad.insert(s, p, max_new=8) for s, p in enumerate(prompts)]
        return ad, first
    (ad, first), admit = _counted(adapter)
    assert admit["flash_attention"] == 3 * (cfg.n_layers + cfg.n_cross)
    assert getattr(ad, "backend", "plain") == "plain"
    active = np.ones(3, bool)
    ad.decode(forced[0], active)                     # captures the tick
    step, inputs, _ = ad._tick_inputs(forced[1], active)
    state = {**ad.arena, **ad.state} if paged else ad.cache
    start = {k: a.clone() for k, a in state.items()}
    out = {}
    for name, run in (("replay", lambda: step(*inputs).clone()),
                      ("eager", lambda: step.fn(*step.load(*inputs)))):
        for key, a in state.items():
            a.copy_(start[key])
        logits, counts = _counted(run)
        out[name] = (logits, {k: a.clone() for k, a in state.items()},
                     counts)
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    assert torch.equal(lr, le) and cr == ce
    assert not any(cr.values())
    for key in ar:
        assert torch.equal(ar[key], ae[key]), key
    for key in ("xk", "xv"):
        assert torch.equal(ar[key], start[key])
    for key, a in state.items():
        a.copy_(start[key])

    def plain(q, k, v, **kw):
        return ref.flash_attention_chunked(
            q, k, v, kw["causal"], kw["window"], kw["q_offset"],
            kw["q_chunk"], kw["kv_chunk"])
    with mock.patch.object(attention, "flash_kernels",
                           SimpleNamespace(flash_attention=plain)):
        (base, base_first), admit = _counted(adapter)
    assert admit["flash_attention"] == 0 and base_first == first
    base.decode(forced[0], active)
    for row in forced[1:]:
        np.testing.assert_array_equal(ad.decode(row, active),
                                      base.decode(row, active))
        torch.testing.assert_close(ad.last_logits, base.last_logits,
                                   rtol=2e-4, atol=2e-4)


# -- the prompt path on the card ------------------------------------------------

def _smoke_lm(dev, dtype):
    cfg = dataclasses.replace(configs.smoke_config("stablelm-3b"),
                              param_dtype=dtype)
    return cfg, lm.init(cfg, torch.Generator(device=dev).manual_seed(0))


def test_make_gateway_on_card_launches_the_paged_kernels(dev):
    cfg, params = _smoke_lm(dev, "bfloat16")
    gw = make_gateway(cfg, params, ServeSpec(n_slots=2, max_len=64,
                                             paged=True, chunked=False))
    assert gw.batcher.adapter.backend == "cuda"
    counts = (paged_attn_kernel.paged_decode_attention.launches,
              paged_attn_kernel.scatter_kv_rows.launches)
    rng = np.random.default_rng(0)
    for uid in range(3):
        gw.batcher.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, 20 + uid).astype(np.int32), max_new_tokens=5))
    done = gw.batcher.run()
    assert sorted(len(r.generated) for r in done) == [5, 5, 5]
    assert paged_attn_kernel.paged_decode_attention.launches > counts[0]
    assert paged_attn_kernel.scatter_kv_rows.launches > counts[1]


def test_kernel_tick_matches_plain_tick_float32(dev):
    """The reference's contract for the in-place kernel tick: greedy tokens
    equal and logits within 2e-4 of the plain tick over forced tokens."""
    cfg, params = _smoke_lm(dev, "float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (1, 15, 16, 40)]
    forced = rng.integers(0, cfg.vocab, (6, len(prompts))).astype(np.int32)
    out = {}
    for backend in ("cuda", "plain"):
        ad = make_adapter(cfg, params, n_slots=len(prompts), max_len=48,
                          paged=True, block_size=16, chunked=False,
                          backend=backend)
        first = [ad.insert(s, p, max_new=7) for s, p in enumerate(prompts)]
        active = np.ones(len(prompts), bool)
        toks, logits = [], []
        for row in forced:
            toks.append(ad.decode(row, active))
            logits.append(ad.last_logits.clone())
        out[backend] = (first, np.stack(toks), torch.stack(logits))
    assert out["cuda"][0] == out["plain"][0]
    np.testing.assert_array_equal(out["cuda"][1], out["plain"][1])
    torch.testing.assert_close(out["cuda"][2], out["plain"][2], rtol=2e-4,
                               atol=2e-4)


def test_cascade_tick_matches_plain_tick_float32(dev):
    """The cascade tick on the card against the plain flat tick: four lanes
    share a 2-block prefix; greedy tokens equal and logits within 2e-4 on
    every forced tick, each of which forms the group."""
    cfg, params = _smoke_lm(dev, "float32")
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)]
                              ).astype(np.int32) for n in (0, 5, 16, 30)]
    forced = rng.integers(0, cfg.vocab, (6, len(prompts))).astype(np.int32)
    out = {}
    for backend in ("cascade", "plain"):
        ad = make_adapter(cfg, params, n_slots=len(prompts), max_len=80,
                          paged=True, block_size=16, chunked=False,
                          backend=backend)
        first = [ad.insert(s, p, max_new=7) for s, p in enumerate(prompts)]
        active = np.ones(len(prompts), bool)
        toks, logits = [], []
        wrap = paged_attn_kernel.paged_decode_attention_with_state
        counts = (paged_attn_kernel.cascade_prefix_attention.launches,
                  wrap.launches, wrap.fused_merges,
                  paged_attn_kernel.merge_attn_states.launches)
        for row in forced:
            toks.append(ad.decode(row, active))
            logits.append(ad.last_logits.clone())
            assert backend == "plain" or ad.last_groups == 1
        if backend == "cascade":
            # per tick and layer: the prefix pass and the suffix pass with
            # the merge fused in; the standalone merge never
            n = len(forced) * cfg.n_layers
            assert (paged_attn_kernel.cascade_prefix_attention.launches,
                    wrap.launches, wrap.fused_merges,
                    paged_attn_kernel.merge_attn_states.launches) == \
                (counts[0] + n, counts[1] + n, counts[2] + n, counts[3])
        out[backend] = (first, np.stack(toks), torch.stack(logits))
    assert out["cascade"][0] == out["plain"][0]
    np.testing.assert_array_equal(out["cascade"][1], out["plain"][1])
    torch.testing.assert_close(out["cascade"][2], out["plain"][2], rtol=2e-4,
                               atol=2e-4)


def test_chunked_gateway_on_card_launches_flash_per_chunk(dev):
    """``ServeSpec(paged=True)`` (chunked by default) on the card: the
    flash kernel launches once per layer per fold chunk, and the paged
    kernels on the ticks."""
    cfg, params = _smoke_lm(dev, "bfloat16")
    gw = make_gateway(cfg, params, ServeSpec(n_slots=2, max_len=96,
                                             paged=True, block_size=16))
    ad = gw.batcher.adapter
    assert ad.chunked and ad.backend == "cuda"
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 32)
    before = (flash_kernel.flash_attention.launches,
              paged_attn_kernel.paged_decode_attention.launches)
    for uid in range(3):
        gw.batcher.submit(Request(uid=uid, prompt=np.concatenate(
            [shared, rng.integers(0, cfg.vocab, 5 + uid)]).astype(np.int32),
            max_new_tokens=4))
    done = gw.batcher.run()
    assert sorted(len(r.generated) for r in done) == [4, 4, 4]
    assert sorted(r.prefill_tokens_skipped for r in done) == [0, 32, 32]
    assert ad.prefill_chunks_total == 3 + 1 + 1
    assert flash_kernel.flash_attention.launches == \
        before[0] + cfg.n_layers * ad.prefill_chunks_total
    assert paged_attn_kernel.paged_decode_attention.launches > before[1]


def test_chunked_resume_bitwise_and_matches_oneshot_float32(dev):
    """On the card, float32: a prompt admitted after a radix hit gives the
    same first-token logits and blocks as the same prompt admitted cold,
    bit for bit; and the chunked adapter's tokens equal the one-shot
    adapter's over forced ticks, logits within 2e-4."""
    cfg, params = _smoke_lm(dev, "float32")
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab, 48)
    pa, pb = (np.concatenate([prefix, rng.integers(0, cfg.vocab, 9)]
                             ).astype(np.int32) for _ in range(2))

    def adapter(chunked):
        return make_adapter(cfg, params, n_slots=2, max_len=96, paged=True,
                            block_size=16, chunked=chunked)
    cold = adapter(True)
    cold.insert(0, pb, max_new=8)
    warm = adapter(True)
    first = [warm.insert(0, pa, max_new=8), warm.insert(1, pb, max_new=8)]
    assert warm.slot_stats(1)["prefill_tokens_skipped"] == 48
    assert torch.equal(cold.last_prefill_logits, warm.last_prefill_logits)
    for bc, bw in zip(cold.slot_bids[0], warm.slot_bids[1]):
        for key in cold.seq_keys:
            assert torch.equal(cold.arena_block(key, bc),
                               warm.arena_block(key, bw))
    one = adapter(False)
    assert [one.insert(0, pa, max_new=8),
            one.insert(1, pb, max_new=8)] == first
    active = np.ones(2, bool)
    for row in rng.integers(0, cfg.vocab, (5, 2)).astype(np.int32):
        np.testing.assert_array_equal(warm.decode(row, active),
                                      one.decode(row, active))
        torch.testing.assert_close(warm.last_logits, one.last_logits,
                                   rtol=2e-4, atol=2e-4)


# -- captured steps (serve/capture.py) on the card ------------------------------

def _counted(run):
    """(run's result, the launch counters' change over it)."""
    before = kernels.read_counts()
    out = run()
    torch.cuda.synchronize()
    after = kernels.read_counts()
    return out, {name: after[name] - before[name] for name in after}


@pytest.mark.parametrize("bits", [4, 8])
def test_frame_stages_replay_bitwise_to_eager(dev, bits):
    """A captured frame bucket: the payload byte for byte and the logits
    bit for bit the stages' eager call on the same frames, with the same
    launch counts; two captured steps per bucket."""
    spec = fe.FrontendSpec(mode="sc", bits=bits, lenet=lenet.LeNetConfig())
    g = MicroBatchGateway(GatewayConfig(bucket_sizes=(8,)), spec)
    g.warmup()
    assert g.compile_counts() == {8: 2}
    frames = np.random.default_rng(bits).integers(0, 256, (8, 28, 28, 1),
                                                  dtype=np.uint8)
    sensor, gate = g._sensor_fns[8], g._gateway_fns[8]
    def replay():
        payload = sensor(frames).clone()
        return payload, gate(payload).clone()

    def eager():
        payload = sensor.fn(*sensor.load(frames))
        return payload, gate.fn(*gate.load(payload))
    (payload, logits), replayed = _counted(replay)
    (payload_e, logits_e), eagerly = _counted(eager)
    assert torch.equal(payload, payload_e) and torch.equal(logits, logits_e)
    assert replayed == eagerly and replayed["sc_dot"] == 1 and \
        replayed["sng_pack"] == 2
    assert g.compile_counts() == {8: 2}


def _tick_replay_and_eager(ad, forced, active):
    """One tick's (logits, arena) through the adapter's captured step and
    through its ``fn`` called eagerly on the same static inputs, from the
    same arena, each with its launch counts."""
    step, inputs, _ = ad._tick_inputs(forced, active)
    start = {k: a.clone() for k, a in ad.arena.items()}
    out = {}
    for name, run in (("replay", lambda: step(*inputs).clone()),
                      ("eager", lambda: step.fn(*step.load(*inputs)))):
        for key, a in ad.arena.items():
            a.copy_(start[key])
        logits, counts = _counted(run)
        out[name] = (logits, {k: a.clone() for k, a in ad.arena.items()},
                     counts)
    return step, out


@pytest.mark.parametrize("backend", ["cuda", "cascade"])
def test_tick_replay_bitwise_to_eager(dev, backend):
    """The flat tick and a cascade bucket at small depth: logits and the
    arena rows the tick wrote bit for bit the eager step's, launch counts
    equal under replay."""
    cfg, params = _smoke_lm(dev, "bfloat16")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)]
                              ).astype(np.int32) for n in (3, 9, 17, 30)]
    ad = make_adapter(cfg, params, n_slots=4, max_len=96, paged=True,
                      block_size=16, chunked=False, backend=backend)
    for s, p in enumerate(prompts):
        ad.insert(s, p, max_new=8)
    active = np.ones(4, bool)
    forced = rng.integers(0, cfg.vocab, (3, 4)).astype(np.int32)
    ad.decode(forced[0], active)                     # captures the tick
    step, out = _tick_replay_and_eager(ad, forced[1], active)
    assert step._cache_size() == 1
    assert step is (ad._decode_cascade if backend == "cascade"
                    else ad._decode)
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    assert torch.equal(lr, le) and bool(torch.isfinite(lr).all())
    for key in ar:
        assert torch.equal(ar[key], ae[key])
    assert cr == ce
    layers = cfg.n_layers
    if backend == "cascade":
        assert cr["cascade_prefix_attention"] == \
            cr["merge_attn_states (fused)"] == layers
    else:
        assert cr["paged_decode_attention"] == layers
    assert cr["scatter_kv_rows"] == 1


def test_capture_raises_on_a_host_sync(dev):
    """A step that reads a value back on the host inside ``fn`` runs its
    eager first call, then fails its capture: the call raises (nothing
    falls back to running eagerly), no key is counted, the caller's stream
    is current again and the owner's pool is renewed, on which a
    well-formed step then captures and replays."""
    pool = capture.GraphPool(dev)
    failed = pool.handle
    stream = torch.cuda.current_stream()
    syncing = capture.CapturedStep(lambda x: x * float(x.sum().item()), dev,
                                   pool)
    with pytest.raises(RuntimeError):
        syncing(np.ones(4, np.float32))
    assert syncing._cache_size() == 0
    assert torch.cuda.current_stream() == stream
    assert pool.handle != failed
    step = capture.CapturedStep(lambda x: x * 2, dev, pool)
    for i in range(3):
        got = step(np.full(4, i, np.float32))
        assert torch.equal(got.cpu(), torch.full((4,), 2.0 * i))
    assert step._cache_size() == 1


def test_capture_survives_garbage_collection(dev):
    """Dropped owners whose captured steps sit in reference cycles, and a
    collector that would run at every allocation: a new step still
    captures (the collector stays off while it does) and replays as its
    eager call."""
    import gc

    class Owner:
        def __init__(self):
            self.me = self
            self.step = capture.CapturedStep(lambda x: x + 1, dev)
            self.step(np.zeros(4, np.float32))

    def garbage_making(x):
        [[object()] for _ in range(64)]
        return x * 3
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for _ in range(4):
            Owner()
        step = capture.CapturedStep(garbage_making, dev)
        for i in range(3):
            got = step(np.full(4, i, np.float32))
            assert torch.equal(got.cpu(), torch.full((4,), 3.0 * i))
    finally:
        gc.set_threshold(*threshold)
    assert step._cache_size() == 1


# -- the retraining pipeline (core/hybrid.py) --------------------------------

HYBRID_DESIGNS = {
    "sc2": dict(mode="sc", sc=dict(bits=2)),
    "sc4": dict(mode="sc", sc=dict(bits=4)),
    "sc8": dict(mode="sc", sc=dict(bits=8)),
    "binary4": dict(mode="binary", bits=4),
    "old_sc2": dict(mode="sc", sc=dict(bits=2, scheme="lfsr_pair",
                                       adder="mux"), sc_impl="streams"),
    "old_sc4": dict(mode="sc", sc=dict(bits=4, scheme="lfsr_pair",
                                       adder="mux"), sc_impl="streams"),
}


def _hybrid_config(mode, sc=None, **kw):
    from repro_torch.core import hybrid
    from repro_torch.core.sc_layer import SCConfig
    return hybrid.HybridConfig(mode=mode, sc=SCConfig(**(sc or {})), **kw)


@pytest.mark.parametrize("design", HYBRID_DESIGNS)
def test_cache_first_layer_on_card_matches_cpu(dev, design):
    """Full-width conv1, 136 images (two whole batches and a partial one):
    the card's features (the kernels; the MUX tree in plain PyTorch) bit for
    bit the CPU's plain path, with 2 ``sng_pack`` and, for the TFF designs,
    1 ``sc_dot`` launch per batch."""
    from repro_torch.core import hybrid
    from repro_torch.data import mnist_synth
    cfg = lenet.LeNetConfig()
    images = mnist_synth.dataset(136, 0, seed=11)[0]
    params = lenet.init(0, cfg, device="cpu")
    h = _hybrid_config(**HYBRID_DESIGNS[design])
    kernels.reset_counts()
    got = hybrid.cache_first_layer(
        {l: {k: t.to(dev) for k, t in d.items()} for l, d in params.items()},
        images, h)
    torch.cuda.synchronize()
    counts = kernels.read_counts()
    assert got.is_cuda and got.dtype == torch.int8
    assert torch.equal(got.cpu(), hybrid.cache_first_layer(params, images, h))
    sc = h.mode == "sc"
    assert counts["sng_pack"] == (6 if sc else 0)
    assert counts["sc_dot"] == (3 if sc and h.sc.adder != "mux" else 0)


def test_tail_train_step_on_card_matches_cpu(dev):
    """One step at dropout 0 from the same weights and features: the loss
    within 1e-5 and the gradients within 1e-5 x max|g| of the CPU's, and
    the step's parameters within 1e-6 of AdamW on the CPU given the card's
    gradients."""
    from repro_torch.core import hybrid
    from repro_torch.train import optim
    cfg = lenet.LeNetConfig(dropout=0.0)
    params = lenet.init(1, cfg, device="cpu")
    rng = np.random.default_rng(0)
    h1 = torch.from_numpy(rng.integers(-1, 2, (128, 28, 28, 32))
                          .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 128))
    on = {l: {k: t.to(dev) for k, t in d.items()} for l, d in params.items()}

    def grads(ps, h, labels):
        sub = {l: {k: t.detach().requires_grad_() for k, t in ps[l].items()}
               for l in hybrid.TRAINABLE}
        # float32 forward and backward, as tail_train_step computes them
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            loss = hybrid.loss_fn(lenet.tail({**ps, **sub}, h, cfg,
                                             train=True), labels)
            g = torch.autograd.grad(loss, optim.leaves(sub))
        return loss, optim.unflatten(sub, list(g))
    loss_cpu, g_cpu = grads(params, h1, y)
    loss_card, g_card = grads(on, h1.to(dev), y.to(dev))
    assert abs(loss_card.item() - loss_cpu.item()) <= 1e-5
    for l in hybrid.TRAINABLE:
        for k in ("w", "b"):
            assert torch.allclose(g_card[l][k].cpu(), g_cpu[l][k], rtol=0,
                                  atol=1e-5 * float(g_cpu[l][k].abs().max()))
    opt_cfg = optim.AdamWConfig()
    sub = {l: params[l] for l in hybrid.TRAINABLE}
    card, state, loss = hybrid.tail_train_step(
        on, optim.init({l: on[l] for l in hybrid.TRAINABLE}, opt_cfg),
        h1.to(dev), y.to(dev), None, cfg, opt_cfg)
    assert abs(loss.item() - loss_cpu.item()) <= 1e-5
    want, _ = optim.apply(sub, {l: {k: t.cpu() for k, t in d.items()}
                                for l, d in g_card.items()},
                          optim.init(sub, opt_cfg), opt_cfg)
    for l in hybrid.TRAINABLE:
        for k in ("w", "b"):
            assert torch.allclose(card[l][k].cpu(), want[l][k], rtol=0,
                                  atol=1e-6)
    assert torch.equal(card["conv1"]["w"].cpu(), params["conv1"]["w"])


# -- the attention kernels at GQA 12:1 and 16:1 (starcoder2, llama3-405b) ---

# (query heads, KV heads, head width, layers) of starcoder2-15b (12:1) and
# llama3-405b (16:1)
GQA_HEADS = {"12:1": (48, 4, 128, 40), "16:1": (128, 8, 128, 126)}


@pytest.mark.parametrize("ratio", list(GQA_HEADS))
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_kernel_gqa_heads(monkeypatch, dev, ratio,
                                                 split, dtype):
    """The flat tick's call at 8 lanes x ~1k positions with 12 and 16
    query heads per KV head: split as planned and in one split, windows
    None and 100, the tick's new rows spliced in, against the plain
    version."""
    hq, hkv, d, _ = GQA_HEADS[ratio]
    if not split:
        monkeypatch.setattr(paged_attn_kernel, "SPLIT_POSITIONS", 1 << 20)
    gen = torch.Generator().manual_seed(hq + split)
    B, nb, bs = 8, 66, 16
    q, ka, va, tables, lens, k1, v1 = _paged_case(gen, B, nb, bs, hq, hkv,
                                                  d, dtype, dev)
    lens = torch.arange(1024, 1024 + B, dtype=torch.int32, device=dev)
    for window in (None, 100):
        n = paged_attn_kernel.paged_decode_attention.launches
        got = paged_attn_kernel.paged_decode_attention(
            q, ka, va, tables, lens, window=window, new_kv=(k1, v1))
        assert paged_attn_kernel.paged_decode_attention.launches == n + 1
        want = ref.paged_decode_attention(q, ka, va, tables, lens, window,
                                          (k1, v1))
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("ratio", list(GQA_HEADS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kv_rows_kernel_gqa_heads_bitwise(dev, ratio, dtype):
    """The tick's write at the config's layer count (40; 126, two launches'
    worth of pointers) of its KV heads, one tensor per layer, bit for bit
    the plain version; one wrapper call."""
    _, hkv, d, L = GQA_HEADS[ratio]
    gen = torch.Generator().manual_seed(L)
    nbk, bs, S = 9, 16, 8

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    ka, va = (arr(L, nbk, 1, bs, hkv, d) for _ in range(2))
    kr, vr = (arr(L, S, hkv, d) for _ in range(2))
    wbids = torch.tensor([3, 0, 7, 8, 1, 5, 0, 2], dtype=torch.int32,
                         device=dev)
    offs = torch.tensor([0, 5, 15, 5, 9, 1, 2, 14], dtype=torch.int32,
                        device=dev)
    rk, rv = ref.scatter_kv_rows(ka.clone(), va.clone(), kr, vr, wbids, offs)
    n = paged_attn_kernel.scatter_kv_rows.launches
    paged_attn_kernel.scatter_kv_rows(ka, va, list(kr), list(vr), wbids,
                                      offs)
    assert paged_attn_kernel.scatter_kv_rows.launches == n + 1
    assert torch.equal(ka[:, 1:], rk[:, 1:]) and torch.equal(va[:, 1:],
                                                             rv[:, 1:])


@pytest.mark.parametrize("ratio", list(GQA_HEADS))
@pytest.mark.parametrize("Sq,q_offset", [(16, 512), (7, 1072), (1000, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_gqa_heads(dev, ratio, Sq, q_offset, dtype):
    """Fold chunks and a 1,000-token one-shot prompt at 12 and 16 query
    heads per KV head, causal, against the plain version; a second call
    bitwise."""
    hq, hkv, d, _ = GQA_HEADS[ratio]
    gen = torch.Generator().manual_seed(Sq + q_offset + hq)
    Sk = q_offset + Sq
    q = torch.randn((1, Sq, hq, d), generator=gen).to(dtype).to(dev)
    k = torch.randn((1, Sk, hkv, d), generator=gen).to(dtype).to(dev)
    v = torch.randn((1, Sk, hkv, d), generator=gen).to(dtype).to(dev)
    n = flash_kernel.flash_attention.launches
    got = flash_kernel.flash_attention(q, k, v, q_offset=q_offset)
    assert flash_kernel.flash_attention.launches == n + 1
    want = ref.flash_attention_chunked(q, k, v, True, 0, q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    assert torch.equal(got, flash_kernel.flash_attention(
        q, k, v, q_offset=q_offset))


@pytest.mark.parametrize("plan",
                         list(paged_attn_kernel.CASCADE_FORCED_PLANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_kernels_gqa_12_heads(monkeypatch, dev, plan, dtype):
    """Load (c)'s cascade tick at 48 heads over 4 KV heads of 128: eight
    lanes sharing a 1,024-position chain (96 query rows per KV head in the
    prefix pass), suffixes of 1 to 64 positions, windows 0 and 100, at
    each forced plan: the prefix pass against its plain version, the
    suffix pass with the merge fused bit for bit the composition and
    within the tolerance of its plain version."""
    for const, value in paged_attn_kernel.CASCADE_FORCED_PLANS[plan].items():
        monkeypatch.setattr(paged_attn_kernel, const, value)
    hq, hkv, d, _ = GQA_HEADS["12:1"]
    gen = torch.Generator().manual_seed(hq)
    bs, Lc, npre = 16, 8, 64

    def arr(*shape):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    nblk = 1 + npre + 4 * Lc
    ka, va = arr(nblk, bs, hkv, d), arr(nblk, bs, hkv, d)
    gt = torch.arange(1, 1 + npre, **i32)[None]
    glen = torch.tensor([npre * bs], **i32)
    ll = glen + torch.tensor([[1, 7, 16, 17, 33, 48, 63, 64]], **i32)
    meta = attention.with_lane_meta(
        {"group_lanes": torch.arange(Lc, **i32)[None],
         "group_mask": torch.ones((1, Lc), dtype=torch.bool, device=dev)},
        ll[0])
    qg = arr(1, Lc, hq, d)
    nk = (arr(Lc, hkv, d), arr(Lc, hkv, d))
    st = torch.arange(1 + npre, nblk, **i32).reshape(Lc, 4)
    tol = _tol(dtype)
    for window in (0, 100):
        n = paged_attn_kernel.cascade_prefix_attention.launches
        prefix = paged_attn_kernel.cascade_prefix_attention(
            qg, ka, va, gt, glen, ll, window=window)
        assert paged_attn_kernel.cascade_prefix_attention.launches == n + 1
        for g, w in zip(prefix, ref.cascade_prefix_attention(
                qg, ka, va, gt, glen, ll, window)):
            assert not torch.isnan(g).any()
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        _fused_against_composition(
            prefix, meta, (qg[0], ka, va, st, ll[0]), window,
            glen.expand(Lc).contiguous(), nk, tol)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "llama3-405b"])
def test_decoder_kernel_tick_matches_plain_tick_float32(dev, arch):
    """The smoke configs of the last decoders (starcoder2's GELU, biases
    and LayerNorm) on the card in float32: the kernel tick's greedy tokens
    equal to the plain tick's, logits within 2e-4, over forced tokens."""
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (1, 15, 16, 40)]
    forced = rng.integers(0, cfg.vocab, (6, len(prompts))).astype(np.int32)
    out = {}
    for backend in ("cuda", "plain"):
        ad = make_adapter(cfg, params, n_slots=len(prompts), max_len=48,
                          paged=True, block_size=16, chunked=False,
                          backend=backend)
        first = [ad.insert(s, p, max_new=7) for s, p in enumerate(prompts)]
        active = np.ones(len(prompts), bool)
        toks, logits = [], []
        for row in forced:
            toks.append(ad.decode(row, active))
            logits.append(ad.last_logits.clone())
        out[backend] = (first, np.stack(toks), torch.stack(logits))
    assert out["cuda"][0] == out["plain"][0]
    np.testing.assert_array_equal(out["cuda"][1], out["plain"][1])
    torch.testing.assert_close(out["cuda"][2], out["plain"][2], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tick_on_card_bitwise_gather_and_replay(dev, dtype):
    """The int8 layout on the card (starcoder2's smoke config,
    ``kv_quant``): the kernel ticks refused, the in-place plain tick's
    tokens, logits and every chain block of the four arenas bit for bit the
    gather oracle's over forced tokens, and the captured tick bit for bit
    its eager step; no paged kernel launches."""
    cfg = dataclasses.replace(configs.smoke_config("starcoder2-15b"),
                              param_dtype=dtype, kv_quant=True)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    for backend in ("cuda", "cascade"):
        with pytest.raises(ValueError, match="kv_quant"):
            make_adapter(cfg, params, n_slots=2, max_len=48, paged=True,
                         backend=backend)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 20, 33)]
    ads = [make_adapter(cfg, params, n_slots=3, max_len=64, paged=True,
                        block_size=16, backend=b) for b in ("plain",
                                                            "gather")]
    assert ads[0].backend == "plain" and ads[0].arena["k"].dtype == \
        torch.int8
    for s, p in enumerate(prompts):
        assert ads[0].insert(s, p, 8) == ads[1].insert(s, p, 8)
    active = np.ones(3, bool)
    before = paged_attn_kernel.paged_decode_attention.launches
    for row in rng.integers(0, cfg.vocab, (5, 3)).astype(np.int32):
        np.testing.assert_array_equal(ads[0].decode(row, active),
                                      ads[1].decode(row, active))
        assert torch.equal(ads[0].last_logits, ads[1].last_logits)
    assert paged_attn_kernel.paged_decode_attention.launches == before
    for s in range(3):
        for b in ads[0].slot_bids[s]:
            for key in ("k", "v", "k_scale", "v_scale"):
                assert torch.equal(ads[0].arena_block(key, b),
                                   ads[1].arena_block(key, b)), key
    forced = rng.integers(0, cfg.vocab, 3).astype(np.int32)
    step, out = _tick_replay_and_eager(ads[0], forced, active)
    (lr, ar, cr), (le, ae, ce) = out["replay"], out["eager"]
    assert torch.equal(lr, le) and bool(torch.isfinite(lr).all())
    for key in ar:
        assert torch.equal(ar[key], ae[key]), key
    assert cr == ce


# -- sharded and disaggregated serving on the card -----------------------------

def test_forced_migration_on_card_bitwise(dev):
    """Two slices on the one card (``build_slices`` over two groups of
    ``cuda:0``): a lane migrated mid-decode from slice A to slice B, its
    blocks and state row through the host, continues the stay-put
    oracle's logits bit for bit under the kernel tick (bf16)."""
    from repro_torch.serve.shard import build_slices, migrate_slot
    cfg, params = _smoke_lm(dev, "bfloat16")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9)]
    oracle = make_adapter(cfg, params, n_slots=2, max_len=24, paged=True,
                          block_size=4)
    A, B = (sl.adapter for sl in build_slices(
        cfg, params, [[dev], [dev]], n_slots=2, max_len=24, block_size=4))
    assert A.backend == B.backend == oracle.backend == "cuda"
    active = np.ones(2, bool)
    for slot, p in enumerate(prompts):
        assert oracle.insert(slot, p, max_new=8) == \
            A.insert(slot, p, max_new=8)
    for _ in range(3):
        forced = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        assert np.array_equal(oracle.decode(forced, active),
                              A.decode(forced, active))
    receipt = migrate_slot(A, 1, B, 1, prompts[1])
    assert receipt.blocks_moved > 0 and receipt.bytes_moved > 0
    assert not A.slot_bids[1]
    lane1 = np.asarray([False, True])
    before = paged_attn_kernel.paged_decode_attention.launches
    for _ in range(3):
        forced = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        to, tb = oracle.decode(forced, active), B.decode(forced, lane1)
        assert to[1] == tb[1]
        assert torch.equal(oracle.last_logits[1], B.last_logits[1])
    assert paged_attn_kernel.paged_decode_attention.launches > before


def test_prefill_role_step_launches_no_tick_graph(dev):
    """``ContinuousBatcher.step(decode=False)`` on a prefill slice admits
    (the fold through ``flash_attention``) and stages the prefill token,
    but captures and replays no tick and launches no decode kernel; the
    handoff's decode slice then runs its captured tick."""
    from repro_torch.serve.shard import RolePlan
    cfg, params = _smoke_lm(dev, "bfloat16")
    gw = make_gateway(cfg, params, ServeSpec(
        n_slots=2, max_len=64, paged=True, mesh=[[dev], [dev]],
        roles=RolePlan.split(1, 1), max_new_tokens=4))
    pre, dec = (sl.batcher for sl in gw.slices)
    rng = np.random.default_rng(3)
    req = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 20).astype(
        np.int32), max_new_tokens=4)
    gw.submit(req)
    counts = kernels.read_counts()
    assert pre.step(decode=False) == []
    after = kernels.read_counts()
    assert after["flash_attention"] > counts["flash_attention"]
    for name in ("paged_decode_attention", "scatter_kv_rows"):
        assert after[name] == counts[name], name
    assert pre.adapter._decode._cache_size() == 0
    assert pre.active[0] is req and len(req.generated) == 1
    assert pre.last_token[0] == req.generated[0]
    done = []
    while gw.busy:
        done += gw.step()
    assert done == [req] and len(req.generated) == 4
    assert gw.handoffs == 1
    assert pre.adapter._decode._cache_size() == 0
    assert dec.adapter._decode._cache_size() == 1


# -- training: the flash attention backward and the train step ---------------

def _bwd_inputs(dev, dtype, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset,
                seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=gen).to(dtype).to(dev)
    k = torch.randn((B, Sk, Hkv, D), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, Sk, Hkv, D), generator=gen).to(dtype).to(dev)
    dout = torch.randn((B, Sq, Hq, D), generator=gen).to(dtype).to(dev)
    out, lse = flash_kernel.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        return_lse=True)
    return q, k, v, out, dout, lse


BWD_CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset
    (2, 200, 200, 4, 4, 80, True, 0, 0),
    (1, 130, 130, 8, 2, 128, True, 0, 0),
    (1, 96, 96, 6, 2, 64, True, 24, 0),
    (2, 16, 80, 4, 4, 40, True, 0, 64),
    (1, 70, 300, 4, 4, 64, False, 0, 0),
    (1, 33, 33, 12, 1, 128, True, 0, 0),
    # GQA 8:1 x 128, its heads split (bwd_head_split_plan: 8 runs of 1)
    (1, 256, 256, 16, 2, 128, True, 0, 0),
    # split (4 runs of 1), a ragged last key tile, non-causal
    (1, 64, 1500, 8, 2, 64, False, 0, 0)]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_against_plain(dev, case, dtype):
    """The backward kernel against its plain version on the same CUDA
    tensors (float32 within 2e-5, bf16 within 1e-2 of each gradient's max
    |value|), a second call bit for bit, one launch a call; the forward's
    lse within 2e-5 of the plain forward's, its output bitwise the call
    without lse."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset = case
    q, k, v, out, dout, lse = _bwd_inputs(dev, dtype, *case, seed=Sq + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert torch.equal(out, flash_kernel.flash_attention(q, k, v, **kw))
    _, plain_lse = ref.flash_attention_chunked(
        q, k, v, causal, window, q_offset, return_lse=True)
    torch.testing.assert_close(lse, plain_lse, rtol=2e-5, atol=2e-5)
    before = flash_kernel.flash_attention_bwd.launches
    got = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert flash_kernel.flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_chunked(q, k, v, out, dout, lse, causal,
                                           window, q_offset)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err
    again = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_in_split_combine(monkeypatch, dev, dtype):
    """A fold chunk split one tile per CTA writes its lse in the combine:
    within 2e-5 of the plain forward's, and the output bitwise the call
    without lse."""
    monkeypatch.setattr(flash_kernel, "MIN_CTAS", 1 << 30)
    q, k, v, out, dout, lse = _bwd_inputs(dev, dtype, 1, 16, 400, 4, 4, 80,
                                          True, 0, 384, seed=9)
    assert flash_kernel.flash_split_plan(1, 16, 400, 4, 384, 0)[0] > 1
    assert torch.equal(out, flash_kernel.flash_attention(q, k, v,
                                                         q_offset=384))
    _, plain_lse = ref.flash_attention_chunked(q, k, v, True, 0, 384,
                                               return_lse=True)
    torch.testing.assert_close(lse, plain_lse, rtol=2e-5, atol=2e-5)


def test_attend_chunked_grad_runs_the_kernels(dev):
    """``attend_chunked`` with grad: forward and backward kernels once
    each, gradients equal to the backward wrapper's; without grad the
    call is the plain forward, bit for bit."""
    q, k, v, out, dout, lse = _bwd_inputs(dev, torch.bfloat16, 1, 64, 64, 4,
                                          2, 64, True, 0, 0, seed=3)
    with torch.no_grad():
        assert torch.equal(attention.attend_chunked(q, k, v), out)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = kernels.read_counts()
    o = attention.attend_chunked(*leaves)
    grads = torch.autograd.grad(o, leaves, dout)
    after = kernels.read_counts()
    assert after["flash_attention"] == counts["flash_attention"] + 1
    assert after["flash_attention_bwd"] == counts["flash_attention_bwd"] + 1
    assert torch.equal(o.detach(), out)
    want = flash_kernel.flash_attention_bwd(q, k, v, out, dout, lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_train_step_on_card_matches_cpu(dev):
    """One float32 ``make_train_step`` step of the smoke model (TF32 off)
    on the card against the CPU: loss within 1e-5 relative, parameters
    within the reference's own 2e-3 / 2e-5; the flash kernels launched
    forward (with its remat recompute) and backward once per layer."""
    from repro_torch.data.tokens import batch_at
    from repro_torch.train import optim
    from repro_torch.train.step import TrainConfig, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.smoke_config("stablelm-3b"),
                              param_dtype="float32", remat="full")
    tcfg = TrainConfig()
    sides = {}
    for d in (torch.device("cpu"), dev):
        params = lm.init(cfg, torch.Generator().manual_seed(0))
        params = optim.unflatten(params, [p.to(d) for p in
                                          optim.leaves(params)])
        opt = optim.init(params, tcfg.adamw)
        batch = {k: torch.from_numpy(v).to(d)
                 for k, v in batch_at(0, 0, 2, 64, cfg.vocab).items()}
        counts = kernels.read_counts()
        params, opt, m = make_train_step(cfg, tcfg)(params, opt, batch)
        after = kernels.read_counts()
        sides[d.type] = (params, m, {n: after[n] - counts[n]
                                     for n in ("flash_attention",
                                               "flash_attention_bwd")})
    (pc, mc, _), (pg, mg, launches) = sides["cpu"], sides["cuda"]
    assert launches == {"flash_attention": 2 * cfg.n_layers,
                        "flash_attention_bwd": cfg.n_layers}
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-5 * abs(float(mc["loss"]))
    for a, b in zip(optim.leaves(pg), optim.leaves(pc)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=2e-5)


def test_flash_attention_bwd_kernel_refuses_bad_inputs(dev):
    q, k, v, out, dout, lse = _bwd_inputs(dev, torch.float32, 1, 16, 16, 2,
                                          2, 64, True, 0, 0, seed=1)
    bwd = flash_kernel.flash_attention_bwd
    with pytest.raises(ValueError):               # lse of the wrong shape
        bwd(q, k, v, out, dout, lse[:, :8].contiguous())
    with pytest.raises(ValueError):               # dout of the wrong shape
        bwd(q, k, v, out, dout[:, :8].contiguous(), lse)
    with pytest.raises(TypeError):                # dout in another dtype
        bwd(q, k, v, out, dout.bfloat16(), lse)
    with pytest.raises(ValueError):               # not contiguous
        bwd(q, k, v, out, dout.transpose(1, 2).contiguous().transpose(1, 2),
            lse)


# --------------------------------------------------------------------------
# Sharded serving's model axis: kernel 5 at a block stride (the split-KV
# fallback's shards) and the sharded kernel ticks against the plain ones.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 64])
def test_kernel5_block_stride_matches_plain(dev, shards, dtype, window):
    """Each fallback shard's sweep (``bs / shards`` rows of every
    16-position block, ``q0`` its first in-block position, ``block_stride``
    16; 25 heads over 5 KV heads of 64, the new row spliced in) against its
    plain version, and the shards' states merged (``merge_attn_states``,
    over four shards ``merge_attn_states_n``, itself within 2e-5 of its
    plain version) against the plain read of the whole arena; at
    ``block_stride`` = bs the default sweep bit for bit."""
    B, Hq, Hkv, D, bs, nb = 4, 25, 5, 64, 16, 20
    gen = torch.Generator(device=dev).manual_seed(shards)
    rows = bs // shards
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    num_blocks = B * nb + 1
    tables = (torch.randperm(num_blocks - 1, generator=gen, device=dev)
              + 1).reshape(B, nb).to(torch.int32)
    lens = torch.tensor([1, 17, 150, 319], dtype=torch.int32, device=dev)
    ka, va = (torch.randn((num_blocks, bs, Hkv, D), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    nk = tuple(torch.randn((B, Hkv, D), generator=gen, device=dev)
               .to(dtype) for _ in range(2))
    wrap = paged_attn_kernel.paged_decode_attention_with_state
    states = []
    before = wrap.launches
    for d in range(shards):
        kd = ka[:, d * rows:(d + 1) * rows].contiguous()
        vd = va[:, d * rows:(d + 1) * rows].contiguous()
        q0 = torch.full((B,), d * rows, dtype=torch.int32, device=dev)
        got = wrap(q, kd, vd, tables, lens, window=window, q0=q0, new_kv=nk,
                   block_stride=bs)
        want = ref.paged_decode_attention_with_state(
            q, kd, vd, tables, lens, window, q0, nk, bs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
        states.append(got)
    assert wrap.launches == before + shards
    merges = paged_attn_kernel.merge_attn_states.launches
    if shards == 2:
        merged = paged_attn_kernel.merge_attn_states(*states[0], *states[1])
    else:
        stacked = [torch.stack(ts) for ts in zip(*states)]
        merged = paged_attn_kernel.merge_attn_states_n(*stacked)
        torch.testing.assert_close(merged, ref.merge_attn_states_n(*stacked),
                                   rtol=2e-5, atol=2e-5)
    assert paged_attn_kernel.merge_attn_states.launches == merges + 1
    merged = merged.to(dtype)
    whole = ref.paged_decode_attention(q, ka, va, tables, lens, window, nk)
    torch.testing.assert_close(merged.float(), whole.float(), rtol=tol,
                               atol=tol)
    for got, want in zip(wrap(q, ka, va, tables, lens, window=window,
                              new_kv=nk, block_stride=bs),
                         wrap(q, ka, va, tables, lens, window=window,
                              new_kv=nk)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch,kv_heads,width", [("stablelm-3b", None, 2),
                                                 ("hymba-1.5b", 1, 2),
                                                 ("hymba-1.5b", 1, 4)])
def test_sharded_kernel_tick_matches_sharded_plain_tick(dev, arch, kv_heads,
                                                        width):
    """A slice of ``width`` devices (each the card) through the ``"cuda"``
    tick against the same slice through the plain tick, float32: greedy
    tokens equal and logits within 2e-4 (the paged kernel tick's
    contract).  stablelm's 4 KV heads split two a shard (kernel 3 per
    shard); hymba's smoke config at one KV head takes the split-KV
    fallback (kernel 5 at the block stride per shard, then one merge of
    their states, its window of 16 masking); every shard's launches
    counted."""
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32")
    if kv_heads:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 17, 33)]
    forced = rng.integers(0, cfg.vocab, (6, len(prompts))).astype(np.int32)
    out = {}
    for backend in ("cuda", "plain"):
        ad = make_adapter(cfg, params, n_slots=len(prompts), max_len=48,
                          paged=True, block_size=16, backend=backend,
                          mesh=[dev] * width)
        assert len(ad.shards) == width
        first = [ad.insert(s, p, max_new=8) for s, p in enumerate(prompts)]
        active = np.ones(len(prompts), bool)
        counts = kernels.read_counts()
        toks, logits = [], []
        for row in forced:
            toks.append(ad.decode(row, active))
            logits.append(ad.last_logits.clone())
        after = kernels.read_counts()
        out[backend] = (first, np.stack(toks), torch.stack(logits),
                        {k: after[k] - counts[k] for k in after})
    assert out["cuda"][0] == out["plain"][0]
    np.testing.assert_array_equal(out["cuda"][1], out["plain"][1])
    torch.testing.assert_close(out["cuda"][2], out["plain"][2], rtol=2e-4,
                               atol=2e-4)
    launches, ticks = out["cuda"][3], len(forced)
    sweeps = "paged_decode_attention_with_state" if kv_heads else \
        "paged_decode_attention"
    assert launches[sweeps] == width * cfg.n_layers * ticks
    assert launches["scatter_kv_rows"] == width * ticks
    if kv_heads:
        assert launches["merge_attn_states"] == cfg.n_layers * ticks


def _dist_mesh_run(dev, steps: int):
    """``tests/test_dist.py``'s config in float32 on the (2, 2, 2)
    ``("pod", "data", "model")`` mesh of the card (every coordinate this
    device) against the one-device step from the same state, step by step:
    (losses, one-device losses, the sharded steps' flash launches, the
    parameter elements past ``rtol=2e-3, atol=2e-5``)."""
    from repro_torch.data.tokens import batch_at
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optim
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = lm.LMConfig(name="t", family="decoder", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                      vocab=256, remat="full", param_dtype="float32")
    tcfg = TrainConfig(microbatches=2, adamw=optim.AdamWConfig(
        lr=1e-2, weight_decay=0.1, grad_clip=1.0,
        master_dtype=torch.float32))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), dev)
    ms = shd.mesh_shape_dict(mesh)
    p = shd.shard(lm.init(cfg, torch.Generator(device=dev).manual_seed(0)),
                  shd.named(mesh, lm.param_specs(cfg, ms)))
    o = optim.init(p, tcfg.adamw)
    step, one = make_train_step(cfg, tcfg, mesh), make_train_step(cfg, tcfg)
    losses, ones, launches, misses = [], [], {}, 0
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_at(0, i, 8, 32, cfg.vocab).items()}
        p1, o1, m1 = one(shd.gather(p, dev), shd.gather(o, dev), b)
        before = kernels.read_counts()
        p, o, m = step(p, o, b)
        after = kernels.read_counts()
        for k in ("flash_attention", "flash_attention_bwd"):
            launches[k] = launches.get(k, 0) + after[k] - before[k]
        losses.append(float(m["loss"]))
        ones.append(float(m1["loss"]))
        for x, y in zip(optim.leaves(shd.gather(p, dev)), optim.leaves(p1)):
            misses += int(((x - y).abs() > 2e-5 + 2e-3 * y.abs()).sum())
    return losses, ones, launches, misses


def test_mesh_step_matches_one_device_step(dev):
    """Three sharded steps of ``tests/test_dist.py``'s config on (2, 2, 2),
    every coordinate the card, through the flash kernels: each loss within
    1e-5 relative of the one-device step's from the same state, and every
    parameter within ``rtol=2e-3, atol=2e-5``."""
    losses, ones, _, misses = _dist_mesh_run(dev, 3)
    np.testing.assert_allclose(losses, ones, rtol=1e-5)
    assert misses == 0


def test_mesh_step_flash_launches(dev):
    """The flash kernels launch per layer, model shard, data-parallel
    coordinate and microbatch: 2 x 2 x 4 x 2, twice forward under
    ``remat="full"`` and once backward, a step."""
    _, _, launches, _ = _dist_mesh_run(dev, 2)
    assert launches == {"flash_attention": 2 * 2 * 2 * 4 * 2 * 2,
                        "flash_attention_bwd": 2 * 2 * 4 * 2 * 2}
