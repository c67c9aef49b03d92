"""The port's CUDA kernels against their plain versions on the card, bit for
bit, and the frame stages on the card against the CPU.  Without a CUDA
device every test here skips; on a card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import configs
from repro_torch.core import sng
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attn as paged_attn_kernel
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel
from repro_torch.models import lenet, lm
from repro_torch.serve.gateway import frontend as fe
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
    N = 1 << bits
    gen = torch.Generator().manual_seed(bits)
    lv = torch.randint(0, N + 1, (517, 25), generator=gen,
                       dtype=torch.int32).to(dev)
    before = sng_pack_kernel.sng_pack.launches
    for codes in sng.codes_tensors("lfsr_pair", bits, dev):
        got = ops.sng_pack(lv, codes, N)
        assert torch.equal(got, ref.sng_pack(lv, codes, N))
    assert sng_pack_kernel.sng_pack.launches == before + 2


@pytest.mark.parametrize("M,K,O,Wd", [(1, 2, 1, 1), (77, 25, 40, 1),
                                      (300, 64, 33, 8), (9, 1024, 5, 2)])
@pytest.mark.parametrize("s0_mode,adder", [
    ("zero", "tff"), ("one", "tff"), ("alt", "tff"), ("alt", "ideal")])
def test_sc_dot_kernel_bitwise(dev, M, K, O, Wd, s0_mode, adder):
    gen = torch.Generator().manual_seed(M + K)
    x, w = _words(gen, M, K, Wd, dev=dev), _words(gen, K, O, Wd, dev=dev)
    before = sc_dot_kernel.sc_dot.launches
    got = ops.sc_dot(x, w, s0_mode=s0_mode, adder=adder)
    assert sc_dot_kernel.sc_dot.launches == before + 1
    assert torch.equal(got, ops.sc_dot(x.cpu(), w.cpu(), s0_mode=s0_mode,
                                       adder=adder).to(dev))


def test_sc_dot_kernel_refuses_bad_shapes(dev):
    x = torch.zeros((4, 24, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc_dot_kernel.sc_dot(x, torch.zeros((24, 3, 1), dtype=torch.int32,
                                            device=dev))


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
