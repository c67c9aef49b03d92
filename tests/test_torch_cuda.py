"""The port's CUDA kernels against their plain versions on the card, bit for
bit, and the frame stages on the card against the CPU.  Without a CUDA
device every test here skips; on a card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import sng
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sc_dot as sc_dot_kernel
from repro_torch.kernels import sng_pack as sng_pack_kernel
from repro_torch.models import lenet
from repro_torch.serve.gateway import frontend as fe

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
