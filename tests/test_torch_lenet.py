"""The port's LeNet and frame stages against the reference on shared weights:
the SC first layer and the link payload bit for bit, logits within float32
tolerance (XLA and ATen sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lenet5
from repro.models import lenet as jlenet
from repro.serve.gateway import frontend as jfe
from repro_torch.convert import lenet_params_from_jax
from repro_torch.data import mnist_synth
from repro_torch.models import lenet
from repro_torch.serve.gateway import frontend as fe

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

SMOKE = lenet.LeNetConfig(conv1_filters=8, conv2_filters=8, dense=32)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def shared():
    """(reference params, port params on the CPU, uint8 frames)."""
    jparams = jlenet.init(jax.random.key(3), lenet5.smoke_config())
    params = lenet_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    frames = mnist_synth.dataset(6, 0, seed=5)[0]            # (6,28,28,1) u8
    return jparams, params, frames


def _specs(mode, bits):
    return (fe.FrontendSpec(mode=mode, bits=bits, lenet=SMOKE),
            jfe.FrontendSpec(mode=mode, bits=bits,
                             lenet=lenet5.smoke_config(), sc_impl="table"))


def test_smoke_config_matches_reference():
    assert SMOKE == lenet.LeNetConfig(**vars(lenet5.smoke_config()))
    assert lenet.LeNetConfig() == lenet.LeNetConfig(**vars(lenet5.config()))


def test_convert_round_trips_shapes(shared):
    jparams, params, _ = shared
    for layer, leaves in jparams.items():
        for k, v in leaves.items():
            got = params[layer][k]
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    init = lenet.init(0, SMOKE, device="cpu")
    assert {(l, k): tuple(v.shape) for l, d in init.items()
            for k, v in d.items()} == \
        {(l, k): tuple(v.shape) for l, d in jparams.items()
         for k, v in d.items()}


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_first_layer_sc_bitwise(shared, bits):
    jparams, params, frames = shared
    x = frames.astype(np.float32) / 255.0
    spec, jspec = _specs("sc", bits)
    got = lenet.first_layer(params, torch.from_numpy(x), mode="sc",
                            sc_cfg=spec.sc_cfg).numpy()
    want = np.asarray(jlenet.first_layer(jparams, jnp.asarray(x), mode="sc",
                                         sc_cfg=jspec.sc_cfg,
                                         sc_impl="table"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,bits", [("sc", 2), ("sc", 4), ("sc", 8),
                                       ("binary", 4)])
def test_stages_match_reference(shared, mode, bits):
    jparams, params, frames = shared
    spec, jspec = _specs(mode, bits)
    payload = fe.sensor_stage(params, torch.from_numpy(frames), spec)
    jpayload = jfe.sensor_stage(jparams, jnp.asarray(frames), jspec)
    assert payload.dtype == torch.uint8
    assert payload.numpy().tobytes() == np.asarray(jpayload).tobytes()
    if mode == "sc":
        assert payload.shape[1] == fe.link_bytes_per_frame(spec)
    logits = fe.gateway_stage(params, payload, spec).numpy()
    jlogits = np.asarray(jfe.gateway_stage(jparams, jpayload, jspec))
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), jlogits.argmax(-1))


@pytest.mark.parametrize("mode", ["float", "binary", "sc"])
def test_apply_matches_reference(shared, mode):
    jparams, params, frames = shared
    x = frames.astype(np.float32) / 255.0
    spec, jspec = _specs(mode if mode != "float" else "sc", 4)
    got = lenet.apply(params, torch.from_numpy(x), mode=mode,
                      sc_cfg=spec.sc_cfg, bits=4).numpy()
    want = np.asarray(jlenet.apply(jparams, jnp.asarray(x), mode=mode,
                                   sc_cfg=jspec.sc_cfg, bits=4))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("shape", [(14, 14, 8), (3, 5, 1), (2, 2, 3)])
def test_pack_unpack_ternary_round_trip(shape):
    rng = np.random.default_rng(len(shape))
    h = rng.integers(-1, 2, (4,) + shape).astype(np.float32)
    packed = fe.pack_ternary(torch.from_numpy(h))
    assert packed.shape == (4, -(-int(np.prod(shape)) // 4))
    assert packed.numpy().tobytes() == \
        np.asarray(jfe.pack_ternary(jnp.asarray(h))).tobytes()
    np.testing.assert_array_equal(fe.unpack_ternary(packed, shape).numpy(), h)


@pytest.mark.parametrize("mode", ["sc", "binary"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_accounting_matches_reference(mode, bits):
    spec = fe.FrontendSpec(mode=mode, bits=bits)
    jspec = jfe.FrontendSpec(mode=mode, bits=bits)
    assert fe.link_bytes_per_frame(spec) == jfe.link_bytes_per_frame(jspec)
    assert fe.frame_energy_nj(spec) == jfe.frame_energy_nj(jspec)
    assert fe.sensor_latency_s(spec) == jfe.sensor_latency_s(jspec)
    assert fe.link_energy_nj(1568) == jfe.link_energy_nj(1568)
