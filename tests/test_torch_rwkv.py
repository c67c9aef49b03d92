"""The port's rwkv family (rwkv6-7b's smoke size, the reference's weights
through ``convert.lm_params_from_jax``, numpy-seeded inputs) against the
reference on the CPU: the configs field for field, the parameter tree,
``wkv6_chunked`` (chunks 4 and 16, with and without a state) and
``wkv6_step`` within 2e-5 in float32 and within one bf16 rounding on bf16
inputs, the refused length; ``rwkv_block`` at S = 1 and S = 16,
``engine.prefill`` and ``engine.decode_step`` with logits within 2e-4,
the shift states within 1e-5 and the wkv state within 1e-5 at layer 0 and
the reference's own wkv contract, 2e-4, below it; the bf16 prefill, whose first layer's state pins the
decay's two roundings; the ``first_layer_mode="sc"`` prefill."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.nn import ssm
from repro_torch.serve import engine
from test_torch_lm import smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

ARCH = "rwkv6_7b"
TOL = 2e-5
# bf16 r, k, v, w and u: both sides widen the same bf16 values and round
# the output to bf16 once, so they may differ by one rounding, 2**-8 of
# an element or one bf16 ulp at the output's largest magnitude
# (:func:`_bf16_ulp`; measured: 0.0)
BF16_RTOL = 2.0 ** -8
# the bf16 prefill's logits (3 layers of bf16 products, rounded where each
# package's matrix products round): measured 0.024
BF16_LOGITS = 0.04
LOGITS, STATE = 2e-4, 1e-5
# the wkv state below layer 0: both sides round float32 differently and
# carry the difference down the layers (measured at the smoke size: 2.4e-6,
# 1.05e-5 and 1.85e-5 for layers 0-2 after a 16-token prefill), so the
# deeper layers are held to the reference's own wkv contract
# (``tests/test_ssm.py``)
WKV_DEEP = 2e-4
KEYS = ("wkv", "shift1", "shift2")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32), np.asarray(want, np.float32),
        rtol=tol, atol=tol)


def _close_state(key, got, want):
    """One state of every layer (leading axis L): the wkv state's layer 0
    within ``STATE`` (both sides read the same embedding rows there), its
    deeper layers within ``WKV_DEEP``; the shift rows within ``STATE``."""
    if key != "wkv":
        return _close(got, want, STATE)
    _close(got[:1], np.asarray(want)[:1], STATE)
    _close(got[1:], np.asarray(want)[1:], WKV_DEEP)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(arch=ARCH)


@pytest.fixture(scope="module")
def jprefill():
    """The reference's prefill, jitted once per module (as its adapters
    run it)."""
    return jax.jit(jengine.prefill, static_argnums=0)


def _wkv_inputs(seed, B=2, S=32, H=4, D=8):
    """r, k, v, the decay w in (0, 1) (as ``tests/test_ssm.py`` draws
    it), u and a state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2, 1, (B, S, H, D)))).astype(np.float32)
    u = rng.normal(0, 0.3, (H, D)).astype(np.float32)
    s0 = rng.normal(0, 1, (B, H, D, D)).astype(np.float32)
    return (r, k, v, w, u), s0


def _bf16_ulp(a) -> float:
    """One bf16 ulp at the largest magnitude in ``a`` (8 significant
    bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(
        np.asarray(a, np.float32)).max())) - 7))


def _bf16(arrays):
    return (tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays),
            tuple(_t(a).to(torch.bfloat16) for a in arrays))


@pytest.mark.parametrize("arch_fn", ["config", "smoke_config"])
def test_config_matches_reference(arch_fn):
    cfg = getattr(configs, arch_fn)(ARCH)
    jcfg = getattr(jconfigs, arch_fn)(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert configs.config("rwkv6-7b") == configs.config(ARCH)
    assert cfg.family == "rwkv"


def test_params_tree_and_conversion(pair):
    """``lm.init`` builds the reference's tree (names in the reference's
    order, shapes, dtypes, the fills: ``mu`` 0.5, ``w0`` -6, norms 1) and
    ``convert.lm_params_from_jax`` carries the reference's over
    unchanged, bf16 bit for bit."""
    jcfg, jparams, cfg, params = pair
    cfg16 = configs.smoke_config(ARCH)
    ours = lm.init(cfg16, torch.Generator().manual_seed(0))
    jours, _ = jlm.init(jax.random.key(0), jconfigs.smoke_config(ARCH), {})
    assert list(ours) == list(jours)
    assert list(ours["blocks"]) == list(jours["blocks"])
    flat = jax.tree_util.tree_flatten_with_path(jours)[0]
    for path, leaf in flat:
        t = ours
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    b = ours["blocks"]
    assert bool((b["mu"] == 0.5).all() and (b["w0"] == -6).all())
    assert bool((b["ln_wkv"]["scale"] == 1).all())
    from repro_torch.convert import lm_params_from_jax
    conv = lm_params_from_jax(jax.tree.map(np.asarray, jours), cfg16, "cpu")
    for path, leaf in flat:
        t = conv
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16))


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_chunked_matches_reference(chunk, with_state):
    arrays, s0 = _wkv_inputs(chunk)
    state = s0 if with_state else None
    out, st = ssm.wkv6_chunked(*map(_t, arrays), chunk=chunk,
                               state0=None if state is None else _t(state))
    jout, jst = jssm.wkv6_chunked(*map(jnp.asarray, arrays), chunk=chunk,
                                  state0=None if state is None
                                  else jnp.asarray(state))
    assert out.dtype == st.dtype == torch.float32
    assert out.shape == jout.shape and st.shape == jst.shape
    _close(out, jout, TOL)
    _close(st, jst, TOL)


@pytest.mark.parametrize("chunk", [4, 16])
def test_wkv6_chunked_bf16_matches_reference(chunk):
    """bf16 inputs: the stacked r, k, v stay bf16, the log-decay is
    rounded to bf16 before the cumulative sum, the output is bf16 and the
    state float32."""
    arrays, _ = _wkv_inputs(10 + chunk)
    jarrays, tarrays = _bf16(arrays)
    out, st = ssm.wkv6_chunked(*tarrays, chunk=chunk)
    jout, jst = jssm.wkv6_chunked(*jarrays, chunk=chunk)
    assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=BF16_RTOL, atol=_bf16_ulp(jout))
    _close(st, jst, TOL)


def test_wkv6_step_matches_reference():
    """One step in float32 and on bf16 inputs (widened to float32 on both
    sides: the output and the state are float32)."""
    (r, k, v, w, u), s0 = _wkv_inputs(3)
    step = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
    out, st = ssm.wkv6_step(*map(_t, step), _t(s0))
    jout, jst = jssm.wkv6_step(*map(jnp.asarray, step), jnp.asarray(s0))
    _close(out, jout, TOL)
    _close(st, jst, TOL)
    jstep, tstep = _bf16(step)
    out, st = ssm.wkv6_step(*tstep, _t(s0))
    jout, jst = jssm.wkv6_step(*jstep, jnp.asarray(s0))
    assert out.dtype == st.dtype == torch.float32
    _close(out, jout, TOL)
    _close(st, jst, TOL)


def test_wkv6_chunked_equals_steps_and_refuses_a_length():
    """``tests/test_ssm.py::test_wkv6_step_consistent_with_chunked`` on
    the port (within its 2e-4), and a length that is not a multiple of
    the chunk refused in both packages."""
    arrays, _ = _wkv_inputs(5, S=8)
    r, k, v, w, u = map(_t, arrays)
    full, st_c = ssm.wkv6_chunked(r, k, v, w, u, chunk=4)
    st = torch.zeros(st_c.shape)
    outs = []
    for i in range(8):
        o, st = ssm.wkv6_step(r[:, i], k[:, i], v[:, i], w[:, i], u, st)
        outs.append(o)
    _close(torch.stack(outs, 1), full, 2e-4)
    _close(st, st_c, 2e-4)
    with pytest.raises(ValueError, match="chunk"):
        ssm.wkv6_chunked(r[:, :6], k[:, :6], v[:, :6], w[:, :6], u, chunk=4)
    with pytest.raises(AssertionError):
        jssm.wkv6_chunked(*(jnp.asarray(a[:, :6]) for a in arrays[:4]),
                          jnp.asarray(arrays[4]), chunk=4)


def _state(cfg, rng, B, dtype=np.float32):
    """A random block state: wkv (B, H, Dh, Dh) float32, the shift rows
    (B, d)."""
    H, Dh, d = cfg.n_heads, cfg.d_head, cfg.d_model
    return {"wkv": rng.normal(0, 1, (B, H, Dh, Dh)).astype(np.float32),
            "shift1": rng.normal(0, 1, (B, d)).astype(dtype),
            "shift2": rng.normal(0, 1, (B, d)).astype(dtype)}


@pytest.mark.parametrize("S", [1, 16])
def test_rwkv_block_matches_reference(pair, S):
    """Layer 1's block from a random state over one step (the recurrent
    step) and over 16 tokens (the chunked form): x within 1e-5, the new
    state within 1e-5, and the input state unchanged."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(S)
    x = rng.normal(0, 1, (2, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng, 2)
    tst = {k: _t(a.copy()) for k, a in st.items()}
    y, new = lm.rwkv_block(cfg, lm.layer_params(params["blocks"], 1), _t(x),
                           tst)
    jy, jnew = jax.jit(jlm.rwkv_block, static_argnums=0)(
        jcfg, jax.tree.map(lambda a: a[1], jparams["blocks"]),
        jnp.asarray(x), {k: jnp.asarray(a) for k, a in st.items()})
    _close(y, jy, STATE)
    for key in KEYS:
        _close(new[key], jnew[key], STATE)
        np.testing.assert_array_equal(tst[key].numpy(), st[key])


def test_prefill_and_decode_step_match_reference(pair, jprefill):
    """``engine.prefill`` of two 16-token prompts, then two dense ticks
    with lane 1 inactive in the second: logits within 2e-4 (greedy tokens
    equal), every state as :func:`_close_state` holds it; the inactive
    lane's state bit for bit as it was and ``len`` advanced for the active
    lane only."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    cache, logits = engine.prefill(cfg, params, _t(toks))
    jcache, jlogits = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    assert set(cache) == set(jcache) == {"len", *KEYS}
    assert int(cache["len"]) == 16
    _close(logits, jlogits, LOGITS)
    for key in KEYS:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert cache[key].dtype == (torch.float32 if key == "wkv"
                                    else cfg.dtype)
        _close_state(key, cache[key], jcache[key])
    cache["len"] = cache["len"].expand(2).clone()
    for active in (None, np.array([True, False])):
        t = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        before = {k: a.clone() for k, a in cache.items()}
        cache, logits = engine.decode_step(
            cfg, params, cache, _t(t),
            None if active is None else _t(active))
        jnew, jlogits = jengine.decode_step(jcfg, jparams, jcache,
                                            jnp.asarray(t))
        _close(logits, jlogits, LOGITS)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      np.asarray(jlogits).argmax(-1))
        if active is None:
            jcache = jnew
            for key in KEYS:
                _close_state(key, cache[key], jcache[key])
            continue
        for key in KEYS:
            torch.testing.assert_close(cache[key][:, 1], before[key][:, 1],
                                       rtol=0, atol=0)
            _close_state(key, cache[key][:, 0], jnew[key][:, 0])
        assert cache["len"].tolist() == [18, 17]


def test_bf16_prefill_pins_the_decay_roundings(jprefill):
    """bf16 prefill of two 16-token prompts: layer 0 reads the same
    embedding rows on both sides, so its wkv state is the reference's
    within 1e-5 only if the decay is rounded to bf16 before the wkv and
    the log-decay rounded to bf16 before its cumulative sum (without the
    first it is 0.13 off, without the second 6.7e-4); the logits within
    ``BF16_LOGITS``, greedy tokens equal, the other states finite."""
    jcfg, jparams, cfg, params = smoke_pair("bfloat16", arch=ARCH)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)
                                             ).astype(np.int32)
    cache, logits = engine.prefill(cfg, params, _t(toks))
    jcache, jlogits = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    _close(cache["wkv"][0], jcache["wkv"][0], STATE)
    for key in ("shift1", "shift2"):
        assert cache[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            cache[key][0].float().numpy(),
            np.asarray(jcache[key][0], np.float32))
    _close(logits, jlogits, BF16_LOGITS)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert all(bool(torch.isfinite(cache[k].float()).all()) for k in KEYS)


def test_sc_frontend_prefill_matches_reference(jprefill):
    """``first_layer_mode="sc"`` at bits 4: the prompt runs the SC layer
    (the kernels' plain versions on the CPU) before the blocks; logits
    within 2e-4 and the states within 1e-5 of the reference's."""
    jcfg, jparams, cfg, params = smoke_pair(arch=ARCH,
                                            first_layer_mode="sc",
                                            sc_bits=4)
    assert "sc_frontend" in params
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 16)
                                             ).astype(np.int32)
    cache, logits = engine.prefill(cfg, params, _t(toks))
    jcache, jlogits = jprefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    _close(logits, jlogits, LOGITS)
    for key in KEYS:
        _close(cache[key], jcache[key], STATE)
