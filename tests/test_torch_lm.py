"""The port's LM building blocks and decoder-family prefill against the
reference on the same inputs (numpy, seeded) and the same weights
(``convert.lm_params_from_jax``), at the stablelm-3b smoke size in float32:
norms, RoPE and SwiGLU within 1e-6, attention within 1e-5, prefill logits
and the K/V cache within 1e-5; the same prefill for the moe family
(deepseek-moe-16b's smoke size, routed dropless and with drops)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import mlp as jmlp
from repro.nn import norms as jnorms
from repro.nn import rope as jrope
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm
from repro_torch.nn import attention, mlp, moe, norms, rope
from repro_torch.serve import engine

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

ARCH = "stablelm_3b"
MOE = "deepseek_moe_16b"
HYMBA = "hymba_1_5b"
ENCDEC = "whisper_medium"
VLM = "llama32_vision_90b"
# the vlm family's cross-attention gate in the parity tests: the
# reference initializes it to 0, where tanh(0) hides the whole cross path
VLM_GATE = 0.5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def smoke_pair(dtype="float32", arch=ARCH, **kw):
    """(reference cfg, reference params, port cfg, port params) with the
    reference's weights carried over; ``kw`` replaces config fields on
    both sides."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               param_dtype=dtype, **kw)
    cfg = dataclasses.replace(configs.smoke_config(arch), param_dtype=dtype,
                              **kw)
    jparams, _ = jlm.init(jax.random.key(0), jcfg, {})
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    return jcfg, jparams, cfg, params


def frames(cfg):
    """The reference tests' frame embeddings for the encdec family
    (``tests/test_paged_decode.py``): (1, enc_len, d) float32 from
    ``np.random.default_rng(99)``."""
    rng = np.random.default_rng(99)
    return rng.normal(0, 1, (1, cfg.enc_len, cfg.d_model)).astype(np.float32)


def vision(cfg, seed=98):
    """The reference tests' patch embeddings for the vlm family
    (``tests/test_paged_decode.py``): (1, n_vision_tokens, d) float32 from
    ``np.random.default_rng(98)``."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (1, cfg.n_vision_tokens, cfg.d_model)
                      ).astype(np.float32)


def vlm_pair(dtype="float32", gate=VLM_GATE, **kw):
    """:func:`smoke_pair` for the vlm family with every cross layer's
    ``gate_attn`` set to ``gate`` on both sides."""
    jcfg, jparams, cfg, params = smoke_pair(dtype, arch=VLM, **kw)
    g = jparams["cross_blocks"]["gate_attn"]
    jparams["cross_blocks"]["gate_attn"] = jnp.full_like(g, gate)
    params["cross_blocks"]["gate_attn"] = torch.full(
        tuple(g.shape), gate, dtype=cfg.dtype)
    return jcfg, jparams, cfg, params


def extras_pair(cfg):
    """(the reference's ``extras``, the port's) for ``cfg``'s family: the
    frames of :func:`frames` for the encdec family, the patches of
    :func:`vision` for the vlm family, (None, None) for the others."""
    if cfg.family not in ("encdec", "vlm"):
        return None, None
    key = "enc_embed" if cfg.family == "encdec" else "vision_embed"
    emb = frames(cfg) if cfg.family == "encdec" else vision(cfg)
    return (lambda: {key: jnp.asarray(emb)},
            lambda: {key: torch.from_numpy(emb)})


@pytest.mark.parametrize("arch_fn", ["config", "smoke_config"])
def test_config_matches_reference(arch_fn):
    cfg = getattr(configs, arch_fn)(ARCH)
    jcfg = getattr(jconfigs, arch_fn)(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert cfg.dtype == torch.bfloat16


@pytest.mark.parametrize("window,global_every", [(0, 0), (5, 0), (5, 3)])
def test_layer_window_matches_reference(window, global_every):
    cfg = dataclasses.replace(configs.smoke_config(ARCH), window=window,
                              global_every=global_every)
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), window=window,
                               global_every=global_every)
    for i in range(7):
        assert lm.layer_window(cfg, i) == int(jlm.layer_window(jcfg, i))


def test_sc_frontend_and_other_families_raise():
    """``first_layer_mode="sc"`` is ported: ``lm.init`` builds the
    frontend's (d, d) weights and ones for ``gamma``, in the reference's
    place in the tree; a family no package knows raises ``ValueError``, as
    the reference's ``init`` does, and an arch in neither registry raises
    naming the ROADMAP."""
    cfg = configs.smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(dataclasses.replace(cfg, first_layer_mode="sc"), gen)
    jparams, _ = jlm.init(jax.random.key(0), dataclasses.replace(
        jconfigs.smoke_config(ARCH), first_layer_mode="sc"), {})
    assert list(params) == list(jparams)
    d = cfg.d_model
    assert params["sc_frontend"]["w"].shape == (d, d)
    assert params["sc_frontend"]["w"].dtype == cfg.dtype
    assert torch.equal(params["sc_frontend"]["gamma"],
                       torch.ones(d, dtype=cfg.dtype))
    assert "sc_frontend" not in lm.init(cfg, gen)
    with pytest.raises(ValueError, match="unknown family"):
        lm.init(dataclasses.replace(cfg, family="retnet"), gen)
    # an arch absent from both registries
    assert "gpt2_xl" not in jconfigs.ARCHS + configs.ARCHS
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.config("gpt2-xl")
    with pytest.raises(NotImplementedError):
        configs.smoke_config("gpt2_xl")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 5, 48)).astype(np.float32)
    scale = rng.normal(1, 0.1, (48,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (48,)).astype(np.float32)
    if kind == "rmsnorm":
        got = norms.rmsnorm(_t(x), _t(scale))
        want = jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    else:
        got = norms.layernorm(_t(x), _t(scale), _t(bias))
        want = jnorms.layernorm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("d_head", [40, 80])
def test_rope_matches_reference(d_head):
    rng = np.random.default_rng(d_head)
    x = rng.normal(0, 1, (2, 9, 3, d_head)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32)
    got = rope.apply_rope(_t(x), _t(pos), 10000.0)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(got, want, 1e-6)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    wg, wi = (rng.normal(0, 0.2, (32, 64)).astype(np.float32)
              for _ in range(2))
    wo = rng.normal(0, 0.2, (64, 32)).astype(np.float32)
    got = mlp.swiglu(_t(x), _t(wg), _t(wi), _t(wo))
    want = jmlp.swiglu(*(jnp.asarray(a) for a in (x, wg, wi, wo)))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 6, 0), (False, 0, 0), (True, 0, 5)])
def test_attend_chunked_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, 11, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 11 + q_offset, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=4,
              kv_chunk=8)
    got = attention.attend_chunked(_t(q), _t(k), _t(v), **kw)
    want = jattn.attend_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_attend_decode_matches_reference(window):
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = attention.attend_decode(_t(q), _t(k), _t(v), 9, window=window)
    want = jattn.attend_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 9, window=window)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [1, 7, 13])
def test_prefill_logits_and_cache_match_reference(S):
    jcfg, jparams, cfg, params = smoke_pair()
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S),
                                               dtype=np.int32)
    cache, logits = engine.prefill(cfg, params, _t(tokens))
    jcache, jlogits = jengine.prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(tokens)})
    assert logits.shape == (2, cfg.vocab_padded)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, 1e-5)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        _close(cache[key], jcache[key], 1e-5)
    assert int(cache["len"]) == int(jcache["len"]) == S


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("S", [9, 32])
def test_moe_prefill_logits_and_cache_match_reference(S, dropless,
                                                     monkeypatch):
    """The moe family: dense layer 0, then MoE blocks routed as one
    dropless group (serving) or in groups of 64 with capacity drops (the
    reference's training routing); 2 x 32 tokens make one group of 64
    that drops pairs."""
    jcfg, jparams, cfg, params = smoke_pair(
        arch=MOE, moe_dropless_prefill=dropless)
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S),
                                               dtype=np.int32)
    kept = []
    slots = moe.slots

    def recorded(*a):
        out = slots(*a)
        kept.append(bool(out[1].all()))
        return out
    monkeypatch.setattr(moe, "slots", recorded)
    cache, logits = engine.prefill(cfg, params, _t(tokens))
    assert len(kept) == cfg.n_layers - 1
    if dropless:
        assert all(kept)
    elif S == 32:
        assert not all(kept)
    jcache, jlogits = jengine.prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, 1e-5)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        assert cache[key].shape[0] == cfg.n_layers
        _close(cache[key], jcache[key], 1e-5)


def _check_converted(arch):
    jcfg, jparams, cfg, params = smoke_pair("bfloat16", arch)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(jax.tree.leaves(
        {k: v for k, v in params.items()}))
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(leaf).view(np.int16))
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    jf32 = dataclasses.replace(jcfg, param_dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    p32 = lm_params_from_jax(jax.tree.map(np.asarray, jp32), f32, "cpu")
    tokens = np.arange(10, dtype=np.int32)[None] * 7 % cfg.vocab
    _, logits = engine.prefill(f32, p32, _t(tokens))
    _, jlogits = jengine.prefill(jf32, jp32, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, 1e-5)


def test_converted_params_give_reference_prefill_logits():
    """lm_params_from_jax keeps every name, shape and value (bfloat16 bit
    for bit), and the converted tree reproduces the reference's logits."""
    _check_converted(ARCH)


def test_moe_converted_params_give_reference_prefill_logits():
    """The same for the moe family's tree: ``dense0`` and every block's
    ``moe`` weights carried across."""
    _check_converted(MOE)


def test_init_is_seeded_and_shaped_like_reference():
    cfg = configs.smoke_config(ARCH)
    a = lm.init(cfg, torch.Generator().manual_seed(3))
    b = lm.init(cfg, torch.Generator().manual_seed(3))
    jparams, _ = jlm.init(None, jconfigs.smoke_config(ARCH), abstract=True)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        ta, tb = a, b
        for p in path:
            ta, tb = ta[p.key], tb[p.key]
        assert tuple(ta.shape) == leaf.shape and ta.dtype == torch.bfloat16
        assert torch.equal(ta, tb)
    assert float(a["blocks"]["attn"]["wq"].float().abs().max()) <= \
        2 / np.sqrt(cfg.d_model) + 1e-3
