"""The port's vlm family (llama-3.2-vision-90b) against the reference at
its smoke size in float32 with the reference's weights
(``convert.lm_params_from_jax``), every cross layer's ``gate_attn`` set to
``VLM_GATE`` = 0.5 on both sides (the reference initializes it to 0,
where the cross path adds nothing a comparison could see), and the
reference tests' patch embeddings (``np.random.default_rng(98)``, (1,
n_vision_tokens, d)): the configs field for field; the parameter tree's
names, shapes, dtypes and the 0 gate fill; ``layers()`` against the
reference's group scan; ``vision_cross`` and ``cross_block`` within 1e-5;
the one-shot prefill (tokens equal, logits within 2e-4, every cache row
within 1e-5 of the reference's grouped row under the index map) and the
fold's refusal; the dense decode step with a length per lane, some lanes
inactive, within 2e-4; a changed vision embedding changing the logits at
a non-zero gate and leaving them bit for bit at gate 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve import engine
from test_torch_lm import VLM, VLM_GATE, vision, vlm_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def grouped(cfg, flat):
    """The port's flat layer-ordered array (L, ...) as the reference's
    grouped pair: (self layers (G, k - 1, ...), cross layers' self (G,
    ...)); layer g k + j is ``[g, j]``, layer g k + k - 1 is ``[g]``."""
    k = cfg.cross_every
    a = np.asarray(flat).reshape((cfg.n_cross, k) + tuple(flat.shape[1:]))
    return a[:, :k - 1], a[:, k - 1]


def flat(self_g, cross_g):
    """The inverse of :func:`grouped`: (L, ...) from the grouped pair."""
    self_g, cross_g = np.asarray(self_g), np.asarray(cross_g)
    return np.concatenate([self_g, cross_g[:, None]], axis=1).reshape(
        (-1,) + self_g.shape[2:])


@pytest.fixture(scope="module")
def pair():
    return vlm_pair()


@pytest.fixture(scope="module")
def vis(pair):
    return vision(pair[2])


PROMPT_LEN = 11


@pytest.fixture(scope="module")
def prefilled(pair, vis):
    """One prompt through both prefills: (tokens, port cache, port logits,
    reference cache, reference logits)."""
    jcfg, jparams, cfg, params = pair
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (1, PROMPT_LEN)).astype(np.int32)
    cache, logits = engine.prefill(cfg, params, _t(toks),
                                   vision_embed=_t(vis))
    jcache, jlogits = jengine.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks),
                        "vision_embed": jnp.asarray(vis)})
    return toks, cache, logits, jcache, jlogits


def _leaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}{k}."))
        else:
            out[path + k] = v
    return out


@pytest.mark.parametrize("arch_fn", ["config", "smoke_config"])
def test_config_matches_reference(arch_fn):
    cfg = getattr(configs, arch_fn)(VLM)
    jcfg = getattr(jconfigs, arch_fn)(VLM)
    assert cfg.family == "vlm" and cfg.cross_every > 1
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert configs.config("llama-3.2-vision-90b") == configs.config(VLM)
    assert cfg.n_cross == cfg.n_layers // cfg.cross_every
    assert cfg.cross_len == cfg.n_vision_tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype):
    """``lm.init``'s tree has the reference's names (in its order), shapes
    and dtypes: ``blocks`` of L - G self layers and ``cross_blocks`` of G
    cross layers with ``ln_x``, ``xattn`` (no biases) and ``gate_attn``
    filled with 0."""
    cfg = dataclasses.replace(configs.smoke_config(VLM), param_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke_config(VLM), param_dtype=dtype)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    jparams, _ = jlm.init(jax.random.key(0), jcfg, {})
    got, want = _leaves(params), _leaves(jparams)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    G = cfg.n_layers // cfg.cross_every
    assert params["blocks"]["attn"]["wq"].shape[0] == cfg.n_layers - G
    assert params["cross_blocks"]["xattn"]["wk"].shape[0] == G
    assert not any(k.endswith((".bq", ".bv", ".bo")) for k in got)
    assert torch.equal(params["cross_blocks"]["gate_attn"],
                       torch.zeros(G, dtype=cfg.dtype))


def test_family_checks(pair):
    """``n_layers`` must be a multiple of ``cross_every`` (the reference
    asserts it); ``prefill`` needs ``vision_embed`` and refuses the encdec
    family's ``enc_embed``; the fold refuses the family; the cross
    projection refuses another family."""
    _, _, cfg, params = pair
    with pytest.raises(ValueError, match="cross_every"):
        lm.init(dataclasses.replace(cfg, n_layers=7),
                torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 3), dtype=torch.int32)
    vis = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model))
    with pytest.raises(ValueError, match="vision_embed"):
        engine.prefill(cfg, params, toks)
    with pytest.raises(ValueError, match="vision_embed"):
        engine.prefill(cfg, params, toks, enc_embed=vis)
    cache = engine.empty_cache(cfg, 1, "cpu")
    cache["xk"], cache["xv"] = engine.vision_cross(cfg, params, vis)
    with pytest.raises(ValueError, match="vlm"):
        engine.prefill_chunked(cfg, params, toks, cache, 0)
    with pytest.raises(ValueError, match="vlm"):
        engine.encode_cross(cfg, params, vis)
    wcfg = configs.smoke_config("whisper_medium")
    with pytest.raises(ValueError, match="vlm"):
        engine.vision_cross(wcfg, {}, vis)


def test_layers_follow_the_reference_group_scan(pair):
    """``lm.layers`` yields group g's k - 1 self blocks (the reference's
    ``blocks`` reshaped to (G, k - 1, ...)) and then ``cross_blocks[g]``,
    the cross block reading cross K/V g and every other block none."""
    jcfg, jparams, cfg, params = pair
    k, G = cfg.cross_every, cfg.n_cross
    self_pp = jax.tree.map(
        lambda a: np.asarray(a).reshape((G, k - 1) + a.shape[1:]),
        jparams["blocks"])
    got = list(lm.layers(cfg, params))
    assert len(got) == cfg.n_layers
    for i, (lp, window, moe_layer, cross) in enumerate(got):
        g, j = divmod(i, k)
        assert window == 0 and not moe_layer
        if j == k - 1:
            assert cross == g
            want = jax.tree.map(lambda a: np.asarray(a)[g],
                                jparams["cross_blocks"])
        else:
            assert cross is None
            want = jax.tree.map(lambda a: a[g, j], self_pp)
        gl, wl = _leaves(lp), _leaves(want)
        assert list(gl) == list(wl), i
        for name in wl:
            assert np.array_equal(gl[name].numpy(), wl[name]), (i, name)


def test_vision_cross_matches_reference(pair, prefilled, vis):
    """Every cross layer's K/V from the patch embeddings, no bias: the
    reference prefill's ``xk`` / ``xv`` (G, B, n_vision_tokens, Hkv, Dh)
    within 1e-5, in the model's dtype."""
    _, _, cfg, params = pair
    jcache = prefilled[3]
    xk, xv = engine.vision_cross(cfg, params, _t(vis))
    assert tuple(xk.shape) == (cfg.n_cross, 1, cfg.n_vision_tokens,
                               cfg.n_kv_heads, cfg.d_head) == \
        jcache["xk"].shape
    assert xk.dtype == xv.dtype == torch.float32
    _close(xk, jcache["xk"])
    _close(xv, jcache["xv"])


@pytest.mark.parametrize("q_offset", [0, 5])
def test_cross_block_matches_reference(pair, q_offset):
    """One vlm cross block at the non-zero gate over random vision K/V,
    cold and resumed from a 5-position prefix: x and the self-attention's
    K/V within 1e-5 (the cross queries take no RoPE)."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(10 + q_offset)
    lp = lm.layer_params(params["cross_blocks"], 1)
    B, S = 2, 6
    H, D = cfg.n_kv_heads, cfg.d_head
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    xk, xv = (rng.normal(0, 1, (B, cfg.n_vision_tokens, H, D)
                         ).astype(np.float32) for _ in range(2))
    pk, pv = (rng.normal(0, 1, (B, q_offset, H, D)).astype(np.float32)
              for _ in range(2))
    pos = np.broadcast_to(np.arange(q_offset, q_offset + S), (B, S)).copy()
    out, (k, v) = lm.cross_block(cfg, lp, _t(x), _t(pos), (_t(xk), _t(xv)),
                                 q_offset=q_offset,
                                 kv_prefix=(_t(pk), _t(pv)))
    jlp = jax.tree.map(lambda a: a[1], jparams["cross_blocks"])
    assert float(jlp["gate_attn"]) == VLM_GATE
    jout, (jk, jv) = jlm.cross_block(
        jcfg, jlp, jnp.asarray(x), jnp.asarray(pos),
        (jnp.asarray(xk), jnp.asarray(xv)), q_offset=q_offset,
        kv_prefix=(jnp.asarray(pk), jnp.asarray(pv)))
    for got, want in ((out, jout), (k, jk), (v, jv)):
        _close(got, want)


def test_prefill_matches_reference(pair, prefilled):
    """The one-shot prefill: tokens equal, logits within 2e-4, and every
    row of the flat cache within 1e-5 of the reference's grouped row
    under the index map (layer g k + j = ``k[g, j]``, layer g k + k - 1 =
    ``kx_self[g]``), the cross K/V too."""
    _, _, cfg, _ = pair
    toks, cache, logits, jcache, jlogits = prefilled
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert int(cache["len"]) == PROMPT_LEN
    for key, xkey in (("k", "kx_self"), ("v", "vx_self")):
        assert tuple(cache[key].shape) == (cfg.n_layers, 1, PROMPT_LEN,
                                           cfg.n_kv_heads, cfg.d_head)
        self_g, cross_g = grouped(cfg, cache[key])
        assert self_g.shape == jcache[key].shape
        assert cross_g.shape == jcache[xkey].shape
        _close(self_g, jcache[key])
        _close(cross_g, jcache[xkey])
        _close(cache[key], flat(jcache[key], jcache[xkey]))
    for key in ("xk", "xv"):
        _close(cache[key], jcache[key])


def test_decode_step_per_lane_matches_reference(pair):
    """Each lane at its own position with its own vision K/V, some
    inactive: the reference vmaps a B=1 step over its grouped cache and
    selects the inactive lanes' old cache; the port's batched step over
    the flat cache writes the active lanes' rows only and never the cross
    K/V.  Logits within 2e-4, tokens equal, rows within 1e-5 under the
    index map, an inactive lane's bit for bit as it was."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(4)
    B, Smax = 4, 20
    lens = np.array([0, 5, 18, 9], np.int32)
    active = np.array([True, False, True, True])
    L, H, D, G = cfg.n_layers, cfg.n_kv_heads, cfg.d_head, cfg.n_cross
    c = {k: rng.normal(0, 1, (L, B, Smax, H, D)).astype(np.float32)
         for k in ("k", "v")}
    c.update({k: rng.normal(0, 1, (G, B, cfg.n_vision_tokens, H, D)
                            ).astype(np.float32) for k in ("xk", "xv")})
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    cache = {"len": _t(lens.copy()), **{k: _t(v.copy())
                                        for k, v in c.items()}}
    _, logits = engine.decode_step(cfg, params, cache, _t(tokens),
                                   _t(active))
    # the reference's per-lane caches: the lane axis first, then B=1 at
    # the grouped layout's batch position
    jc = {"len": jnp.asarray(lens)}
    for key, xkey in (("k", "kx_self"), ("v", "vx_self")):
        self_g, cross_g = grouped(cfg, c[key])   # (G, k-1, B, ...), (G, B,
        jc[key] = jnp.asarray(np.moveaxis(self_g, 2, 0))[:, :, :, None]
        jc[xkey] = jnp.asarray(np.moveaxis(cross_g, 1, 0))[:, :, None]
    for key in ("xk", "xv"):
        jc[key] = jnp.asarray(np.moveaxis(c[key], 1, 0))[:, :, None]
    new, jlogits = jax.vmap(lambda cc, t: jengine.decode_step(
        jcfg, jparams, cc, t))(jc, jnp.asarray(tokens)[:, :, None])
    jlogits = np.asarray(jlogits)[:, 0]
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  jlogits.argmax(-1))
    for key, xkey in (("k", "kx_self"), ("v", "vx_self")):
        got = cache[key].numpy()
        want = flat(np.moveaxis(np.asarray(new[key])[:, :, :, 0], 0, 2),
                    np.moveaxis(np.asarray(new[xkey])[:, :, 0], 0, 1))
        for b in range(B):
            if active[b]:
                _close(got[:, b], want[:, b])
            else:
                np.testing.assert_array_equal(got[:, b], c[key][:, b])
    for key in ("xk", "xv"):
        np.testing.assert_array_equal(cache[key].numpy(), c[key])


def test_vision_embedding_reaches_the_logits(pair, vis):
    """At the non-zero gate a different vision embedding changes the
    prefill's logits and a tick's; at gate 0 (the reference's
    initialization) it leaves them bit for bit as they were."""
    _, _, cfg, params = pair
    toks = _t(np.arange(7, dtype=np.int32)[None] * 3)
    other = _t(vision(cfg, seed=7))
    ungated = dict(params, cross_blocks=dict(
        params["cross_blocks"],
        gate_attn=torch.zeros_like(params["cross_blocks"]["gate_attn"])))
    for p, differ in ((params, True), (ungated, False)):
        outs = []
        for v in (_t(vis), other):
            cache, first = engine.prefill(cfg, p, toks, vision_embed=v)
            dense = engine.init_cache(cfg, 1, 8, "cpu")
            dense["k"][:, :, :7], dense["v"][:, :, :7] = cache["k"], \
                cache["v"]
            dense.update(len=torch.tensor([7], dtype=torch.int32),
                         xk=cache["xk"], xv=cache["xv"])
            _, tick = engine.decode_step(cfg, p, dense,
                                         first.argmax(-1)[:, None])
            outs.append((first, tick))
        (f0, t0), (f1, t1) = outs
        for a, b in ((f0, f1), (t0, t1)):
            if differ:
                assert float((a - b).abs().max()) > 1e-3
            else:
                assert torch.equal(a, b)
