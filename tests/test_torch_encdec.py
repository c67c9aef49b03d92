"""The port's encdec family (whisper-medium) against the reference at its
smoke size in float32 with the reference's weights
(``convert.lm_params_from_jax``) and the reference tests' own frame
embeddings (``np.random.default_rng(99)``, (1, enc_len, d)): the configs
field for field; the parameter tree's names, shapes, dtypes and fills and
the conversion of every leaf; ``gelu_mlp`` and the sinusoidal table (at
offsets 0 and 37) within 1e-6; ``encode_cross``'s cross K/V within 1e-5;
``cross_block`` within 1e-5; the one-shot prefill (tokens equal, logits
within 2e-4) and its refusals; the fold against the reference's and its
bitwise resume at H = 0, 1 and 2 blocks; the dense decode step with a
length per lane, some lanes inactive, within 2e-4; the paged tick through
``"plain"``, ``"cuda"`` and ``"cascade"`` against the reference's
``"xla"`` tick; and one position table for every path (prompt, fold,
tick)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import mlp as jmlp
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm
from repro_torch.nn import attention, mlp
from repro_torch.serve import engine
from repro_torch.serve.gateway import slots
from test_torch_lm import ENCDEC, frames, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(arch=ENCDEC)


@pytest.fixture(scope="module")
def enc(pair):
    return frames(pair[2])


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
    cfg = getattr(configs, arch_fn)(ENCDEC)
    jcfg = getattr(jconfigs, arch_fn)(ENCDEC)
    assert cfg.family == "encdec" and cfg.mlp_type == "gelu"
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert configs.config("whisper-medium") == configs.config(ENCDEC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype):
    """``lm.init``'s tree has the reference's names (in its order), shapes
    and dtypes: ``enc_blocks``, ``enc_norm``, ``dec_blocks`` with
    ``xattn``, ``ln_x`` and ``gate_attn`` (filled with 1), the GELU MLP's
    ``b_in`` / ``b_out``, the attention's ``bq`` / ``bv`` / ``bo`` (no
    ``bk``) and the norms' ``bias``, the biases zero."""
    cfg = dataclasses.replace(configs.smoke_config(ENCDEC),
                              param_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke_config(ENCDEC),
                               param_dtype=dtype)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    jparams, _ = jlm.init(jax.random.key(0), jcfg, {})
    got, want = _leaves(params), _leaves(jparams)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    for name in ("enc_blocks.mlp.b_in", "dec_blocks.mlp.b_out",
                 "dec_blocks.xattn.bq", "dec_blocks.xattn.bv",
                 "dec_blocks.attn.bo", "enc_norm.bias",
                 "dec_blocks.ln_x.bias", "final_norm.bias"):
        assert not got[name].any(), name
    assert "dec_blocks.xattn.bk" not in got
    assert "dec_blocks.mlp.w_gate" not in got
    assert torch.equal(params["dec_blocks"]["gate_attn"],
                       torch.ones(cfg.n_layers, dtype=cfg.dtype))


def test_conversion_carries_every_leaf(pair):
    """``lm_params_from_jax``'s generic walk carries whisper's tree leaf for
    leaf, bit for bit."""
    jcfg, jparams, cfg, params = pair
    conv = _leaves(params)
    want = _leaves(jax.tree.map(np.asarray, jparams))
    assert list(conv) == list(want)
    for k, v in want.items():
        assert np.array_equal(conv[k].numpy(), v), k
    for k in ("enc_blocks.attn.bq", "enc_norm.scale", "enc_norm.bias",
              "dec_blocks.xattn.wk", "dec_blocks.ln_x.bias",
              "dec_blocks.gate_attn", "dec_blocks.mlp.b_in",
              "dec_blocks.mlp.b_out", "dec_blocks.attn.bv",
              "dec_blocks.attn.bo"):
        assert k in conv, k


def test_family_checks(pair):
    """The encdec family needs its encoder and its frames: ``enc_layers``
    0 raises; ``prefill`` refuses a missing ``enc_embed`` and, for another
    family, a given one; the adapters refuse a missing ``extras`` and one
    for another family."""
    _, _, cfg, params = pair
    with pytest.raises(ValueError, match="enc_layers"):
        lm.init(dataclasses.replace(cfg, enc_layers=0),
                torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_embed"):
        engine.prefill(cfg, params, toks)
    _, _, dcfg, dparams = smoke_pair()
    with pytest.raises(ValueError, match="enc_embed"):
        engine.prefill(dcfg, dparams, toks,
                       enc_embed=torch.zeros((1, 4, dcfg.d_model)))
    with pytest.raises(ValueError, match="extras"):
        slots.make_adapter(cfg, params, n_slots=2, max_len=16)
    with pytest.raises(ValueError, match="extras"):
        slots.make_adapter(cfg, params, n_slots=2, max_len=16, paged=True)
    with pytest.raises(ValueError, match="extras"):
        slots.make_adapter(dcfg, dparams, n_slots=2, max_len=16,
                           extras=lambda: {})
    with pytest.raises(ValueError, match="encdec"):
        engine.encode_cross(dcfg, dparams, torch.zeros((1, 4, dcfg.d_model)))


@pytest.mark.parametrize("bias", [True, False])
def test_gelu_mlp_matches_reference(bias):
    """The tanh-approximate GELU (``jax.nn.gelu``'s default) in float32,
    with and without biases, within 1e-6."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    wi = rng.normal(0, 0.3, (32, 64)).astype(np.float32)
    wo = rng.normal(0, 0.3, (64, 32)).astype(np.float32)
    bi = rng.normal(0, 0.3, (64,)).astype(np.float32)
    bo = rng.normal(0, 0.3, (32,)).astype(np.float32)
    got = mlp.gelu_mlp(_t(x), _t(wi), _t(bi) if bias else None, _t(wo),
                       _t(bo) if bias else None)
    want = jmlp.gelu_mlp(jnp.asarray(x), jnp.asarray(wi),
                         jnp.asarray(bi) if bias else 0.0, jnp.asarray(wo),
                         jnp.asarray(bo) if bias else 0.0)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("offset", [0, 37])
def test_sinusoidal_matches_reference(offset):
    got = lm.sinusoidal(torch.arange(offset, offset + 40), 128)
    want = jlm._sinusoidal(40, 128, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (40, 128)
    _close(got, want, 1e-6)


def test_one_table_for_every_path(pair):
    """The prompt's table at ``pos_offset``, a tick's at a lane's position
    and a (lanes, 1) batch of positions give the same bits at the same
    position: in-place = dense = gather rests on it."""
    _, _, cfg, params = pair
    toks = torch.arange(9, dtype=torch.int32)[None] * 5
    x = lm.embed_tokens(cfg, params, toks, pos_offset=37)
    for j in range(9):
        row = lm.embed_tick(cfg, params, toks[:, j:j + 1],
                            torch.tensor([37 + j], dtype=torch.int32))
        assert torch.equal(row[0, 0], x[0, j])


def test_encode_cross_matches_reference(pair, enc):
    """The encoder (non-causal blocks over the frames plus the sinusoidal
    table, then ``enc_norm``) and every decoder layer's cross K / V (V
    with ``bv``) within 1e-5, in the model's dtype."""
    jcfg, jparams, cfg, params = pair
    xk, xv = engine.encode_cross(cfg, params, _t(enc))
    jxk, jxv = jengine.encode_cross(jcfg, jparams, jnp.asarray(enc))
    assert xk.shape == (cfg.n_layers, 1, cfg.enc_len, cfg.n_kv_heads,
                        cfg.d_head) == jxk.shape
    assert xk.dtype == xv.dtype == torch.float32
    _close(xk, jxk)
    _close(xv, jxv)


def _nonzero_biases(params, rng):
    """``params`` with every bias and norm offset random, so that a
    missing or misplaced one shows."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _nonzero_biases(v, rng)
        elif k in ("bq", "bv", "bo", "b_in", "b_out", "bias"):
            out[k] = _t(rng.normal(0, 0.2, tuple(v.shape)).astype(np.float32))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("q_offset", [0, 5])
def test_cross_block_matches_reference(pair, q_offset):
    """One decoder block with random biases, a random gate and random
    cross K/V, from a cold start and resumed from a 5-position prefix:
    x and the self-attention's K/V within 1e-5."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(q_offset)
    lp = _nonzero_biases(lm.layer_params(params["dec_blocks"], 1), rng)
    lp["gate_attn"] = torch.tensor(0.7)
    B, S = 2, 6
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    xk, xv = (rng.normal(0, 1, (B, cfg.enc_len, cfg.n_kv_heads, cfg.d_head)
                         ).astype(np.float32) for _ in range(2))
    pk, pv = (rng.normal(0, 1, (B, q_offset, cfg.n_kv_heads, cfg.d_head)
                         ).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(q_offset, q_offset + S), (B, S)).copy()
    out, (k, v) = lm.cross_block(cfg, lp, _t(x), _t(pos), (_t(xk), _t(xv)),
                                 q_offset=q_offset,
                                 kv_prefix=(_t(pk), _t(pv)))
    jlp = jax.tree.map(lambda a: jnp.asarray(a.numpy()), lp)
    jout, (jk, jv) = jlm.cross_block(
        jcfg, jlp, jnp.asarray(x), jnp.asarray(pos),
        (jnp.asarray(xk), jnp.asarray(xv)), q_offset=q_offset,
        kv_prefix=(jnp.asarray(pk), jnp.asarray(pv)))
    for got, want in ((out, jout), (k, jk), (v, jv)):
        _close(got, want)


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)
                                                ).astype(np.int32)


@pytest.mark.parametrize("S", [1, 11])
def test_prefill_matches_reference(pair, enc, S):
    """A one-shot prompt: tokens equal, logits within 2e-4, the self K/V
    and the cross K/V within 1e-5."""
    jcfg, jparams, cfg, params = pair
    toks = _prompt(cfg, S)
    cache, logits = engine.prefill(cfg, params, _t(toks), enc_embed=_t(enc))
    jcache, jlogits = jengine.prefill(
        jcfg, jparams, {"tokens": jnp.asarray(toks),
                        "enc_embed": jnp.asarray(enc)})
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert int(cache["len"]) == S
    for key in ("k", "v", "xk", "xv"):
        assert cache[key].shape == jcache[key].shape
        _close(cache[key], jcache[key])


def _fold(cfg, params, prompt, cache, start):
    q, logits = start, None
    while q < prompt.shape[1]:
        c = min(BS, prompt.shape[1] - q)
        cache, logits = engine.prefill_chunked(cfg, params,
                                               _t(prompt[:, q:q + c]),
                                               cache, q)
        q += c
    return cache, logits


def _empty(cfg, params, enc):
    cache = engine.init_cache(cfg, 1, 0, "cpu")
    cache["xk"], cache["xv"] = engine.encode_cross(cfg, params, _t(enc))
    return cache


def test_fold_matches_reference(pair, enc):
    """The fold over an 11-token prompt against the reference's fold (one
    ``encode_cross`` feeding every chunk): logits within 2e-4, K/V within
    1e-5."""
    jcfg, jparams, cfg, params = pair
    toks = _prompt(cfg, 11, seed=3)
    cache, logits = _fold(cfg, params, toks, _empty(cfg, params, enc), 0)
    jxk, jxv = jengine.encode_cross(jcfg, jparams, jnp.asarray(enc))
    L = jcfg.n_layers
    jcache = {"len": jnp.int32(0), "xk": jxk, "xv": jxv,
              "k": jnp.zeros((L, 1, 0, cfg.n_kv_heads, cfg.d_head)),
              "v": jnp.zeros((L, 1, 0, cfg.n_kv_heads, cfg.d_head))}
    q = 0
    while q < 11:
        c = min(BS, 11 - q)
        jcache, jlogits = jengine.prefill_chunked(
            jcfg, jparams, {"tokens": jnp.asarray(toks[:, q:q + c])},
            jcache, q)
        q += c
    _close(logits, jlogits, 2e-4)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])


def test_fold_resume_bitwise(pair, enc):
    """``tests/test_chunked_prefill.py::test_engine_fold_resume_bitwise``:
    resuming at H = 0, 1 and 2 blocks from the cold fold's K/V, with the
    cross K/V of a fresh ``encode_cross``, gives the cold fold's logits
    and K/V bit for bit; the fold agrees with the one-shot prefill within
    1e-4."""
    _, _, cfg, params = pair
    toks = _prompt(cfg, 11, seed=1)
    cold, cold_logits = _fold(cfg, params, toks, _empty(cfg, params, enc), 0)
    for H in (0, 1, 2):
        q0 = H * BS
        warm = {**_empty(cfg, params, enc), "len": torch.tensor(q0),
                "k": cold["k"][:, :, :q0], "v": cold["v"][:, :, :q0]}
        got, logits = _fold(cfg, params, toks, warm, q0)
        assert torch.equal(logits, cold_logits), H
        for key in ("k", "v", "xk", "xv"):
            assert torch.equal(got[key], cold[key]), (H, key)
    _close(cold_logits, engine.prefill(cfg, params, _t(toks),
                                       enc_embed=_t(enc))[1], 1e-4)


def test_decode_step_per_lane_matches_reference(pair):
    """Each lane at its own position with its own cross K/V, some
    inactive: the reference vmaps a B=1 step and selects the inactive
    lanes' old cache; the port's batched step writes the active lanes'
    rows only and never the cross K/V.  Logits within 2e-4, tokens equal,
    rows within 1e-5, an inactive lane's bit for bit as it was."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(4)
    B, Smax = 4, 20
    lens = np.array([0, 5, 18, 9], np.int32)
    active = np.array([True, False, True, True])
    L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    c = {k: rng.normal(0, 1, (L, B, Smax, H, D)).astype(np.float32)
         for k in ("k", "v")}
    c.update({k: rng.normal(0, 1, (L, B, cfg.enc_len, H, D)).astype(
        np.float32) for k in ("xk", "xv")})
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    cache = {"len": _t(lens.copy()), **{k: _t(v.copy())
                                        for k, v in c.items()}}
    _, logits = engine.decode_step(cfg, params, cache, _t(tokens),
                                   _t(active))
    jc = {"len": jnp.asarray(lens),
          **{k: jnp.asarray(np.moveaxis(v, 1, 0))[:, :, None]
             for k, v in c.items()}}
    new, jlogits = jax.vmap(lambda cc, t: jengine.decode_step(
        jcfg, jparams, cc, t))(jc, jnp.asarray(tokens)[:, :, None])
    jlogits = np.asarray(jlogits)[:, 0]
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  jlogits.argmax(-1))
    for key in ("k", "v"):
        got = cache[key].numpy()
        want = np.moveaxis(np.asarray(new[key])[:, :, 0], 0, 1)
        for b in range(B):
            if active[b]:
                _close(got[:, b], want[:, b])
            else:
                np.testing.assert_array_equal(got[:, b], c[key][:, b])
    for key in ("xk", "xv"):
        np.testing.assert_array_equal(cache[key].numpy(), c[key])


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_paged_tick_matches_reference(pair, backend):
    """``engine.decode_step_paged`` with the lanes' cross K/V against the
    reference's ``"xla"`` tick on the same arena: logits within 2e-4,
    tokens equal, the rows written within 1e-5, the cross K/V untouched.
    ``"cascade"`` groups lanes 0 and 1 over their shared first block."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(6)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    nb, S = 6, 3
    num_blocks = S * nb + 1
    arena_np = {k: rng.normal(0, 1, (L, num_blocks, 1, BS, Hkv, D)
                              ).astype(np.float32) for k in ("k", "v")}
    tables = rng.permutation(np.arange(1, num_blocks)).reshape(
        S, nb).astype(np.int32)
    tables[1, 0] = tables[0, 0]
    lens = np.array([5, 20, 9], np.int32)
    st = {k: rng.normal(0, 1, (L, S, cfg.enc_len, Hkv, D)).astype(np.float32)
          for k in ("xk", "xv")}
    tokens = rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32)
    wbids = np.array([tables[0, 1], tables[1, 5], tables[2, 2]], np.int32)
    arena = {k: _t(v.copy()) for k, v in arena_np.items()}
    state = {k: _t(v.copy()) for k, v in st.items()}
    cascade = None
    if backend == "cascade":
        cascade = attention.with_lane_meta(
            {"group_tables": _t(tables[:1, :1].copy()),
             "group_len": _t(np.array([BS], np.int32)),
             "group_lanes": _t(np.array([[0, 1]], np.int32)),
             "group_mask": _t(np.array([[True, True]])),
             "lane_q0": _t(np.array([BS, BS, 0], np.int32)),
             "suffix_tables": _t(np.stack([
                 np.concatenate([tables[0, 1:], [0]]),
                 np.concatenate([tables[1, 1:], [0]]), tables[2]])
                 .astype(np.int32))}, _t(lens + 1))
    logits = engine.decode_step_paged(
        cfg, params, _t(tokens), tables=_t(tables), lens=_t(lens),
        arena=arena, wbids=_t(wbids), backend=backend, cascade=cascade,
        state=state)
    jst = {k: jnp.asarray(np.moveaxis(v, 1, 0))[:, :, None]
           for k, v in st.items()}
    jarena, _, jlogits = jengine.decode_step_paged(
        jcfg, jparams, {"len": jnp.asarray(lens), **jst},
        jnp.asarray(tokens), tables=jnp.asarray(tables),
        lens=jnp.asarray(lens),
        arena={k: jnp.asarray(v) for k, v in arena_np.items()},
        wbids=jnp.asarray(wbids), backend="xla")
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    for key in ("k", "v"):
        _close(arena[key], jarena[key])
    for key in ("xk", "xv"):
        np.testing.assert_array_equal(state[key].numpy(), st[key])
    with pytest.raises(ValueError, match="state"):
        engine.decode_step_paged(cfg, params, _t(tokens), tables=_t(tables),
                                 lens=_t(lens), arena=arena)
