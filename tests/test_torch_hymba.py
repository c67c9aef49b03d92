"""The port's hybrid family (hymba-1.5b) against the reference at its smoke
size in float32 with the reference's weights (``convert.lm_params_from_jax``):
the configs field for field; the parameter tree's names, shapes and dtypes
and the conversion of the SSM leaves; the windowed prompt attention against
the reference's ``attend_sliding`` within 1e-5;
``hymba_block`` on a global and a sliding layer from a nonzero state
within 1e-5; the one-shot prefill (tokens equal, logits within 2e-4, the
cache and state within 1e-5) and its refusal of a length the reference
refuses; the fold against the reference's and its bitwise resume at H = 0,
1 and 2 blocks, the sliced-window case included; the dense decode step,
a length and a state per lane, some lanes inactive; and the paged tick
with the lanes' state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm
from repro_torch.nn import attention
from repro_torch.serve import engine
from test_torch_lm import smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

HYMBA = "hymba_1_5b"
BS = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pair():
    return smoke_pair(arch=HYMBA)


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
    cfg = getattr(configs, arch_fn)(HYMBA)
    jcfg = getattr(jconfigs, arch_fn)(HYMBA)
    assert cfg.family == "hybrid"
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert cfg.inner == jcfg.inner
    assert configs.config("hymba-1.5b") == configs.config(HYMBA)


def test_layer_windows_match_reference():
    """Layers 0 and 16 of hymba-1.5b are global, the other 30 slide over
    1,024 positions; the smoke config alternates."""
    for fn in ("config", "smoke_config"):
        cfg, jcfg = getattr(configs, fn)(HYMBA), getattr(jconfigs, fn)(HYMBA)
        for i in range(cfg.n_layers):
            assert lm.layer_window(cfg, i) == int(jlm.layer_window(jcfg, i))
    cfg = configs.config(HYMBA)
    glob = [i for i in range(32) if lm.layer_window(cfg, i) != cfg.window]
    assert glob == [0, 16]


def test_param_tree_matches_reference():
    """``lm.init``'s tree has the reference's names (in its order), shapes
    and dtypes, the reference's fills (``dt_bias`` -4.6, ``A_log`` log(1..N)
    on every row, ``D_skip`` and ``beta`` 1), and the reference's weights
    convert leaf for leaf, bit for bit."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.smoke_config(HYMBA),
                                  param_dtype=dtype)
        jcfg = dataclasses.replace(jconfigs.smoke_config(HYMBA),
                                   param_dtype=dtype)
        params = lm.init(cfg, torch.Generator().manual_seed(0))
        jparams, _ = jlm.init(jax.random.key(0), jcfg, {})
        got, want = _leaves(params), _leaves(jparams)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        blocks = params["blocks"]
        N = cfg.ssm_state
        assert torch.equal(blocks["dt_bias"],
                           torch.full_like(blocks["dt_bias"], -4.6))
        assert torch.equal(blocks["A_log"], torch.log(torch.arange(
            1, N + 1, dtype=torch.float32)).to(cfg.dtype).expand(
            cfg.n_layers, cfg.inner, N))
        for k in ("D_skip", "beta"):
            assert torch.equal(blocks[k], torch.ones_like(blocks[k]))
    jcfg, jparams, cfg, params = smoke_pair(arch=HYMBA)
    conv = _leaves(params)
    for k, v in _leaves(jax.tree.map(np.asarray, jparams)).items():
        assert np.array_equal(conv[k].numpy(), v), k
    for k in ("A_log", "dt_bias", "D_skip", "beta", "conv_w"):
        assert f"blocks.{k}" in conv


def test_family_checks():
    cfg = configs.smoke_config(HYMBA)
    with pytest.raises(ValueError, match="ssm_state"):
        lm.init(dataclasses.replace(cfg, ssm_state=0),
                torch.Generator().manual_seed(0))


@pytest.mark.parametrize("S,window,q_chunk", [(40, 16, 512), (37, 5, 8),
                                              (20, 30, 7)])
def test_windowed_prompt_matches_reference_attend_sliding(S, window,
                                                          q_chunk):
    """The one-shot prompt's sliding layers (``attend_chunked`` with the
    window) against the reference's ``attend_sliding``: GQA 2:1, windows
    shorter and longer than the prompt, the reference's query chunks
    dividing the prompt or not."""
    rng = np.random.default_rng(S)
    q = rng.normal(0, 1, (2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = attention.attend_chunked(_t(q), _t(k), _t(v), window=window)
    want = jattn.attend_sliding(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window,
                                q_chunk=q_chunk)
    _close(got, want)


def _state(cfg, rng, B):
    return {"conv": rng.normal(0, 1, (B, cfg.conv_k - 1, cfg.inner)
                               ).astype(np.float32),
            "ssm": rng.normal(0, 1, (B, cfg.inner, cfg.ssm_state)
                              ).astype(np.float32)}


@pytest.mark.parametrize("layer", [0, 1])
def test_hymba_block_matches_reference(pair, layer):
    """A global (0) and a sliding (1) layer from a nonzero state: x, the
    K/V rows and the new state within 1e-5; the input state unwritten."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(layer)
    B, S = 2, 24
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng, B)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    window = lm.layer_window(cfg, layer)
    lp = lm.layer_params(params["blocks"], layer)
    tst = {k: _t(v.copy()) for k, v in st.items()}
    out, (k, v), new = lm.hymba_block(cfg, lp, _t(x), _t(pos), tst,
                                      window=window)
    jlp = jax.tree.map(lambda a: a[layer], jparams["blocks"])
    jout, (jk, jv), jnew = jlm.hymba_block(
        jcfg, jlp, jnp.asarray(x), jnp.asarray(pos),
        {k_: jnp.asarray(v_) for k_, v_ in st.items()},
        window=jcfg.window if window != lm._GLOBAL_WINDOW else 0)
    for got, want in ((out, jout), (k, jk), (v, jv), (new["conv"],
                                                      jnew["conv"]),
                      (new["ssm"], jnew["ssm"])):
        _close(got, want)
    for key in st:
        np.testing.assert_array_equal(tst[key].numpy(), st[key])


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (1, n)
                                                ).astype(np.int32)


def test_prefill_matches_reference(pair):
    """A 32-token prompt (twice the window, so the sliding layers cut):
    tokens equal, logits within 2e-4, K/V and the state within 1e-5."""
    jcfg, jparams, cfg, params = pair
    toks = _prompt(cfg, 32)
    cache, logits = engine.prefill(cfg, params, _t(toks))
    jcache, jlogits = jengine.prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)})
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert int(cache["len"]) == 32
    for key in ("k", "v", "conv", "ssm"):
        assert cache[key].dtype == (torch.float32)
        _close(cache[key], jcache[key])


def test_prefill_refuses_what_the_reference_refuses(pair):
    """A one-shot prompt of S tokens must be a multiple of min(ssm_chunk,
    S) (32 at the smoke size): 40 is refused by both, 20 and 64 taken."""
    jcfg, jparams, cfg, params = pair
    toks = _prompt(cfg, 64)
    with pytest.raises(AssertionError):
        jengine.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :40])})
    with pytest.raises(ValueError, match="S % chunk == 0"):
        engine.prefill(cfg, params, _t(toks[:, :40]))
    for n in (20, 64):
        assert torch.isfinite(engine.prefill(cfg, params,
                                             _t(toks[:, :n]))[1]).all()


def _empty(cfg):
    return engine.init_cache(cfg, 1, 0, "cpu")


def _jempty(cfg):
    L = cfg.n_layers
    return {"len": jnp.int32(0),
            "k": jnp.zeros((L, 1, 0, cfg.n_kv_heads, cfg.d_head)),
            "v": jnp.zeros((L, 1, 0, cfg.n_kv_heads, cfg.d_head)),
            "conv": jnp.zeros((L, 1, cfg.conv_k - 1, cfg.inner)),
            "ssm": jnp.zeros((L, 1, cfg.inner, cfg.ssm_state))}


def _fold(cfg, params, prompt, cache, start):
    q, logits = start, None
    while q < prompt.shape[1]:
        c = min(BS, prompt.shape[1] - q)
        cache, logits = engine.prefill_chunked(cfg, params,
                                               _t(prompt[:, q:q + c]),
                                               cache, q)
        q += c
    return cache, logits


def test_fold_matches_reference(pair):
    """The fold over an 11-token prompt (the sliding layers cut from the
    fourth chunk on) against the reference's fold: logits within 2e-4, K/V
    and the final state within 1e-5."""
    jcfg, jparams, cfg, params = pair
    cfg = dataclasses.replace(cfg, window=6)
    jcfg = dataclasses.replace(jcfg, window=6)
    toks = _prompt(cfg, 11, seed=3)
    cache, logits = _fold(cfg, params, toks, _empty(cfg), 0)
    jcache, q = _jempty(jcfg), 0
    while q < 11:
        c = min(BS, 11 - q)
        jcache, jlogits = jengine.prefill_chunked(
            jcfg, jparams, {"tokens": jnp.asarray(toks[:, q:q + c])},
            jcache, q)
        q += c
    _close(logits, jlogits, 2e-4)
    for key in ("k", "v", "conv", "ssm"):
        _close(cache[key], jcache[key])


@pytest.mark.parametrize("window", [16, 2])
def test_fold_resume_bitwise(pair, window):
    """``tests/test_chunked_prefill.py::test_engine_fold_resume_bitwise``
    and its sliced-window case (window 2 < the prefix): resuming at H = 0,
    1 and 2 blocks from the cold fold's K/V and the boundary state a fold
    of the prefix leaves gives the cold fold's logits, K/V and state bit
    for bit; the fold agrees with the one-shot prefill within 1e-4."""
    _, _, cfg, params = pair
    cfg = dataclasses.replace(cfg, window=window)
    toks = _prompt(cfg, 11, seed=1)
    cold, cold_logits = _fold(cfg, params, toks, _empty(cfg), 0)
    for H in (0, 1, 2):
        q0 = H * BS
        pc, _ = _fold(cfg, params, toks[:, :q0], _empty(cfg), 0)
        warm = {"len": torch.tensor(q0), "k": cold["k"][:, :, :q0],
                "v": cold["v"][:, :, :q0], "conv": pc["conv"],
                "ssm": pc["ssm"]}
        got, logits = _fold(cfg, params, toks, warm, q0)
        assert torch.equal(logits, cold_logits), H
        for key in ("k", "v", "conv", "ssm"):
            assert torch.equal(got[key], cold[key]), (H, key)
    one = dataclasses.replace(cfg, ssm_chunk=11)
    _close(cold_logits, engine.prefill(one, params, _t(toks))[1], 1e-4)


def test_decode_step_per_lane_matches_reference(pair):
    """Each lane at its own position with its own state, some inactive:
    the reference vmaps a B=1 step and selects the inactive lanes' old
    cache; the port's batched step advances the active lanes' rows and
    state only.  Logits within 2e-4, tokens equal, rows and state within
    1e-5, an inactive lane's bit for bit as it was."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(4)
    B, Smax = 4, 20
    lens = np.array([0, 5, 18, 9], np.int32)
    active = np.array([True, False, True, True])
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.d_head)
    c = {k: rng.normal(0, 1, shape).astype(np.float32) for k in ("k", "v")}
    c["conv"] = rng.normal(0, 1, (cfg.n_layers, B, cfg.conv_k - 1,
                                  cfg.inner)).astype(np.float32)
    c["ssm"] = rng.normal(0, 1, (cfg.n_layers, B, cfg.inner,
                                 cfg.ssm_state)).astype(np.float32)
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
    for key in ("k", "v", "conv", "ssm"):
        got = cache[key].numpy()
        want = np.moveaxis(np.asarray(new[key])[:, :, 0], 0, 1)
        for b in range(B):
            if active[b]:
                _close(got[:, b], want[:, b])
            else:
                np.testing.assert_array_equal(got[:, b], c[key][:, b])


@pytest.mark.parametrize("backend", ["plain", "cuda", "cascade"])
def test_paged_tick_matches_reference(pair, backend):
    """``engine.decode_step_paged`` with the lanes' state against the
    reference's ``"xla"`` tick on the same arena and state: logits within
    2e-4, tokens equal, the state within 1e-5 for the lanes that write and
    bit for bit for the one that does not (its write routed to the trash
    block, as the adapter routes an inactive lane).  ``"cascade"`` groups
    lanes 0 and 1 over their shared first block."""
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
    st = {"conv": rng.normal(0, 1, (L, S, cfg.conv_k - 1, cfg.inner)),
          "ssm": rng.normal(0, 1, (L, S, cfg.inner, cfg.ssm_state))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    tokens = rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32)
    wbids = np.array([tables[0, 1], tables[1, 5], 0], np.int32)
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
        state=state, active=_t(wbids != 0))
    jst = {k: jnp.asarray(np.moveaxis(v, 1, 0))[:, :, None]
           for k, v in st.items()}
    _, jnew, jlogits = jengine.decode_step_paged(
        jcfg, jparams, {"len": jnp.asarray(lens), **jst}, jnp.asarray(tokens),
        tables=jnp.asarray(tables), lens=jnp.asarray(lens),
        arena={k: jnp.asarray(v) for k, v in arena_np.items()},
        wbids=jnp.asarray(wbids), backend="xla")
    _close(logits, jlogits, 2e-4)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    for key in ("conv", "ssm"):
        want = np.moveaxis(np.asarray(jnew[key])[:, :, 0], 0, 1)
        _close(state[key][:, :2], want[:, :2])
        np.testing.assert_array_equal(state[key][:, 2].numpy(),
                                      st[key][:, 2])
    with pytest.raises(ValueError, match="state"):
        engine.decode_step_paged(cfg, params, _t(tokens), tables=_t(tables),
                                 lens=_t(lens), arena=arena)
