"""The SC LM frontend (``first_layer_mode="sc"``) against the reference's,
stablelm-3b smoke size (4 layers, d_model 160) in float32 with the
reference's weights: ``lm.sc_frontend`` ternary x gamma and within 1e-6 of
``repro.models.lm.sc_frontend``, its root counts at bits 4 bit for bit the
reference's ``counts_via_table``, an ``sc`` prefill through the dense and
paged adapters (one-shot and chunked) against the reference's, the decode
ticks embedding their token without the frontend as the reference's do,
and the straight-through gradient reaching ``w``
(``tests/test_sc_frontend.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import sc_layer as jsc
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve.gateway import slots as jslots
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import sc_layer
from repro_torch.models import lm
from repro_torch.serve import engine
from repro_torch.serve.gateway import slots

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

ARCH = "stablelm_3b"
BS = 4


def sc_pair(seed=1):
    """(reference cfg, reference params, port cfg, port params) with
    ``first_layer_mode="sc"`` at bits 4 and the reference's weights."""
    kw = dict(param_dtype="float32", first_layer_mode="sc", sc_bits=4)
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), **kw)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), **kw)
    jparams, _ = jlm.init(jax.random.key(seed), jcfg, {})
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    return sc_pair()


def _x(cfg, seed=0, S=8):
    return np.random.default_rng(seed).normal(0, 1, (1, S, cfg.d_model)
                                              ).astype(np.float32)


def test_sc_frontend_matches_reference(pair):
    """Ternary x gamma (``tests/test_sc_frontend.py``'s check) and within
    1e-6 of the reference, whose straight-through sum rounds the same
    way."""
    jcfg, jparams, cfg, params = pair
    x = _x(cfg)
    got = lm.sc_frontend(cfg, params["sc_frontend"], torch.from_numpy(x))
    want = np.asarray(jlm.sc_frontend(jcfg, jparams["sc_frontend"],
                                      jnp.asarray(x)))
    gamma = params["sc_frontend"]["gamma"].numpy()
    vals = np.unique(np.round(got.numpy() / gamma, 5))
    assert set(vals) <= {-1.0, 0.0, 1.0} and len(vals) > 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sc_frontend_counts_bitwise_vs_table(pair):
    """The frontend's levels and root counts at bits 4: the port's kernel
    route (``sc_layer.bank_counts``, ``sng_pack`` then ``sc_dot_posneg``
    over both banks) bit for bit the reference's ``counts_via_table``, and
    the sign bit for bit its ``sc_dot_sign``."""
    jcfg, jparams, cfg, params = pair
    x = _x(cfg, seed=1, S=12)[0]
    lo, hi = x.min(-1, keepdims=True), x.max(-1, keepdims=True)
    x01 = (x - lo) / np.maximum(hi - lo, np.float32(1e-6))
    w = np.array(jparams["sc_frontend"]["w"])
    jcfg_sc = jsc.SCConfig(bits=4)
    x_lvl = jsc.quantize_levels(jnp.asarray(x01), 4)
    pos, neg, _ = jsc.quantize_weights(jnp.asarray(w), 4)
    t_lvl = sc_layer.quantize_levels(torch.from_numpy(x01), 4)
    banks, _ = sc_layer.weight_bank_levels(torch.from_numpy(w), 4)
    np.testing.assert_array_equal(t_lvl.numpy(), np.asarray(x_lvl))
    c_pos, c_neg = sc_layer.bank_counts(t_lvl, banks, sc_layer.SCConfig())
    np.testing.assert_array_equal(
        c_pos.numpy(), np.asarray(jsc.counts_via_table(x_lvl, pos, jcfg_sc)))
    np.testing.assert_array_equal(
        c_neg.numpy(), np.asarray(jsc.counts_via_table(x_lvl, neg, jcfg_sc)))
    np.testing.assert_array_equal(
        sc_layer.sc_dot_sign(torch.from_numpy(x01), torch.from_numpy(w),
                             sc_layer.SCConfig()).numpy(),
        np.asarray(jsc.sc_dot_sign(jnp.asarray(x01), jnp.asarray(w),
                                   jcfg_sc)))


def test_sc_frontend_gradient_reaches_w(pair):
    """The straight-through estimator: the forward is the SC output, the
    gradient of ``w`` and ``gamma`` the linear surrogate's, finite and not
    zero."""
    _, _, cfg, params = pair
    p = {k: v.clone().requires_grad_(True)
         for k, v in params["sc_frontend"].items()}
    x = torch.from_numpy(_x(cfg, seed=2))
    out = lm.sc_frontend(cfg, p, x)
    out.square().sum().backward()
    for name in ("w", "gamma"):
        g = p[name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    assert torch.equal(out.detach(),
                       lm.sc_frontend(cfg, params["sc_frontend"], x))


def test_sc_prefill_matches_reference(pair):
    """``engine.prefill`` under ``sc`` (its embedding runs the frontend)
    against the reference's: logits within 2e-4 with the same greedy
    token, K/V within 1e-5."""
    jcfg, jparams, cfg, params = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 11)
                                             ).astype(np.int32)
    cache, logits = engine.prefill(cfg, params, torch.from_numpy(toks))
    jcache, jlogits = jengine.prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    assert int(logits.argmax()) == int(np.asarray(jlogits).argmax())
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)


def _adapters(pair, kind):
    jcfg, jparams, cfg, params = pair
    if kind == "dense":
        return (jslots.make_adapter(jcfg, jparams, n_slots=2, max_len=24),
                slots.make_adapter(cfg, params, n_slots=2, max_len=24))
    chunked = kind == "chunked"
    return (jslots.make_adapter(jcfg, jparams, n_slots=2, max_len=24,
                                paged=True, block_size=BS, chunked=chunked,
                                backend="xla"),
            slots.make_adapter(cfg, params, n_slots=2, max_len=24,
                               paged=True, block_size=BS, chunked=chunked,
                               backend="plain"))


@pytest.mark.parametrize("kind", ["dense", "oneshot", "chunked"])
def test_sc_adapters_match_reference(pair, kind):
    """An ``sc`` prompt admitted through the dense adapter, the one-shot
    paged adapter and the chunked fold (every chunk through the frontend),
    then decode ticks: first tokens and tokens equal, logits within 2e-4."""
    ref, port = _adapters(pair, kind)
    vocab = port.cfg.vocab
    rng = np.random.default_rng(4)
    for slot, n in ((0, 7), (1, 10)):
        p = rng.integers(0, vocab, n).astype(np.int32)
        kw = {} if kind == "dense" else {"max_new": 6}
        assert port.insert(slot, p, **kw) == ref.insert(slot, p, **kw)
    active = np.ones(2, bool)
    for _ in range(4):
        forced = rng.integers(0, vocab, 2).astype(np.int32)
        np.testing.assert_array_equal(port.decode(forced, active),
                                      np.asarray(ref.decode(forced, active)))
        np.testing.assert_allclose(port.last_logits.numpy(),
                                   np.asarray(ref.last_logits), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kind", ["dense", "oneshot"])
def test_sc_ticks_skip_the_frontend(pair, kind, monkeypatch):
    """The reference's ticks embed their token without the SC frontend
    (``engine.decode_step`` and ``decode_step_paged`` index
    ``params["embed"]``): the port's ticks never call it, and give the
    bits of the same ticks with ``first_layer_mode="none"`` on the same
    weights and caches."""
    _, port = _adapters(pair, kind)
    cfg = port.cfg
    rng = np.random.default_rng(5)
    for slot, n in ((0, 6), (1, 9)):
        p = rng.integers(0, cfg.vocab, n).astype(np.int32)
        port.insert(slot, p, **({} if kind == "dense" else {"max_new": 6}))
    step, inputs, _ = port._tick_inputs(
        rng.integers(0, cfg.vocab, 2).astype(np.int32), np.ones(2, bool))
    state = port.cache if kind == "dense" else port.arena
    start = {k: v.clone() for k, v in state.items()}

    def refuse(*a, **k):
        raise AssertionError("a decode tick ran the SC frontend")
    monkeypatch.setattr(lm, "sc_frontend", refuse)
    got = step.fn(*step.load(*inputs)).clone()
    for k, v in state.items():
        v.copy_(start[k])
    plain_cfg = dataclasses.replace(cfg, first_layer_mode="none")
    arrays = step.load(*inputs)
    if kind == "dense":
        want = engine.decode_step(plain_cfg, port.params, state,
                                  arrays[0], arrays[1])[1]
    else:
        want = engine.decode_step_paged(
            plain_cfg, port.params, arrays[0], tables=arrays[1],
            lens=arrays[2], arena=state, wbids=arrays[3], backend="plain")
    assert torch.equal(got, want)
