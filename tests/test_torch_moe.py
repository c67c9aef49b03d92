"""The port's MoE FFN (``nn/moe.py``) against the reference's
``repro.nn.moe`` on the same inputs (numpy, seeded): capacity over a grid,
the router (top-k experts equal, ties to the lower expert as ``lax.top_k``,
weights and aux within 1e-6), each pair's slot and drop as the reference's
dispatch counts them, ``moe_ffn`` through both dispatches with drops,
dropless and shared experts (float32 within 1e-5, one bfloat16 case), the
per-lane decode routing, and the moe family's smoke configs end to end
(moonshot-v1-16b-a3b: prefill and decode against the reference)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.nn import moe as jmoe
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.serve import engine

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

D, E, F, K = 32, 8, 24, 2


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _params(rng, n_shared=0, dtype=np.float32):
    p = {"w_router": rng.normal(0, 0.3, (D, E)),
         "w_gate": rng.normal(0, 0.2, (E, D, F)),
         "w_in": rng.normal(0, 0.2, (E, D, F)),
         "w_out": rng.normal(0, 0.2, (E, F, D))}
    if n_shared:
        sf = n_shared * F
        p.update(shared_gate=rng.normal(0, 0.2, (D, sf)),
                 shared_in=rng.normal(0, 0.2, (D, sf)),
                 shared_out=rng.normal(0, 0.2, (sf, D)))
    return {k: v.astype(dtype) for k, v in p.items()}


def _cfgs(**kw):
    return moe.MoEConfig(E, K, F, **kw), jmoe.MoEConfig(E, K, F, **kw)


def _reference_slots(top_e, C):
    """The reference's dispatch order, counted by hand: a pair's slot is the
    number of earlier pairs of its group (token-major, then k) routed to its
    expert; it is dropped at C or beyond."""
    pos = np.zeros(top_e.shape, np.int64)
    for g in range(top_e.shape[0]):
        seen = {}
        for t in range(top_e.shape[1]):
            for i in range(top_e.shape[2]):
                e = int(top_e[g, t, i])
                pos[g, t, i] = seen.get(e, 0)
                seen[e] = pos[g, t, i] + 1
    return pos, pos < C


@pytest.mark.parametrize("n_experts,top_k", [(8, 2), (64, 6)])
@pytest.mark.parametrize("dropless", [False, True])
def test_capacity_matches_reference(n_experts, top_k, dropless):
    for T in (1, 2, 3, 7, 16, 64, 100, 1000, 2048):
        for cf in (0.5, 1.0, 1.25, 2.0):
            kw = dict(capacity_factor=cf, dropless=dropless)
            got = moe.capacity(moe.MoEConfig(n_experts, top_k, 8, **kw), T)
            want = jmoe.capacity(jmoe.MoEConfig(n_experts, top_k, 8, **kw), T)
            assert got == want, (T, cf)
            # dropless: the group rounded up to 4, which may be < top_k
            # and still drop nothing (a token's k experts are distinct)
            assert got >= (min(T, 4) if dropless else top_k)
            assert got % 4 == 0 or got == top_k


@pytest.mark.parametrize("seed,shape", [(0, (1, 16)), (1, (3, 40))])
def test_router_matches_reference(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape + (D,)).astype(np.float32)
    w = rng.normal(0, 0.3, (D, E)).astype(np.float32)
    cfg, jcfg = _cfgs()
    top_w, top_e, aux = moe.router(_t(x), _t(w), cfg)
    jw, je, jaux = jmoe.router(jnp.asarray(x), jnp.asarray(w), jcfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    _close(top_w, jw, 1e-6)
    _close(aux, jaux, 1e-6)
    assert top_w.dtype == torch.float32


def test_router_ties_go_to_the_lower_expert():
    """Experts 1, 4 and 6 have the same router column and every product is
    exact, so every token's probabilities tie exactly among them, ahead of
    the rest: the top k keeps the lower experts first, as ``lax.top_k``
    does."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, (2, 12, D)).astype(np.float32)
    w = (rng.integers(-2, 2, (D, E)) * 0.125).astype(np.float32)
    w[:, [1, 4, 6]] = 0.5
    for k in (2, 3):
        cfg, jcfg = moe.MoEConfig(E, k, F), jmoe.MoEConfig(E, k, F)
        top_w, top_e, _ = moe.router(_t(x), _t(w), cfg)
        jw, je, _ = jmoe.router(jnp.asarray(x), jnp.asarray(w), jcfg)
        np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
        _close(top_w, jw, 1e-6)
        assert (top_e.numpy() == [1, 4, 6][:k]).all()


@pytest.mark.parametrize("dropless", [False, True])
def test_slots_and_drops_match_the_reference_dispatch(dropless):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 32, D)).astype(np.float32)
    w = rng.normal(0, 0.5, (D, E)).astype(np.float32)
    cfg, jcfg = _cfgs(capacity_factor=0.5, dropless=dropless)
    _, je, _ = jmoe.router(jnp.asarray(x), jnp.asarray(w), jcfg)
    je = np.asarray(je)
    C = moe.capacity(cfg, x.shape[1])
    pos, kept = moe.slots(_t(je).long(), E, C)
    want_pos, want_kept = _reference_slots(je, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    assert kept.all() if dropless else not kept.all()


CASES = {   # (B, S), group_size, capacity_factor, dropless, n_shared
    "drops_4_groups": ((2, 32), 16, 0.5, False, 0),
    "drops_shared": ((2, 32), 16, 0.5, False, 2),
    "one_group": ((1, 48), 2048, 1.25, False, 1),
    "dropless": ((2, 24), 48, 1.25, True, 0),
    "dropless_shared": ((2, 24), 48, 0.5, True, 1),
}


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case, impl):
    shape, gs, cf, dropless, n_shared = CASES[case]
    rng = np.random.default_rng(len(case))
    p = _params(rng, n_shared)
    x = rng.normal(0, 1, shape + (D,)).astype(np.float32)
    cfg, jcfg = _cfgs(n_shared=n_shared, capacity_factor=cf, group_size=gs,
                      impl=impl, dropless=dropless)
    out, aux = moe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    assert out.shape == x.shape and out.dtype == torch.float32
    _close(out, jout, 1e-5)
    _close(aux, jaux, 1e-5)
    # the case drops what its name says
    G = x.shape[0] * x.shape[1] // min(gs, x.shape[0] * x.shape[1])
    _, top_e, _ = moe.router(_t(x).reshape(G, -1, D), _t(p["w_router"]), cfg)
    _, kept = moe.slots(top_e, E, moe.capacity(cfg, top_e.shape[1]))
    assert bool(kept.all()) == (not case.startswith("drops"))


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_ffn_bf16_matches_reference(impl):
    """bfloat16 weights and activations, with drops and a shared expert:
    within 1e-2 relative (about one bfloat16 rounding of the output; on
    the CPU the two agree bit for bit)."""
    rng = np.random.default_rng(5)
    p = _params(rng, 1)
    x = rng.normal(0, 1, (2, 32, D)).astype(np.float32)
    cfg, jcfg = _cfgs(n_shared=1, capacity_factor=0.5, group_size=16,
                      impl=impl)
    out, _ = moe.moe_ffn(_t(x).bfloat16(),
                         {k: _t(v).bfloat16() for k, v in p.items()}, cfg)
    jout, _ = jmoe.moe_ffn(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}, jcfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_group_that_does_not_divide_the_tokens_raises():
    rng = np.random.default_rng(6)
    p = {k: _t(v) for k, v in _params(rng).items()}
    cfg, _ = _cfgs(group_size=16)
    with pytest.raises(ValueError, match="must divide"):
        moe.moe_ffn(torch.zeros(1, 24, D), p, cfg)
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_ffn(torch.zeros(1, 16, D), p,
                    dataclasses.replace(cfg, impl="scatter"))


@pytest.fixture(scope="module")
def moe_smoke():
    jcfg = dataclasses.replace(jconfigs.smoke_config("deepseek_moe_16b"),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config("deepseek_moe_16b"),
                              param_dtype="float32")
    jparams, _ = jlm.init(jax.random.key(0), jcfg, {})
    return jcfg, jparams, cfg, lm_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def test_moe_ffn_decode_routes_each_lane_alone(moe_smoke):
    """Each lane of a decode tick is its own dispatch group of one token:
    the reference's ticks vmap ``moe_ffn_decode`` over B=1 lanes.  A lane's
    output equals the reference's per-lane output and does not change
    with the other lanes."""
    jcfg, jparams, cfg, params = moe_smoke
    rng = np.random.default_rng(7)
    z = rng.normal(0, 1, (5, 1, cfg.d_model)).astype(np.float32)
    mp = lm.layer_params(params["blocks"], 1)["moe"]
    jmp = jax.tree.map(lambda a: a[1], jparams["blocks"]["moe"])
    got = lm.moe_ffn_decode(cfg, mp, _t(z))
    want = jax.vmap(lambda zi: jlm.moe_ffn_decode(
        jcfg, jmp, zi[None])[0][0])(jnp.asarray(z))
    assert got.shape == z.shape
    _close(got, want, 1e-5)
    alone = lm.moe_ffn_decode(cfg, mp, _t(z[2:3]))
    _close(got[2:3], alone, 1e-6)
    assert moe.capacity(dataclasses.replace(cfg.moe, group_size=1), 1) == \
        cfg.top_k


def test_moe_params_are_shaped_like_reference(moe_smoke):
    jcfg, jparams, cfg, params = moe_smoke
    rand = lm.init(dataclasses.replace(cfg, param_dtype="bfloat16"),
                   torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n = 0
    for path, leaf in flat:
        t, r = params, rand
        for p in path:
            t, r = t[p.key], r[p.key]
        assert tuple(t.shape) == tuple(r.shape) == leaf.shape
        n += 1
    assert n == sum(1 for _ in jax.tree.leaves(params))
    assert params["dense0"]["mlp"]["w_gate"].shape == \
        (1, cfg.d_model, cfg.first_dense_ff)
    assert params["blocks"]["moe"]["w_gate"].shape == \
        (cfg.n_layers - 1, cfg.n_experts, cfg.d_model, cfg.d_expert)
    e = rand["blocks"]["moe"]["w_in"].float()
    assert float(e.abs().max()) <= 2 / np.sqrt(cfg.d_model) + 1e-3
    assert float(e[0].std()) > 0 and not torch.equal(e[0], e[1])


@pytest.mark.parametrize("fn", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "moonshot-v1-16b-a3b"])
def test_configs_match_reference(arch, fn):
    cfg = getattr(configs, fn)(arch)
    jcfg = getattr(jconfigs, fn)(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.moe == moe.MoEConfig(**dataclasses.asdict(jcfg.moe))
    assert cfg.family == "moe" and cfg.dtype == torch.bfloat16


def test_moonshot_smoke_prefill_and_decode_match_reference():
    arch = "moonshot_v1_16b_a3b"
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32")
    jparams, _ = jlm.init(jax.random.key(1), jcfg, {})
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jprefill = jax.jit(jengine.prefill, static_argnums=0)
    jdecode = jax.jit(jengine.decode_step, static_argnums=0)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (1, 11),
                                               dtype=np.int32)
    cache, logits = engine.prefill(cfg, params, _t(tokens))
    jcache, jlogits = jprefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, 1e-5)
    for key in ("k", "v"):
        assert cache[key].shape[0] == cfg.n_layers
        _close(cache[key], jcache[key], 1e-5)
    # three ticks against the reference's decode_step on a padded cache
    pad = 4
    dense = {"len": torch.tensor([11], dtype=torch.int32)}
    jdense = {"len": jnp.int32(11)}
    for key in ("k", "v"):
        dense[key] = torch.nn.functional.pad(cache[key],
                                             (0, 0, 0, 0, 0, pad))
        jdense[key] = jnp.pad(jcache[key],
                              ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
    tok = np.asarray(jlogits).argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        dense, got = engine.decode_step(cfg, params, dense, _t(tok))
        jdense, want = jdecode(jcfg, jparams, jdense, jnp.asarray(tok))
        _close(got, want, 2e-4)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
