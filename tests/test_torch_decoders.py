"""The last three decoder configs of the reference: starcoder2-15b (GELU MLP
with biases, LayerNorm, RoPE at base 1e5, GQA 3:1 at its smoke size, 12:1
at its published one), deepseek-67b and llama3-405b (llama-style, GQA 4:1
at their smoke sizes, 8:1 and 16:1 published).  Their configs field for
field, the parameter conversion bit for bit (starcoder2's biases and
LayerNorm shifts drawn at random on the reference's side, so they reach
the logits), and the one-shot prefill and three dense ticks of each smoke
config against the reference (float32, logits within 2e-4, the cache
within 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.serve import engine
from test_torch_lm import smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

DECODERS = ("starcoder2_15b", "deepseek_67b", "llama3_405b")
PUBLISHED = {"starcoder2-15b": "starcoder2_15b",
             "deepseek-67b": "deepseek_67b", "llama3-405b": "llama3_405b"}
# the leaves that start at 0 (biases, LayerNorm shifts) in both packages'
# initialization, drawn at random here so a dropped one shows
SHIFTS = ("bq", "bv", "bo", "b_in", "b_out", "bias")


@pytest.mark.parametrize("arch_fn", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", DECODERS)
def test_config_matches_reference(arch, arch_fn):
    cfg = getattr(configs, arch_fn)(arch)
    jcfg = getattr(jconfigs, arch_fn)(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert cfg.family == "decoder" and cfg.dtype == torch.bfloat16


def test_published_aliases():
    for alias, mod in PUBLISHED.items():
        assert configs.config(alias) == configs.config(mod)
        assert configs.config(alias).name == alias
    geometry = {arch: (configs.config(arch).n_heads
                       // configs.config(arch).n_kv_heads,
                       configs.config(arch).d_head) for arch in DECODERS}
    assert geometry == {"starcoder2_15b": (12, 128), "deepseek_67b": (8, 128),
                        "llama3_405b": (16, 128)}


def _shifted(arch):
    """:func:`smoke_pair` with every bias and LayerNorm shift of the
    reference's tree drawn from a seeded normal (scale 0.1), and the port's
    parameters converted from that tree."""
    jcfg, jparams, cfg, _ = smoke_pair(arch=arch)
    rng = np.random.default_rng(7)

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else
                (jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
                 if k in SHIFTS else v) for k, v in p.items()}
    jparams = walk(jparams)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=DECODERS)
def shifted(request):
    return _shifted(request.param)


def test_conversion_round_trip(shifted):
    """Every leaf of the reference's tree reaches the port under its name,
    bit for bit (starcoder2: the attention's bq / bv / bo, the MLP's b_in /
    b_out and the LayerNorms' bias among them)."""
    jcfg, jparams, cfg, params = shifted
    flat = {}

    def walk(p, path=""):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[path + k] = np.asarray(v)
    walk(jparams)
    got = {}

    def twalk(p, path=""):
        for k, v in p.items():
            if isinstance(v, dict):
                twalk(v, f"{path}{k}.")
            else:
                got[path + k] = v.numpy()
    twalk(params)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if cfg.use_bias:
        assert {"blocks.attn.bq", "blocks.attn.bv", "blocks.attn.bo",
                "blocks.mlp.b_in", "blocks.mlp.b_out", "blocks.ln1.bias",
                "final_norm.bias"} <= set(got)


def test_prefill_and_ticks_match_reference(shifted):
    """A 13-token prompt one-shot, then three dense ticks of its own greedy
    tokens: logits within 2e-4 at every step, the K/V cache within 1e-5
    after the prompt and after the ticks."""
    jcfg, jparams, cfg, params = shifted
    rng = np.random.default_rng(3)
    P, n = 13, 3
    toks = rng.integers(0, cfg.vocab, (1, P)).astype(np.int32)
    jcache, jl = jengine.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    cache, logits = engine.prefill(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)
    jcache = dict(jcache)
    for key in ("k", "v"):
        jcache[key] = jnp.pad(jcache[key], [(0, 0), (0, 0), (0, n), (0, 0),
                                            (0, 0)])
    dense = engine.init_cache(cfg, 1, P + n, "cpu")
    dense["k"][:, :, :P], dense["v"][:, :, :P] = cache["k"], cache["v"]
    dense["len"] = torch.tensor(P, dtype=torch.int32)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for _ in range(n):
        jcache, jl = jengine.decode_step(jcfg, jparams, jcache,
                                         jnp.asarray(tok))
        dense, logits = engine.decode_step(cfg, params, dense,
                                           torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=2e-4, atol=2e-4)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for key in ("k", "v"):
        np.testing.assert_allclose(dense[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)
    assert int(dense["len"]) == P + n
