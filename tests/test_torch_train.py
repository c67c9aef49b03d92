"""The training slice against the reference, on the same inputs (numpy,
seeded) and the same weights (``convert.lm_params_from_jax``) in float32:
the token pipeline and the int8 gradient compression bit for bit;
``lm.forward``'s loss within 1e-5 relative and every gradient leaf within
1e-4 of its max |g| of ``jax.value_and_grad(repro.models.lm.forward)`` for
each family's smoke config, with remat off and on (measured: loss within
4.2e-7, gradients within 3.3e-6 of their max); one ``make_train_step``
step at microbatches 1 and 4 and with ``compress_grads`` within the
reference's own ``rtol=2e-3, atol=2e-5`` (``tests/test_dist.py``);
``chunked_xent`` over several chunks with ignored labels; ``optim.apply_``
bit for bit ``optim.apply``."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro.dist import compress as jcompress
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data import tokens
from repro_torch.dist import compress
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train.step import (TrainConfig, make_train_step,
                                    value_and_grad)

from repro import configs as jconfigs
from repro_torch.convert import lm_params_from_jax

from test_torch_lm import VLM_GATE

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

FAMILIES = {"decoder": "stablelm_3b", "moe": "deepseek_moe_16b",
            "hybrid": "hymba_1_5b", "encdec": "whisper_medium",
            "vlm": "llama32_vision_90b", "rwkv": "rwkv6_7b"}
B, S = 2, 32
# the reference's programs are compiled with XLA's cheap optimization
# level: the same operations, fused and rounded as XLA chooses either way
# (the loss moves by ~1e-7 relative), at a third of the compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at the ``FAST`` level."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)


def _pair(fam):
    """(reference cfg, reference params, port cfg, port params) in float32
    for the family's smoke config (:func:`_family`)."""
    return _family(fam)[:4]


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _batch(cfg, seed=5):
    """Tokens and labels (one ignored), plus the family's embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    labels[0, 3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["enc_embed"] = rng.normal(
            0, 1, (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embed"] = rng.normal(
            0, 1, (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


@functools.cache
def _family(fam):
    """(reference cfg, reference params, port cfg, port params, batch,
    reference loss, metrics, gradients by dotted name) in float32 for the
    family's smoke config at 2 layers (the moe family's dense layer 0 and
    one MoE layer, the hybrid family's global layer 0 and a sliding layer
    1) or, for vlm, its 3 (two self layers and the cross layer, every
    ``gate_attn`` at ``VLM_GATE`` on both sides).  The reference's weights
    are drawn by its ``init`` and its loss and gradients taken on them in
    one compiled program, once per family; the weights are carried over."""
    arch = FAMILIES[fam]
    kw = {} if fam == "vlm" else {"n_layers": 2}
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               param_dtype="float32", **kw)
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32", **kw)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def init_and_grad(key, b):
        p = jlm.init(key, jcfg, {})[0]
        if fam == "vlm":
            g = p["cross_blocks"]["gate_attn"]
            p["cross_blocks"]["gate_attn"] = jnp.full_like(g, VLM_GATE)
        return p, jax.value_and_grad(
            lambda p, b: jlm.forward(jcfg, p, b), has_aux=True)(p, b)
    key = jax.random.key(0)
    jparams, ((loss, metrics), grads) = _compiled(
        init_and_grad, key, jbatch)(key, jbatch)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    return (jcfg, jparams, cfg, params, batch, float(loss),
            jax.tree.map(np.asarray, metrics),
            _flat(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_forward_loss_and_grads_match_reference(fam, remat):
    _, _, cfg, params, batch, jloss, jmetrics, jgrads = _family(fam)
    cfg = dataclasses.replace(cfg, remat=remat)
    leaves = _flat(params)
    live = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    loss, metrics = lm.forward(cfg, _unflat(live), {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    np.testing.assert_allclose(float(metrics["aux"]), jmetrics["aux"],
                               rtol=1e-5, atol=1e-7)
    if fam == "moe":
        assert float(metrics["aux"]) > 0
    grads = torch.autograd.grad(loss, list(live.values()))
    assert set(live) == set(jgrads)
    for name, g in zip(live, grads):
        want = jgrads[name]
        assert g.shape == want.shape, name
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), (name, err)


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *path, last = key.split(".")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def test_remat_dots_matches_none():
    """``remat="dots"`` (the matrix products' outputs kept, the rest
    recomputed) gives the gradients of ``"none"`` to float32 rounding."""
    _, _, cfg, params, batch, *_ = _family("decoder")
    out = {}
    for remat in ("none", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        live = {k: v.detach().clone().requires_grad_()
                for k, v in _flat(params).items()}
        loss, _ = lm.forward(c, _unflat(live), {k: torch.from_numpy(v)
                                                for k, v in batch.items()})
        out[remat] = (loss, torch.autograd.grad(loss, list(live.values())))
    assert torch.equal(out["none"][0], out["dots"][0])
    for a, b in zip(out["none"][1], out["dots"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _int8_ties(g: torch.Tensor, chunk: int) -> np.ndarray:
    """Where ``int8_roundtrip`` of ``g`` sits within 1 % of a step of a
    rounding boundary (half way between two int8 codes): there two float32
    computations of the same gradient may round to neighbouring codes."""
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % chunk
    ch = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, chunk)
    scale = ch.abs().amax(1, keepdim=True) / 127.0
    frac = (ch / torch.where(scale > 0, scale, 1.0)).abs() % 1.0
    tie = (frac - 0.5).abs() < 0.01
    return tie.reshape(-1)[:flat.numel()].reshape(g.shape).numpy()


@pytest.mark.parametrize("mb,compress_grads", [(1, False), (4, False),
                                               (1, True)])
def test_train_step_matches_reference(mb, compress_grads):
    """One step on a batch of 4: loss, grad norm and every parameter and
    optimizer leaf after AdamW (float32 parameters and master, the clip
    on, weight decay) within the reference's own tolerance.  With
    ``compress_grads`` a gradient element within 1 % of an int8 rounding
    boundary may round to the neighbouring code on one side only (float32
    sums in another order), and AdamW's first step then moves it by up to
    ``lr`` more or less: such elements (2 of 102,400 here) are held to
    ``1.01 * lr``, at most 1e-4 of the elements, and every other element
    to the reference's tolerance."""
    jcfg, jparams, cfg, params = _pair("decoder")
    big = tokens.batch_at(3, 0, 4, S, cfg.vocab)
    jt = jstep.TrainConfig(microbatches=mb, compress_grads=compress_grads)
    tcfg = TrainConfig(microbatches=mb, compress_grads=compress_grads)
    args = (jparams, jstep.init_opt_state(jparams, jt),
            {k: jnp.asarray(v) for k, v in big.items()})
    jp, jo, jm = _compiled(jstep.make_train_step(jcfg, jt), *args)(*args)
    p = optim.unflatten(params, [t.clone() for t in optim.leaves(params)])
    p, o, m = make_train_step(cfg, tcfg)(
        p, optim.init(p, tcfg.adamw),
        {k: torch.from_numpy(v) for k, v in big.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-3, atol=2e-5)
    assert int(o["step"]) == int(jo["step"]) == 1
    ties = [np.zeros(t.shape, bool) for t in optim.leaves(params)]
    if compress_grads:
        _, _, raw = value_and_grad(cfg, params, {
            k: torch.from_numpy(v) for k, v in big.items()})
        ties = [_int8_ties(g, tcfg.compress_chunk)
                for g in optim.leaves(raw)]
    lr, loose = tcfg.adamw.lr, 0
    for got, want in ((p, jp), (o["m"], jo["m"]), (o["v"], jo["v"]),
                      (o["master"], jo["master"])):
        want = jax.tree.map(np.asarray, want)
        for a, b, tie in zip(optim.leaves(got), jax.tree.leaves(want), ties):
            err = np.abs(a.numpy() - b)
            far = err > 2e-5 + 2e-3 * np.abs(b)
            assert not (far & ~tie).any(), float(err[far & ~tie].max())
            assert (err[far] <= 1.01 * lr).all()
            loose += int(far.sum())
    assert loose <= 1e-4 * sum(t.numel() for t in optim.leaves(params))


def test_chunked_xent_matches_reference():
    """Several loss chunks (``loss_chunk`` 8 < S = 30, the last one short)
    and ignored labels: the mean and the count against the reference's,
    and the gradient of x and of the head."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 30, 24)).astype(np.float32)
    head = rng.normal(0, 0.3, (24, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 30)).astype(np.int32)
    labels[:, ::5] = -1
    jcfg = dataclasses.replace(jlm.LMConfig(), loss_chunk=8)
    cfg = dataclasses.replace(lm.LMConfig(), loss_chunk=8)
    args = (jnp.asarray(x), jnp.asarray(head))
    (jl, jn), jg = _compiled(jax.value_and_grad(
        lambda a, h: jlm.chunked_xent(jcfg, a, h, jnp.asarray(labels)),
        argnums=(0, 1), has_aux=True), *args)(*args)
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    loss, n = lm.chunked_xent(cfg, xt, ht, torch.from_numpy(labels))
    assert float(n) == float(jn) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for g, w in zip(torch.autograd.grad(loss, (xt, ht)), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("start", [0, 5])
def test_token_pipeline_bitwise(start):
    """``batch_at`` and ``TokenPipeline`` (a resumed one included) equal
    the reference's bit for bit."""
    ours = tokens.TokenPipeline(11, 3, 37, 512, start_step=start)
    theirs = jtokens.TokenPipeline(11, 3, 37, 512, start_step=start)
    for _ in range(3):
        a, b = ours.next(), theirs.next()
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            assert np.array_equal(a[key], b[key])
    assert ours.step == theirs.step == start + 3
    resumed = tokens.TokenPipeline(11, 3, 37, 512, start_step=start + 2)
    assert np.array_equal(resumed.next()["tokens"],
                          tokens.batch_at(11, start + 2, 3, 37, 512)["tokens"])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_roundtrip_bitwise(dtype):
    """Chunks of 64 over 1,000 values (the last chunk short, one chunk all
    zeros): the round trip and the error-feedback form equal the
    reference's bit for bit."""
    rng = np.random.default_rng(4)
    g = rng.normal(0, 1, (10, 100)).astype(np.float32)
    g[3, :64] = 0.0
    res = rng.normal(0, 0.01, (10, 100)).astype(np.float32)
    jg = jnp.asarray(g).astype(dtype)
    tg = torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = jcompress.int8_roundtrip(jg, 64)
    got = compress.int8_roundtrip(tg, 64)
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(want.astype(jnp.float32))))
    assert got.dtype == tg.dtype
    jo, jr = jcompress.int8_roundtrip_ef(jg, jnp.asarray(res), 64)
    to, tr = compress.int8_roundtrip_ef(tg, torch.from_numpy(res), 64)
    assert torch.equal(to.float(), torch.from_numpy(
        np.asarray(jo.astype(jnp.float32))))
    assert torch.equal(tr, torch.from_numpy(np.asarray(jr)))


def test_apply_in_place_bitwise_apply():
    """``optim.apply_`` updates in place in slices and gives ``apply``'s
    bits: bf16 parameters with a float32 master, the clip on, weight
    decay, two steps, slices of 1,000 elements."""
    cfg = configs.smoke_config("deepseek_moe_16b")
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = optim.unflatten(params, [
        torch.randn(p.shape, generator=gen).to(p.dtype)
        for p in optim.leaves(params)])
    acfg = optim.AdamWConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0,
                             master_dtype=torch.float32)
    state = optim.init(params, acfg)
    want_p, want_s = optim.apply(params, grads, state, acfg)
    want_p, want_s = optim.apply(want_p, grads, want_s, acfg)
    got_p = optim.unflatten(params, [t.clone()
                                     for t in optim.leaves(params)])
    got_s = copy.deepcopy(state)
    chunk = optim.APPLY_CHUNK
    optim.APPLY_CHUNK = 1000
    try:
        for _ in range(2):
            out = optim.apply_(got_p, grads, got_s, acfg)
            assert out[0] is got_p and out[1] is got_s
    finally:
        optim.APPLY_CHUNK = chunk
    assert all(torch.equal(a, b) for a, b in zip(optim.leaves(got_p),
                                                 optim.leaves(want_p)))
    assert all(torch.equal(a, b) for a, b in zip(optim.leaves(got_s),
                                                 optim.leaves(want_s)))
    assert int(got_s["step"]) == 2
    assert all(p.dtype == torch.bfloat16 for p in optim.leaves(got_p))


def test_param_counts_match_reference():
    for fam, arch in FAMILIES.items():
        assert lm.count_params(configs.config(arch)) == \
            jlm.count_params(jconfigs.config(arch)), fam
        assert lm.active_params(configs.config(arch)) == \
            jlm.active_params(jconfigs.config(arch)), fam
