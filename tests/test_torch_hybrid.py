"""The port's retraining pipeline (``core/hybrid.py``, ``train/optim.py``,
``models/lenet.py``'s training half) against the reference on the CPU, at
``tests/test_system.py``'s small LeNet: one training step of each kind and
AdamW to the reference's tolerances, the straight-through sign, dropout,
the first layer's cached features bit for bit for every design, the
accuracies, and the whole pipeline (float pretraining, caching, retraining)
to the reference test's own thresholds and within a band of the
reference's retrained accuracy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhybrid
from repro.core.sc_layer import SCConfig as JSCConfig
from repro.models import lenet as jlenet
from repro.train import optim as joptim
from repro_torch.convert import lenet_params_from_jax
from repro_torch.core import hybrid
from repro_torch.core.sc_layer import SCConfig
from repro_torch.data import mnist_synth
from repro_torch.models import lenet
from repro_torch.train import optim

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

SMALL = dict(conv1_filters=8, conv2_filters=16, dense=64)
CFG, JCFG = lenet.LeNetConfig(**SMALL), jlenet.LeNetConfig(**SMALL)
# the port's retrained accuracy from the reference's pretrained weights and
# features lies within this of the reference's (0.994), for each seed.
# Measured on the CPU: the port's own spread over seeds 0-9 is 0.004
# (0.988-0.992, 2 of 500 images); the reference's over its seeds 0-4 is
# 0.008 (0.988-0.996).  The band is 2.5 times the port's spread.
BAND = 0.01
# the designs whose features are held bit for bit: (port, reference)
DESIGNS = {
    "sc2": dict(mode="sc", sc=dict(bits=2)),
    "sc4": dict(mode="sc", sc=dict(bits=4)),
    "sc8": dict(mode="sc", sc=dict(bits=8)),
    "binary4": dict(mode="binary", bits=4),
    "old_sc2": dict(mode="sc", sc=dict(bits=2, scheme="lfsr_pair",
                                       adder="mux"), sc_impl="streams"),
    "old_sc4": dict(mode="sc", sc=dict(bits=4, scheme="lfsr_pair",
                                       adder="mux"), sc_impl="streams"),
}


def _hybrids(mode="sc", sc=None, **kw):
    sc = sc or {}
    return (hybrid.HybridConfig(mode=mode, sc=SCConfig(**sc), **kw),
            jhybrid.HybridConfig(mode=mode, sc=JSCConfig(**sc), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jtree):
    return lenet_params_from_jax(_np(jtree), "cpu")


def _port_layer(jlayer):
    return {k: torch.from_numpy(np.array(v)) for k, v in jlayer.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its SC features go
    through the kernels' plain versions on the CPU, whose large integer
    passes slow down tenfold when several test processes each spread them
    over every core."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    return mnist_synth.dataset(2000, 500)


@pytest.fixture(scope="module")
def reference(data):
    """The reference's run of test_system's protocol: initial and pretrained
    weights, SC 4-bit features (1,500 train, 500 test), retrained accuracy."""
    xtr, ytr, xte, yte = data
    init = jlenet.init(jax.random.key(0), JCFG)
    params = init
    opt_cfg = joptim.AdamWConfig(lr=1e-3)
    opt = joptim.init(params, opt_cfg)
    key = jax.random.key(1)
    for xb, yb in mnist_synth.batches(xtr, ytr, 64, 0, 150):
        key, sub = jax.random.split(key)
        params, opt, _ = jhybrid.float_train_step(
            params, opt, jnp.asarray(xb), jnp.asarray(yb), sub, JCFG, opt_cfg)
    _, jh = _hybrids(sc=dict(bits=4))
    ftr = jhybrid.cache_first_layer(params, xtr[:1500], jh)
    fte = jhybrid.cache_first_layer(params, xte, jh)
    retrained = jhybrid.retrain_tail(params, ftr, ytr[:1500], JCFG,
                                     steps=150, batch=64)
    after = jhybrid.evaluate_cached(retrained, fte, yte, JCFG)
    return dict(init=init, params=params, ftr=ftr, fte=fte, after=after)


# -- (d) one training step, and AdamW --------------------------------------

def _close_trees(got, want, tol):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(
                got[layer][k].detach().float().numpy(),
                np.asarray(want[layer][k], np.float32), rtol=0, atol=tol,
                err_msg=f"{layer}.{k}")


def _port_grads(params, loss_of):
    p = {l: {k: v.detach().requires_grad_() for k, v in d.items()}
         for l, d in params.items()}
    loss = loss_of(p)
    leaves = [p[l][k] for l in sorted(p) for k in sorted(p[l])]
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, {l: {k: next(it) for k in sorted(p[l])} for l in sorted(p)}


def _check_grads(got, want):
    for layer in want:
        for k in want[layer]:
            w = np.asarray(want[layer][k])
            np.testing.assert_allclose(
                got[layer][k].numpy(), w, rtol=0,
                atol=1e-5 * np.abs(w).max(), err_msg=f"{layer}.{k}")


def test_float_train_step_matches_reference(data, reference):
    xtr, ytr, _, _ = data
    cfg = dataclasses.replace(CFG, dropout=0.0)
    jcfg = dataclasses.replace(JCFG, dropout=0.0)
    xb, yb = next(mnist_synth.batches(xtr, ytr, 64, 3, 1))
    params, jparams = _port(reference["init"]), reference["init"]

    def jloss(p):
        return jhybrid.loss_fn(jlenet.apply(p, jnp.asarray(xb), jcfg,
                                            mode="float", train=True),
                               jnp.asarray(yb))
    jl, jg = jax.value_and_grad(jloss)(jparams)
    loss, grads = _port_grads(params, lambda p: hybrid.loss_fn(
        lenet.apply(p, torch.from_numpy(xb), cfg, mode="float", train=True),
        torch.from_numpy(yb)))
    assert abs(loss.item() - float(jl)) <= 1e-5
    _check_grads(grads, jg)
    opt_cfg, jopt_cfg = optim.AdamWConfig(), joptim.AdamWConfig()
    _, state, l2 = hybrid.float_train_step(
        params, optim.init(params, opt_cfg), xb, yb, None, cfg, opt_cfg)
    jnew, _, jl2 = jhybrid.float_train_step(
        jparams, joptim.init(jparams, jopt_cfg), jnp.asarray(xb),
        jnp.asarray(yb), jax.random.key(0), jcfg, jopt_cfg)
    assert abs(float(l2) - float(jl2)) <= 1e-5 and int(state["step"]) == 1
    # the reference's step, given its gradients: AdamW within 1e-6
    new, _ = optim.apply(params, _port(jg), optim.init(params, opt_cfg),
                         opt_cfg)
    _close_trees(new, jnew, 1e-6)


def test_tail_train_step_matches_reference(data, reference):
    _, ytr, _, _ = data
    cfg = dataclasses.replace(CFG, dropout=0.0)
    jcfg = dataclasses.replace(JCFG, dropout=0.0)
    h1 = np.asarray(reference["ftr"][:128], np.float32)
    y = ytr[:128]
    jparams = reference["params"]
    params = _port(jparams)
    trainable = ("conv2", "dense1", "dense2")

    def jloss(p):
        return jhybrid.loss_fn(jlenet.tail({**jparams, **p}, jnp.asarray(h1),
                                           jcfg, train=True), jnp.asarray(y))
    jl, jg = jax.value_and_grad(jloss)({k: jparams[k] for k in trainable})
    loss, grads = _port_grads({k: params[k] for k in trainable},
                              lambda p: hybrid.loss_fn(lenet.tail(
                                  {**params, **p}, torch.from_numpy(h1), cfg,
                                  train=True), torch.from_numpy(y)))
    assert abs(loss.item() - float(jl)) <= 1e-5
    _check_grads(grads, jg)
    opt_cfg, jopt_cfg = optim.AdamWConfig(), joptim.AdamWConfig()
    sub = {k: params[k] for k in trainable}
    new, state, l2 = hybrid.tail_train_step(
        params, optim.init(sub, opt_cfg), h1, y, None, cfg, opt_cfg)
    jnew, jstate, jl2 = jhybrid.tail_train_step(
        jparams, joptim.init({k: jparams[k] for k in trainable}, jopt_cfg),
        jnp.asarray(h1), jnp.asarray(y), jax.random.key(0), jcfg, jopt_cfg)
    assert abs(float(l2) - float(jl2)) <= 1e-5
    assert torch.equal(new["conv1"]["w"], params["conv1"]["w"])   # frozen
    assert int(state["step"]) == int(jstate["step"]) == 1
    # the reference's step, given its gradients: AdamW within 1e-6
    got, _ = optim.apply(sub, {k: _port_layer(jg[k]) for k in trainable},
                         optim.init(sub, opt_cfg), opt_cfg)
    _close_trees(got, {k: jnew[k] for k in trainable}, 1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"grad_clip": 0.5}, {"weight_decay": 0.1},
    {"master": True}, {"grad_clip": 0.5, "weight_decay": 0.1,
                       "master": True}], ids=str)
def test_adamw_apply_matches_reference(kw):
    """Three steps on the same gradients: params, m and v within 1e-6
    (and the master copy, for bf16 params under ``master_dtype``)."""
    kw = dict(kw)
    master = kw.pop("master", False)
    rng = np.random.default_rng(len(kw))
    shapes = {"a": {"w": (5, 7), "b": (7,)}, "c": {"w": (3, 2, 4)}}
    p0 = {l: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
          for l, d in shapes.items()}
    cfg = optim.AdamWConfig(lr=1e-2, master_dtype=torch.float32
                            if master else None, **kw)
    jcfg = joptim.AdamWConfig(lr=1e-2, master_dtype=jnp.float32
                              if master else None, **kw)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if master else \
        (torch.float32, jnp.float32)
    params = {l: {k: torch.from_numpy(v).to(dt) for k, v in d.items()}
              for l, d in p0.items()}
    jparams = {l: {k: jnp.asarray(v, jdt) for k, v in d.items()}
               for l, d in p0.items()}
    state, jstate = optim.init(params, cfg), joptim.init(jparams, jcfg)
    for _ in range(3):
        g = {l: {k: rng.normal(size=s).astype(np.float32) * 2
                 for k, s in d.items()} for l, d in shapes.items()}
        params, state = optim.apply(
            params, {l: {k: torch.from_numpy(v).to(dt) for k, v in d.items()}
                     for l, d in g.items()}, state, cfg)
        jparams, jstate = joptim.apply(
            jparams, {l: {k: jnp.asarray(v, jdt) for k, v in d.items()}
                      for l, d in g.items()}, jstate, jcfg)
    for got, want in ((state["m"], jstate["m"]), (state["v"], jstate["v"])):
        _close_trees(got, want, 1e-6)
    if master:
        _close_trees(state["master"], jstate["master"], 1e-6)
        for l in p0:
            for k in p0[l]:
                assert params[l][k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    params[l][k].float().numpy(),
                    np.asarray(jparams[l][k], np.float32))
    else:
        _close_trees(params, jparams, 1e-6)
    assert int(state["step"]) == 3


def test_sgd_matches_reference():
    rng = np.random.default_rng(0)
    p = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}
    g = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}
    got = optim.sgd({"a": {"w": torch.from_numpy(p["a"]["w"])}},
                    {"a": {"w": torch.from_numpy(g["a"]["w"])}}, 0.1)
    want = joptim.sgd(p, g, 0.1)
    np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                  np.asarray(want["a"]["w"]))


# -- (e) the straight-through sign, (f) dropout -----------------------------

def test_ste_sign_forward_and_gradient():
    x = torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0], requires_grad=True)
    y = hybrid.ste_sign.apply(x)
    jx = jnp.asarray(x.detach().numpy())
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jhybrid.ste_sign(jx)))
    (g,) = torch.autograd.grad(y.sum(), x)
    jg = jax.grad(lambda v: jnp.sum(jhybrid.ste_sign(v)))(jx)
    np.testing.assert_array_equal(g.numpy(), [0, 1, 1, 1, 0])
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_dropout():
    """dense = classes and dense2 the identity, so the logits are the
    dropped-out hidden units: kept with probability 1/2 (within 3 sigma),
    kept ones doubled, the same mask for the same seed, none at eval."""
    cfg = lenet.LeNetConfig(conv1_filters=2, conv2_filters=2, dense=10)
    params = lenet.init(0, cfg, device="cpu")
    params["dense1"]["b"] = torch.full((10,), 5.0)       # every unit > 0
    params["dense2"] = {"w": torch.eye(10), "b": torch.zeros(10)}
    h1 = torch.from_numpy(np.random.default_rng(0).random(
        (512, 28, 28, 2)).astype(np.float32))
    h = lenet.tail(params, h1, cfg)
    assert (h > 0).all()
    out = lenet.tail(params, h1, cfg, train=True,
                     generator=torch.Generator().manual_seed(3))
    kept = out != 0
    rate, n = float(kept.float().mean()), kept.numel()
    assert abs(rate - 0.5) <= 3 * (0.25 / n) ** 0.5, rate
    assert torch.equal(out[kept], h[kept] * 2)
    again = lenet.tail(params, h1, cfg, train=True,
                       generator=torch.Generator().manual_seed(3))
    assert torch.equal(again, out)
    other = lenet.tail(params, h1, cfg, train=True,
                       generator=torch.Generator().manual_seed(4))
    assert not torch.equal(other, out)
    assert torch.equal(lenet.tail(params, h1, cfg, train=False), h)


# -- (g) cached features, (h) accuracies ---------------------------------

@pytest.mark.parametrize("design", DESIGNS)
def test_cache_first_layer_bitwise(data, reference, design):
    """24 test images in batches of 16 (a whole batch and a partial one)."""
    xte = data[2][:24]
    h, jh = _hybrids(**DESIGNS[design])
    got = hybrid.cache_first_layer(_port(reference["params"]), xte, h,
                                   batch=16)
    want = jhybrid.cache_first_layer(reference["params"], xte, jh, batch=16)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _same_accuracy(acc, jacc, n, logits_of, jlogits_of):
    """Equal, or apart by at most 2 images, each a logit near tie (the
    logits computed only then)."""
    if acc == jacc:
        return
    assert abs(acc - jacc) * n <= 2 + 1e-9, (acc, jacc)
    logits, jlogits = logits_of(), np.asarray(jlogits_of())
    for i in np.nonzero(logits.argmax(-1) != jlogits.argmax(-1))[0]:
        top = np.sort(jlogits[i])[-2:]
        assert top[1] - top[0] < 1e-4, (i, jlogits[i])


@pytest.mark.parametrize("design", ["float", "binary4", "sc4"])
def test_evaluate_matches_reference(data, reference, design):
    _, _, xte, yte = data
    kw = {"float": dict(mode="float"), "binary4": dict(mode="binary", bits=4),
          "sc4": dict(mode="sc", sc=dict(bits=4))}[design]
    n = 72 if design == "sc4" else len(xte)
    h, jh = _hybrids(**kw)
    jparams = reference["params"]
    params = _port(jparams)
    acc = hybrid.evaluate(params, xte[:n], yte[:n], CFG, h)
    jacc = jhybrid.evaluate(jparams, xte[:n], yte[:n], JCFG, jh)
    x = xte[:n].astype(np.float32) / 255.0

    def logits_of():
        with torch.no_grad():
            return lenet.apply(params, torch.from_numpy(x), CFG, mode=h.mode,
                               sc_cfg=h.sc, bits=h.bits).numpy()
    _same_accuracy(acc, jacc, n, logits_of, lambda: jlenet.apply(
        jparams, jnp.asarray(x), JCFG, mode=jh.mode, sc_cfg=jh.sc,
        bits=jh.bits))


def test_evaluate_cached_matches_reference(data, reference):
    yte = data[3]
    jparams = reference["params"]
    fte = reference["fte"]
    acc = hybrid.evaluate_cached(_port(jparams), fte, yte, CFG)
    acc_t = hybrid.evaluate_cached(_port(jparams), torch.from_numpy(fte),
                                   yte, CFG)
    jacc = jhybrid.evaluate_cached(jparams, fte, yte, JCFG)
    assert acc == acc_t

    def logits_of():
        with torch.no_grad():
            return lenet.tail(_port(jparams),
                              torch.from_numpy(fte.astype(np.float32)),
                              CFG).numpy()
    _same_accuracy(acc, jacc, len(yte), logits_of, lambda: jlenet.tail(
        jparams, jnp.asarray(fte, jnp.float32), JCFG))


# -- (i) the pipeline ------------------------------------------------------

def test_pipeline_meets_reference_thresholds(data, reference):
    """test_system's protocol through the port from the reference's initial
    weights: float > 0.8; SC 4-bit after retraining > 0.75, >= before -
    0.02 and within 0.15 of float; the 2-bit design worse than the 4-bit."""
    xtr, ytr, xte, yte = data
    params = _port(reference["init"])
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    opt = optim.init(params, opt_cfg)
    gen = torch.Generator().manual_seed(1)
    for xb, yb in mnist_synth.batches(xtr, ytr, 64, 0, 150):
        params, opt, _ = hybrid.float_train_step(params, opt, xb, yb, gen,
                                                 CFG, opt_cfg)
    float_acc = hybrid.evaluate(params, xte, yte, CFG,
                                hybrid.HybridConfig(mode="float"))
    assert float_acc > 0.8, float_acc
    h4, _ = _hybrids(sc=dict(bits=4))
    ftr = hybrid.cache_first_layer(params, xtr[:1500], h4)
    fte = hybrid.cache_first_layer(params, xte, h4)
    before = hybrid.evaluate_cached(params, fte, yte, CFG)
    retrained = hybrid.retrain_tail(params, ftr, ytr[:1500], CFG, steps=150,
                                    batch=64)
    after = hybrid.evaluate_cached(retrained, fte, yte, CFG)
    assert after >= before - 0.02, (before, after)
    assert after > 0.75, (before, after)
    assert float_acc - after < 0.15, (float_acc, after)
    h2, _ = _hybrids(sc=dict(bits=2))
    acc2 = hybrid.evaluate_cached(
        params, hybrid.cache_first_layer(params, xte[:300], h2), yte[:300],
        CFG)
    acc4 = hybrid.evaluate_cached(params, fte[:300], yte[:300], CFG)
    assert acc4 > acc2, (acc2, acc4)


def test_retraining_within_band_of_reference(data, reference):
    """From the reference's pretrained weights and features, the port's
    retrained accuracy for dropout seeds 0-2 lies within ``BAND`` of the
    reference's, and the seeds' own spread within it too."""
    _, ytr, _, yte = data
    params = _port(reference["params"])
    accs = [hybrid.evaluate_cached(
        hybrid.retrain_tail(params, reference["ftr"], ytr[:1500], CFG,
                            steps=150, batch=64, seed=seed),
        reference["fte"], yte, CFG) for seed in range(3)]
    assert max(accs) - min(accs) <= BAND, accs
    assert all(abs(a - reference["after"]) <= BAND for a in accs), \
        (accs, reference["after"])
