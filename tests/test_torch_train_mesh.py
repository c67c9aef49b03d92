"""The training meshes in the port against the reference on the CPU.

The reference trains on any mesh through GSPMD (``repro/launch/train.py``
with ``lm.init``'s specs, ZeRO-1 optimizer specs, the batch over the
data-parallel axes); its pins are ``tests/test_dist.py``, whose 8-device
run forces host devices in a subprocess.  The port partitions each step
explicitly over a ``Mesh`` of ``torch.device`` (here every coordinate is
``"cpu"``), so the step's function is the reference's one-device step's
up to the order of float32 sums.  With the reference's weights
(``convert.lm_params_from_jax``) in float32:

- the specs: ``lm.param_specs``, ``zero_shard_specs`` and
  ``opt_state_specs`` equal the reference's for every config (smoke and
  full) at five meshes, and ``tests/test_dist.py``'s spec cases and
  ``hint``'s resolution hold;
- placement: every shard has the shape its spec gives it, and
  ``shard`` / ``gather`` round-trip bit for bit;
- the step: the sharded step against the reference's jitted one-device
  ``make_train_step`` (loss within 1e-5 relative, parameters within the
  reference's ``rtol=2e-3, atol=2e-5``): ``tests/test_dist.py``'s config
  on (2, 2, 2) for 3 steps, every family's smoke config on 2x2, the
  microbatch membership (mb 2 over dp 2 with labelled counts that differ
  by row), shards with unequal labelled counts, ``compress_grads``, the
  moe family's routing groups whole on each shard and straddling them;
- AdamW over a sharded tree bit for bit the one-device update;
- elastic restore: a 2x2 checkpoint restores onto 1x1 and 1x4 bit for
  bit, its files are a one-device save's byte for byte, and it restores
  in the reference;
- the launcher's mesh and its run at ``--mesh 2x2x2`` are in
  ``tests/test_torch_ckpt.py``."""
import dataclasses
import filecmp
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import manager as jckpt
from repro.data import tokens as jtokens
from repro.dist import sharding as jshd
from repro.models import lm as jlm
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.ckpt import manager as ckpt
from repro_torch.convert import lm_params_from_jax
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train.step import TrainConfig, make_train_step, value_and_grad

from test_torch_lm import VLM_GATE
from test_torch_train import FAST, _batch, _int8_ties

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ["stablelm_3b", "deepseek_moe_16b", "hymba_1_5b", "whisper_medium",
         "llama32_vision_90b", "rwkv6_7b", "moonshot_v1_16b_a3b",
         "starcoder2_15b", "deepseek_67b", "llama3_405b"]
FAMILIES = {"decoder": "stablelm_3b", "moe": "deepseek_moe_16b",
            "hybrid": "hymba_1_5b", "encdec": "whisper_medium",
            "vlm": "llama32_vision_90b", "rwkv": "rwkv6_7b"}
MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 4}]
# tests/test_dist.py's 8-device config (float32 here) and its optimizer
DIST_CFG = dict(name="t", family="decoder", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                remat="full", param_dtype="float32")
RTOL, ATOL = 2e-3, 2e-5       # the reference's own (tests/test_dist.py)


def _mesh(ms: dict) -> shd.Mesh:
    return make_mesh(tuple(ms.values()), tuple(ms), "cpu")


def _spec_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _jflat(tree, pre=""):
    """{dotted name: leaf} of a nested dict (jax specs are leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


# ==========================================================================
# Specs.
# ==========================================================================

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, smoke):
    """``lm.param_specs`` is the reference's ``init(..., abstract=True)[1]``
    and the ZeRO-1 specs its ``zero_shard_specs`` / ``opt_state_specs``,
    leaf for leaf, at every mesh of ``MESHES``."""
    pick = configs.smoke_config if smoke else configs.config
    jpick = jconfigs.smoke_config if smoke else jconfigs.config
    cfg, jcfg = pick(arch), jpick(arch)
    shapes = lm._shapes(cfg)
    for ms in MESHES:
        jp, js = jlm.init(jax.random.key(0), jcfg, ms, abstract=True)
        specs = lm.param_specs(cfg, ms)
        want, got = _jflat(js), _jflat(specs)
        assert set(got) == set(want), (ms, set(got) ^ set(want))
        for name in want:
            assert _spec_tuple(got[name]) == _spec_tuple(want[name]), \
                (ms, name, got[name], want[name])
        jz = _jflat(jshd.opt_state_specs(js, jp, ms))
        z = _jflat(shd.opt_state_specs(specs, shapes, ms))
        assert set(z) == set(jz)
        for name in jz:
            assert _spec_tuple(z[name]) == _spec_tuple(jz[name]), \
                (ms, name, z[name], jz[name])
        # every spec places: each dim divides over the axes that cut it
        mesh, flat = _mesh(ms), _jflat(shapes)
        for tree in (specs, shd.zero_shard_specs(specs, shapes, ms)):
            for name, spec in _jflat(tree).items():
                shd.box(shd.NamedSharding(mesh, spec),
                        tuple(flat[name].shape), (0,) * len(ms))


def test_spec_helpers_match_test_dist():
    """``tests/test_dist.py``'s cases of the spec helpers."""
    ms = {"data": 4, "model": 2}
    assert shd.batch_spec_axis(ms, 8) == "data"
    assert shd.batch_spec_axis(ms, 3) is None
    ms2 = {"pod": 2, "data": 4, "model": 2}
    assert shd.batch_spec_axis(ms2, 16) == ("pod", "data")
    assert shd.dp_size(ms2) == 8
    assert shd.axis_if_divisible("model", 32, {"model": 16}) == "model"
    assert shd.axis_if_divisible("model", 25, {"model": 16}) is None
    params = {"w": torch.empty((64, 32)), "b": torch.empty((7,))}
    specs = {"w": shd.P(None, "model"), "b": shd.P(None)}
    z = shd.zero_shard_specs(specs, params, {"data": 16, "model": 16})
    assert z["w"] == shd.P("data", "model")
    assert z["b"] == shd.P(None)
    x = torch.ones((4, 4))
    assert shd.hint(x, "batch", "model") is x
    with shd.use_activation_mesh(_mesh({"data": 2, "model": 2})):
        assert shd.hint(x, "batch", "model") is x


def test_hint_resolution_matches_reference(monkeypatch):
    """:func:`resolve_hint` gives the spec the reference's ``hint``
    constrains to (its ``with_sharding_constraint`` intercepted), over
    batch sizes, axes that do and do not divide and absent axes."""
    class FakeMesh:
        def __init__(self, ms):
            self.axis_names = tuple(ms)
            self.devices = np.empty(tuple(ms.values()), object)
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    cases = [((8, 32), ("batch", None)), ((6, 32, 64), ("batch", None,
                                                         "model")),
             ((16, 5), ("batch", "model")), ((3, 4), ("batch", "data")),
             ((4, 8), (None, "pod")), ((4, 1), ("model", "model"))]
    for ms in ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
               {"data": 4, "model": 1}):
        for shape, axes in cases:
            with jshd.use_activation_mesh(FakeMesh(ms)):
                want = jshd.hint(jnp.zeros(shape), *axes)
            assert _spec_tuple(shd.resolve_hint(shape, axes, ms)) == \
                _spec_tuple(want), (ms, shape, axes)


def test_production_meshes():
    """``make_production_mesh``: (16, 16) ``("data", "model")`` and (2, 16,
    16) ``("pod", "data", "model")``, every device the CPU here."""
    one = make_production_mesh(device="cpu")
    two = make_production_mesh(multi_pod=True, device="cpu")
    assert shd.mesh_shape_dict(one) == {"data": 16, "model": 16}
    assert shd.mesh_shape_dict(two) == {"pod": 2, "data": 16, "model": 16}
    assert set(two.device_list) == {CPU}


def test_tp_plan_counts_gathered_layers():
    """``lm.tp_plan``: stablelm-3b splits every attention and MLP at model
    2; hymba's smoke config (2 KV heads) gathers its attention at model 4
    and still splits its MLPs; whisper's cross-attention is never
    split."""
    _, c = lm.tp_plan(configs.config("stablelm_3b"), {"data": 2, "model": 2})
    assert c == {"attention_split": 32, "attention_gathered": 0,
                 "mlp_split": 32, "mlp_gathered": 0}
    plan, c = lm.tp_plan(configs.smoke_config("hymba_1_5b"),
                         {"data": 1, "model": 4})
    assert c == {"attention_split": 0, "attention_gathered": 4,
                 "mlp_split": 4, "mlp_gathered": 0}
    assert plan["blocks"]["attn"]["wq"] is None
    assert plan["blocks"]["mlp"]["w_out"] == 1
    plan, _ = lm.tp_plan(configs.smoke_config("whisper_medium"),
                         {"data": 1, "model": 2})
    assert plan["dec_blocks"]["attn"]["wq"] == 2
    assert plan["dec_blocks"]["xattn"]["wq"] is None
    assert plan["dec_blocks"]["attn"]["bo"] is None


# ==========================================================================
# Placement.
# ==========================================================================

def test_placement_follows_specs():
    """Every shard of the smoke stablelm-3b on (2, 2, 2) has its spec's
    shape on its coordinate's device; ``gather`` of ``shard`` is the tree
    bit for bit; the ZeRO-1 state's shards likewise."""
    cfg = configs.smoke_config("stablelm_3b")
    ms = {"pod": 2, "data": 2, "model": 2}
    mesh = _mesh(ms)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    specs = lm.param_specs(cfg, ms)
    sp = shd.shard(params, shd.named(mesh, specs))
    size = dict(ms)
    for x, spec, whole in zip(optim.leaves(sp), optim.leaves(specs),
                              optim.leaves(params)):
        for c, b, t in x.items():
            want = []
            for dim, entry in zip(whole.shape, tuple(spec) + (None,) * 4):
                axes = (entry,) if isinstance(entry, str) else \
                    tuple(entry or ())
                want.append(dim // int(np.prod([size[a] for a in axes])))
            assert tuple(t.shape) == tuple(want), (spec, t.shape)
            assert t.device == CPU
            assert torch.equal(t, whole[tuple(slice(lo, hi)
                                              for lo, hi in b)])
    assert sp["blocks"]["attn"]["wq"].pieces[0, 1, 1].shape == (4, 80, 80)
    for a, b in zip(optim.leaves(shd.gather(sp, CPU)),
                    optim.leaves(params)):
        assert torch.equal(a, b)
    st = optim.init(sp, optim.AdamWConfig(master_dtype=torch.float32))
    # embed (512, 160) ("model", None): ZeRO-1 takes d over (pod, data)
    m = st["m"]["embed"]
    assert m.spec == shd.P("model", ("pod", "data"))
    assert m.pieces[1, 1, 1].shape == (256, 40)
    assert torch.equal(shd.gather(st["master"], CPU)["embed"],
                       params["embed"].float())


# ==========================================================================
# The step against the reference's one-device step.
# ==========================================================================

@functools.cache
def _weights(arch: str, **overrides):
    """(reference cfg, reference params, port cfg, port params): the
    family's smoke config (2 layers, vlm 3) in float32 with ``overrides``,
    the reference's jitted ``init`` carried over; vlm gates at
    ``VLM_GATE`` on both sides."""
    kw = {} if arch == "llama32_vision_90b" else {"n_layers": 2}
    kw.update(overrides)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               param_dtype="float32", **kw)
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32", **kw)
    return _pair(jcfg, cfg)


def _pair(jcfg, cfg):
    key = jax.random.key(0)
    jparams = jax.jit(lambda k: jlm.init(k, jcfg, {})[0]).lower(key).compile(
        compiler_options=FAST)(key)
    if jcfg.family == "vlm":
        g = jparams["cross_blocks"]["gate_attn"]
        jparams["cross_blocks"]["gate_attn"] = jnp.full_like(g, VLM_GATE)
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _jt(tcfg: TrainConfig):
    """The reference's ``TrainConfig`` of the port's."""
    a = tcfg.adamw
    return jstep.TrainConfig(
        microbatches=tcfg.microbatches, compress_grads=tcfg.compress_grads,
        adamw=joptim.AdamWConfig(lr=a.lr, weight_decay=a.weight_decay,
                                 grad_clip=a.grad_clip,
                                 master_dtype=jnp.float32))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_jax(t) for t in tree)
    return jnp.asarray(tree.numpy())


def _compare_steps(jcfg, cfg, params, tcfg, ms, batches, ties=None):
    """The port's sharded step on a "cpu" mesh of ``ms`` over ``batches``
    against the reference's jitted one-device step, step by step from the
    same state (the reference takes the sharded run's gathered state
    before each step, so the runs do not drift apart): each loss within
    1e-5 relative, the parameters after each step within the reference's
    tolerance.  Returns the step function."""
    mesh = _mesh(ms)
    p = shd.shard(params, shd.named(mesh, lm.param_specs(cfg, ms)))
    opt = optim.init(p, tcfg.adamw)
    step = make_train_step(cfg, tcfg, mesh)
    fn = None
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jstate = _to_jax(shd.gather((p, opt), CPU))
        if fn is None:
            fn = jax.jit(jstep.make_train_step(jcfg, _jt(tcfg))).lower(
                *jstate, jb).compile(compiler_options=FAST)
        jp, _, jm = fn(*jstate, jb)
        p, opt, m = step(p, opt, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        _assert_close(float(m["loss"]), float(jm["loss"]),
                      shd.gather(p, CPU), jax.tree.map(np.asarray, jp),
                      ties, tcfg.adamw.lr)
    return step


def _assert_close(loss, jloss, params, jparams, ties=None, lr=0.0):
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = _jflat(jparams)
    for name, got in _jflat(params).items():
        err = np.abs(got.numpy() - want[name])
        far = err > ATOL + RTOL * np.abs(want[name])
        if ties is not None:      # int8 rounding ties, held to 1.01 lr
            assert (err[far] <= 1.01 * lr).all(), name
            far &= ~ties[name]
        assert not far.any(), (name, float(err[far].max()))


def _tcfg(mb=1, lr=3e-4, compress=False) -> TrainConfig:
    return TrainConfig(microbatches=mb, compress_grads=compress,
                       adamw=optim.AdamWConfig(lr=lr, weight_decay=0.1,
                                               grad_clip=1.0,
                                               master_dtype=torch.float32))


def test_dist_config_three_steps_on_pod_data_model():
    """``tests/test_dist.py``'s config (2 layers, d 64, 4 heads over 2,
    ``remat="full"``, mb 2, lr 1e-2) on the (2, 2, 2) ``("pod", "data",
    "model")`` mesh for 3 steps of ``batch_at(0, i, 8, 32)``: each loss
    and the final parameters against the reference's one-device run;
    attention and the MLPs split over the model axis."""
    jcfg, cfg = jlm.LMConfig(**DIST_CFG), lm.LMConfig(**DIST_CFG)
    _, jparams, _, params = _pair(jcfg, cfg)
    batches = [jtokens.batch_at(0, i, 8, 32, cfg.vocab) for i in range(3)]
    step = _compare_steps(jcfg, cfg, params, _tcfg(mb=2, lr=1e-2),
                          {"pod": 2, "data": 2, "model": 2}, batches)
    assert step.tp_layers == {"attention_split": 2, "attention_gathered": 0,
                              "mlp_split": 2, "mlp_gathered": 0}


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_family_step_on_2x2(fam):
    """One step of each family's smoke config on 2x2 (batch of 2, one row
    a data-parallel coordinate, one label ignored; the moe family's one
    routing group of 64 tokens straddles the coordinates) against the
    reference's one-device step."""
    jcfg, _, cfg, params = _weights(FAMILIES[fam])
    _compare_steps(jcfg, cfg, params, _tcfg(), {"data": 2, "model": 2},
                   [_batch(cfg)])


def _uneven(cfg, B: int, S: int = 32, seed: int = 7) -> dict:
    """Tokens and labels whose labelled counts differ by row: row 0 keeps
    4 labels, row 1 all but one, row r > 1 all but r."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 4:] = -1
    for r in range(1, B):
        labels[r, :max(1, r)] = -1
    return {"tokens": toks, "labels": labels.astype(np.int32)}


@pytest.mark.parametrize("case", ["microbatch_membership", "unequal_counts",
                                  "compress_grads"])
def test_step_traps(case):
    """The step's traps on the decoder smoke config over 2x2: microbatch
    i is the global rows [i n, (i + 1) n) split over the coordinates (mb
    2 over dp 2, 4 rows whose labelled counts differ, so another
    membership changes the microbatches' means); each shard's loss is
    over the microbatch's whole count (mb 1, shards of 4 and 59
    labels); ``compress_grads`` quantizes the reduced whole leaf (an
    element within 1 % of an int8 rounding boundary may round to the
    neighbouring code on one side only, and is held to 1.01 lr)."""
    jcfg, _, cfg, params = _weights("stablelm_3b")
    tcfg = _tcfg(mb=2 if case == "microbatch_membership" else 1,
                 compress=case == "compress_grads")
    batches = [_uneven(cfg, 4)]
    ties = None
    if case == "compress_grads":
        _, _, raw = value_and_grad(cfg, params, {
            k: torch.from_numpy(v) for k, v in batches[0].items()})
        ties = {k: _int8_ties(g, tcfg.compress_chunk)
                for k, g in _jflat(raw).items()}
    _compare_steps(jcfg, cfg, params, tcfg, {"data": 2, "model": 2},
                   batches, ties)


@pytest.mark.parametrize("group", [64, 128], ids=["whole", "straddling"])
def test_moe_routing_groups(group):
    """The moe family at 2x2 over 4 rows of 32 tokens: with routing groups
    of 64 each coordinate routes its own whole group (and its aux loss is
    half the mean); with groups of 128 the one group straddles the
    coordinates, and the first coordinate computes the whole microbatch
    (counted in ``moe_unsplit_microbatches``).  Both against the
    reference's one-device step."""
    jcfg, _, cfg, params = _weights("deepseek_moe_16b",
                                    moe_group_size=group)
    step = _compare_steps(jcfg, cfg, params, _tcfg(lr=1e-3),
                          {"data": 2, "model": 2}, [_uneven(cfg, 4, seed=9)])
    assert step.moe_unsplit_microbatches == (group == 128)


def test_sharded_adamw_bitwise_one_device():
    """``optim.apply_`` over a (2, 2, 2)-sharded bf16 tree with a float32
    master (ZeRO-1 shards, the parameters rewritten from the master) is
    bit for bit the one-device update, clip off, over two steps."""
    cfg = configs.smoke_config("stablelm_3b")
    ms = {"pod": 2, "data": 2, "model": 2}
    mesh = _mesh(ms)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    grads = optim.unflatten(params, [torch.randn(p.shape, generator=gen).to(
        p.dtype) for p in optim.leaves(params)])
    acfg = optim.AdamWConfig(lr=3e-4, weight_decay=0.1,
                             master_dtype=torch.float32)
    sp = shd.shard(params, shd.named(mesh, lm.param_specs(cfg, ms)))
    st = optim.init(sp, acfg)
    sg = shd.shard(grads, shd.shardings_of(st["m"]))
    one_p = optim.unflatten(params, [t.clone() for t in
                                     optim.leaves(params)])
    one_s = optim.init(one_p, acfg)
    for _ in range(2):
        optim.apply_(sp, sg, st, acfg)
        optim.apply_(one_p, grads, one_s, acfg)
    for a, b in zip(optim.leaves(shd.gather({"p": sp, "s": st}, CPU)),
                    optim.leaves({"p": one_p, "s": one_s})):
        assert torch.equal(a, b)


# ==========================================================================
# Elastic restore, the launcher.
# ==========================================================================

def ckpt_leaves(tree) -> list:
    """The leaves of a (params, opt) tree in the checkpoint's order."""
    return [leaf for _, leaf in ckpt._flatten(tree)]


def _stepped_2x2(cfg):
    """The bf16 smoke model on 2x2 after one step, and its step config."""
    ms = {"data": 2, "model": 2}
    mesh = _mesh(ms)
    tcfg = _tcfg()
    p = shd.shard(lm.init(cfg, torch.Generator().manual_seed(3)),
                  shd.named(mesh, lm.param_specs(cfg, ms)))
    o = optim.init(p, tcfg.adamw)
    b = {k: torch.from_numpy(v) for k, v in
         jtokens.batch_at(1, 0, 4, 32, cfg.vocab).items()}
    make_train_step(cfg, tcfg, mesh)(p, o, b)
    return p, o, tcfg


def _on(cfg, tcfg, ms):
    """A fresh sharded (params, opt) target on a "cpu" mesh of ``ms``."""
    mesh = _mesh(ms)
    p = shd.shard(lm.init(cfg, torch.Generator().manual_seed(5)),
                  shd.named(mesh, lm.param_specs(cfg, ms)))
    return mesh, p, optim.init(p, tcfg.adamw)


def test_elastic_restore(tmp_path):
    """A checkpoint saved on 2x2 (bf16, a float32 master, after one step):
    its files byte for byte a one-device save of the gathered state; it
    restores onto 1x1 and ``1x4 data,model`` with every leaf bit for bit
    the saved one, and the next step there is bit for bit a step from the
    same state placed on that mesh directly; and it restores in the
    reference."""
    cfg = configs.smoke_config("stablelm_3b")
    p, o, tcfg = _stepped_2x2(cfg)
    ckpt.CheckpointManager(tmp_path / "mesh").save_sync(1, (p, o))
    whole = shd.gather((p, o), CPU)
    ckpt.save(tmp_path / "one", 1, whole)
    a, b = tmp_path / "mesh" / "step_0000000001", \
        tmp_path / "one" / "step_0000000001"
    strip = ("key", "file", "shape", "dtype", "crc32")
    ma = json.loads((a / "manifest.json").read_text())["leaves"]
    mb = json.loads((b / "manifest.json").read_text())["leaves"]
    assert [{k: m[k] for k in strip} for m in ma] == \
        [{k: m[k] for k in strip} for m in mb]
    for m in ma:
        assert filecmp.cmp(a / m["file"], b / m["file"], shallow=False)
    batch = {k: torch.from_numpy(v) for k, v in
             jtokens.batch_at(1, 1, 4, 32, cfg.vocab).items()}
    for ms in ({"data": 1, "model": 1}, {"data": 1, "model": 4}):
        mesh, tp, to = _on(cfg, tcfg, ms)
        (rp, ro), manifest = ckpt.CheckpointManager(
            tmp_path / "mesh").restore_latest(
            (tp, to), shardings=(shd.shardings_of(tp), shd.shardings_of(to)))
        assert manifest["step"] == 1
        assert rp["embed"].mesh is mesh
        for x, y in zip(ckpt_leaves(shd.gather((rp, ro), CPU)),
                        ckpt_leaves(whole)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        direct = shd.shard(whole, (shd.shardings_of(tp),
                                   shd.shardings_of(to)))
        step = make_train_step(cfg, tcfg, mesh)
        m1 = step(rp, ro, batch)[2]
        m2 = step(*direct, batch)[2]
        assert torch.equal(m1["loss"], m2["loss"])
        for x, y in zip(ckpt_leaves(shd.gather((rp, ro), CPU)),
                        ckpt_leaves(shd.gather(direct, CPU))):
            assert torch.equal(x, y)
    jparams = jax.jit(lambda k: jlm.init(k, jconfigs.smoke_config(
        "stablelm_3b"), {})[0])(jax.random.key(0))
    jopt = joptim.init(jparams, joptim.AdamWConfig(master_dtype=jnp.float32))
    restored, _ = jckpt.restore(tmp_path / "mesh",
                                jax.tree.map(jnp.zeros_like, (jparams, jopt)))
    for x, y in zip(jax.tree.leaves(restored), ckpt_leaves(whole)):
        assert np.array_equal(np.asarray(x).astype(np.float32),
                              y.float().numpy())
