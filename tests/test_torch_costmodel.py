"""Roofline cost attribution (``repro_torch.serve.obs.costmodel``) on the CPU.

The reference's contract, on the port: ``analyze`` returns FLOPs and bytes
or None and never raises, ``attribute`` degrades per stage, ``span_for``
strips slice prefixes and bucket suffixes, and ``stage_energy`` re-folds
the request spans to the ledger bit for bit (``tests/test_costmodel.py``,
its fakes here plain count functions, as the port's ``cost_args()``
entries are).  The analytic counts against ``torch.utils.flop_counter``
over each stage's plain version at the smoke size (within 10 %): one-shot
prefill, a resumed fold chunk, the paged tick over full tables, the dense
tick, the frame gateway stages in both modes; the SC sensor stage against
the bit operations of the ``sc_dot`` shapes it really calls.  A traced
paged gateway's ``cost_args()`` are the mean work of its spans, its decode
tick memory-bound at the H100's ridge, and ``source`` reads
``"analytic"``.  Every family (moe, hybrid, encdec, vlm, rwkv) and the SC
frontend: the dense adapter's prefill and tick stages ``"analytic"``,
their FLOPs within 10 % of ``FlopCounterMode`` over the plain versions
plus the terms written out from the shapes where the plain version
computes elementwise (the selective scan's state update, ``wkv6_step``'s
update and readout, the SC frontend's bit operations), and the weight
counts equal to the parameter tree's elements."""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models.lm import layer_window
from repro_torch.serve import engine, obs
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.gateway import GatewayConfig, PromptGateway
from repro_torch.serve.gateway.sensors import Arrival
from repro_torch.serve.gateway.slots import (ContinuousBatcher,
                                             KVSlotAdapter, make_adapter)
from repro_torch.serve.obs import costmodel
from test_torch_obs import MicroBatchGateway, _setup

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

# the H100 SXM's ridge: dense bf16 tensor peak over HBM3 bandwidth (NVIDIA
# data sheet)
H100_RIDGE = 989e12 / 3.35e12


def _prompt_arrivals(cfg, n, plen=16, seed=0, dt=0.001):
    rng = np.random.default_rng(seed)
    return [Arrival(t=i * dt, uid=i, endpoint=0, kind="prompt",
                    payload=rng.integers(0, cfg.vocab, plen)
                    .astype(np.int32)) for i in range(n)]


def _fake_fn(result=None, exc=None):
    """A stand-in count function that returns ``result`` (or raises
    ``exc``): what a count has to say about a stage it cannot count."""
    def count(*args):
        if exc is not None:
            raise exc
        return result
    return count


def _flops(fn, *args, **kw) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


# ==========================================================================
# analyze(): the degrade-never-crash contract.
# ==========================================================================

def test_analyze_degrades_to_none_when_count_offers_nothing():
    assert obs.analyze(_fake_fn(exc=NotImplementedError("family")), ()) \
        is None
    assert obs.analyze(_fake_fn(result=None), ()) is None
    assert obs.analyze(_fake_fn(result=[]), ()) is None
    assert obs.analyze(_fake_fn(result={}), ()) is None
    assert obs.analyze(_fake_fn(result={"other": 1.0}), ()) is None
    assert obs.analyze(_fake_fn(result={"flops": 0.0, "bytes": 0.0}), ()) \
        is None
    cfg, _ = _setup()
    unknown = dataclasses.replace(cfg, family="gru")
    assert obs.analyze(costmodel.lm_step_cost,
                       (unknown, 1, 1, 1, 1, 1)) is None
    # every family the port serves is counted
    hybrid = dataclasses.replace(cfg, family="hybrid")
    assert obs.analyze(costmodel.lm_step_cost,
                       (hybrid, 1, 1, 1, 1, 1))["flops"] > 0


def test_analyze_passes_the_args_and_keeps_partial_counts():
    assert obs.analyze(lambda a, b: {"flops": a, "bytes": b}, (5, 10)) == \
        {"flops": 5.0, "bytes": 10.0}
    # bytes with no FLOP count is still useful (traffic-only verdict)
    assert obs.analyze(_fake_fn(result={"bytes": 128.0}), ()) == \
        {"flops": 0.0, "bytes": 128.0}


# ==========================================================================
# Stage-key -> serving-span mapping.
# ==========================================================================

def test_span_for_strips_slice_prefixes_and_bucket_suffixes():
    assert obs.span_for("decode") == "tick"
    assert obs.span_for("slice0.decode") == "tick"
    assert obs.span_for("chunk_fold") == "prefill_chunk"
    assert obs.span_for("slice3.chunk_fold") == "prefill_chunk"
    assert obs.span_for("prefill") == "prefill"
    assert obs.span_for("copy") == "migrate"
    assert obs.span_for("sensor_b8") == "batch"
    assert obs.span_for("slice2.gateway_b4") == "batch"
    assert obs.span_for("write_block") is None
    assert obs.span_for("scatter") is None


# ==========================================================================
# attribute(): degradation ladder, measured joins, verdicts.
# ==========================================================================

def test_attribute_degrades_per_stage_never_crashes():
    tr = obs.Tracer()
    tr.begin("tick", pid=obs.ENGINE_PID, tid=0, t=0.0)
    tr.end("tick", pid=obs.ENGINE_PID, tid=0, t=0.25)
    rep = obs.attribute(
        {"decode": (_fake_fn(exc=RuntimeError("no count")), ()),
         "chunk_fold": (_fake_fn(result={"bytes": 64.0}), ()),
         "prefill": (_fake_fn(result={"flops": 90.0, "bytes": 100.0}), ())},
        tr)
    st = rep["stages"]
    assert st["decode"]["source"] == "measured-only"
    assert st["decode"]["verdict"] == "unknown"
    assert st["decode"]["flops"] is None
    assert st["decode"]["calls"] == 1
    assert st["decode"]["measured_s"] == pytest.approx(0.25)
    assert st["chunk_fold"]["source"] == "bytes-only"
    assert st["chunk_fold"]["verdict"] == "memory-bound"
    assert st["chunk_fold"]["intensity"] == 0.0
    assert st["prefill"]["source"] == "analytic"
    assert st["prefill"]["intensity"] == pytest.approx(0.9)
    assert st["prefill"]["verdict"] == "compute-bound"
    assert rep["ridge_flops_per_byte"] == obs.DEFAULT_RIDGE == 0.6


def test_attribute_without_tracer_is_static_only():
    rep = obs.attribute(
        {"decode": (_fake_fn(result={"flops": 1.0, "bytes": 10.0}), ())})
    entry = rep["stages"]["decode"]
    assert entry["calls"] == 0 and entry["measured_s"] == 0.0
    assert entry["verdict"] == "memory-bound"
    assert "achieved_flops_per_s" not in entry
    assert "energy" not in rep


def test_attribute_respects_custom_ridge():
    stages = {"prefill": (_fake_fn(result={"flops": 90.0, "bytes": 100.0}),
                          ())}
    assert obs.attribute(stages, ridge=0.5)["stages"]["prefill"]["verdict"] \
        == "compute-bound"
    assert obs.attribute(stages, ridge=2.0)["stages"]["prefill"]["verdict"] \
        == "memory-bound"


def test_costmodel_entry_points_charge_the_callback_counter():
    c0 = obs.callback_count()
    obs.attribute({})
    obs.stage_energy(obs.Tracer())
    assert obs.callback_count() > c0


# ==========================================================================
# The analytic counts against FlopCounterMode over the plain versions.
# ==========================================================================

@pytest.mark.parametrize("q0,c", [(0, 16), (8, 4), (0, 7)])
def test_prompt_flops_match_flop_counter(q0, c):
    """A one-shot prompt (q0 = 0) and a resumed fold chunk: the plain
    version scores the whole chunk x prefix rectangle, the count the
    causal pairs, well inside 10 % at this size."""
    cfg, params = _setup()
    rng = np.random.default_rng(q0 + c)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, q0 + c))
                              .astype(np.int64))
    cache = engine.empty_cache(cfg, 1, "cpu")
    if q0:
        cache, _ = engine.prefill(cfg, params, tokens[:, :q0])
    counted = _flops(engine.prefill_chunked, cfg, params, tokens[:, q0:],
                     cache, q0)
    want = costmodel.lm_step_cost(
        cfg, **costmodel.prompt_work(cfg, q0, c))["flops"]
    assert want == pytest.approx(counted, rel=0.1)


def test_paged_tick_flops_match_flop_counter():
    """The tick with every lane at a full table, where the plain version's
    rectangle is the lanes' contexts."""
    cfg, params = _setup()
    n, bs, nb = 4, 4, 6
    arena = engine.init_paged_arena(cfg, n * nb + 1, bs, "cpu")
    tables = torch.arange(1, n * nb + 1, dtype=torch.int32).reshape(n, nb)
    lens = torch.full((n,), nb * bs - 1, dtype=torch.int32)
    tokens = torch.zeros((n, 1), dtype=torch.int64)
    counted = _flops(engine.decode_step_paged, cfg, params, tokens,
                     tables=tables, lens=lens, arena=arena, backend="plain")
    pairs = costmodel.tick_pairs(cfg, [nb * bs] * n)
    want = costmodel.lm_step_cost(cfg, n, pairs, pairs,
                                  n * cfg.n_layers, n)["flops"]
    assert want == pytest.approx(counted, rel=0.1)


def test_dense_tick_and_prefill_cost_args_match_flop_counter():
    cfg, params = _setup()
    ad = KVSlotAdapter(cfg, params, n_slots=3, max_len=24)
    stages = ad.cost_args(prompt_len=8)
    tick = _flops(engine.decode_step, cfg, params,
                  engine.init_cache(cfg, 3, 24, "cpu"),
                  torch.zeros((3, 1), dtype=torch.int64))
    assert obs.analyze(*stages["decode"])["flops"] == \
        pytest.approx(tick, rel=0.1)
    prompt = _flops(engine.prefill, cfg, params,
                    torch.zeros((1, 8), dtype=torch.int64))
    assert obs.analyze(*stages["prefill"])["flops"] == \
        pytest.approx(prompt, rel=0.1)


@pytest.mark.parametrize("mode", ["sc", "binary"])
def test_frame_stage_counts(mode):
    """The host stage against FlopCounterMode; the SC sensor stage against
    the bit operations of the ``sc_dot`` it calls (an AND and an add per
    stream bit of every product, as recorded from the call's shapes); the
    binary sensor stage does no work and degrades to measured-only."""
    spec = fe.FrontendSpec(mode=mode, bits=4)
    gw = MicroBatchGateway(GatewayConfig(bucket_sizes=(1, 4),
                                         service_model="fixed",
                                         fixed_service_s=0.001), spec)
    stages = gw.cost_args()
    assert set(stages) == {"sensor_b1", "gateway_b1", "sensor_b4",
                           "gateway_b4"}
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (4, 28, 28, 1)).astype(np.uint8))
    calls = []
    plain = ref.sc_dot

    def recorded(x, w, *a, **kw):
        calls.append((x.shape, w.shape))
        return plain(x, w, *a, **kw)
    with mock.patch.object(ref, "sc_dot", recorded):
        payload = fe.sensor_stage(gw.params, frames, spec)
    host = _flops(fe.gateway_stage, gw.params, payload, spec)
    assert obs.analyze(*stages["gateway_b4"])["flops"] == \
        pytest.approx(host, rel=0.1)
    sensor = obs.analyze(*stages["sensor_b4"])
    if mode == "binary":
        assert not calls and sensor is None
        return
    (M, K, _), (_, O, _) = calls[0]
    assert len(calls) == 1
    assert sensor["flops"] == 2 * M * K * O * (1 << spec.bits)
    assert sensor["bytes"] > 0
    rep = obs.attribute(stages)["stages"]
    assert all(e["source"] == "analytic" and e["span"] == "batch"
               for e in rep.values())


# ==========================================================================
# A traced gateway: its spans' stages, the H100 verdicts, the energy re-fold.
# ==========================================================================

@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_traced_gateway_costs_are_its_spans_work(backend):
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=4, max_len=64, paged=True,
                      block_size=16, backend=backend)
    tr = obs.Tracer()
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=8, tracer=tr)
    gw.warmup((16,))
    assert tr.spans("prefill_chunk") == []     # warmup is never traced
    arrivals = _prompt_arrivals(cfg, 6, plen=20)
    for a in arrivals[3:]:               # later prompts share a prefix
        a.payload[:16] = arrivals[0].payload[:16]
    tel = gw.run(arrivals)
    assert len(tel.records) == 6
    stages = gw.cost_args()
    chunks = tr.spans("prefill_chunk")
    assert len(chunks) > 0
    # the counts are the representative calls, whatever the run did
    block = costmodel.prompt_work(cfg, 0, 16)
    assert stages["chunk_fold"][1][1:] == tuple(block[k] for k in (
        "tokens", "pairs", "kv_read", "kv_written", "logit_rows")) + ({},)
    rep = obs.attribute(stages, tr, ridge=H100_RIDGE, telemetry=tel)
    st = rep["stages"]
    assert st["decode"]["source"] == "analytic"
    assert st["decode"]["verdict"] == "memory-bound"
    assert st["decode"]["intensity"] < H100_RIDGE
    assert st["chunk_fold"]["calls"] == len(chunks)
    assert st["chunk_fold"]["achieved_bytes_per_s"] > 0
    assert st["copy"]["source"] == "bytes-only"
    en = rep["energy"]
    assert en["conserved"] is True and en["total_nj"] == tel.fleet_energy_nj
    assert en["n_requests"] == 6


def test_untraced_gateway_counts_the_representative_calls():
    cfg, params = _setup()
    ad = make_adapter(cfg, params, n_slots=2, max_len=32, paged=True,
                      block_size=8)
    gw = PromptGateway(ContinuousBatcher(ad), max_new_tokens=3)
    gw.run(_prompt_arrivals(cfg, 2, plen=9))
    stages = gw.cost_args()
    block = costmodel.prompt_work(cfg, 0, 8)
    assert stages["chunk_fold"][1][1:] == tuple(block[k] for k in (
        "tokens", "pairs", "kv_read", "kv_written", "logit_rows")) + ({},)
    pairs = costmodel.tick_pairs(cfg, [32, 32])
    assert stages["decode"][1][1:] == (2, pairs, pairs, 2 * cfg.n_layers, 2,
                                       {})
    assert obs.analyze(*stages["copy"]) == {
        "flops": 0.0,
        "bytes": float(2 * cfg.n_layers * 8 * 2 * cfg.n_kv_heads
                       * cfg.d_head * 4)}


def test_prompt_pairs_closed_form_matches_the_sum():
    cfg = dataclasses.replace(configs.smoke_config("stablelm_3b"), window=5,
                              global_every=3)
    for q0, c in ((0, 1), (0, 16), (3, 4), (4, 2), (12, 9), (40, 16)):
        pairs = rows = 0
        for i in range(cfg.n_layers):
            w = layer_window(cfg, i)
            pairs += sum(min(q0 + j + 1, w) if w else q0 + j + 1
                         for j in range(c))
            rows += (min(q0, w) if w else q0) + c
        assert costmodel.prompt_pairs(cfg, q0, c) == (pairs, rows)



def test_int8_kv_rows_count_their_scales():
    """Under ``kv_quant`` a K/V row is 2 Hkv (Dh + 4) bytes, the int8
    values and a float32 scale per head: the block copy moves exactly the
    bytes of one block of the int8 arena's four tensors, read and written,
    and a step's K/V traffic shrinks by the difference per row."""
    cfg = dataclasses.replace(configs.smoke_config("stablelm_3b"),
                              kv_quant=True)
    arena = engine.init_paged_arena(cfg, 3, 8, "cpu")
    assert set(arena) == {"k", "v", "k_scale", "v_scale"}
    block = sum(a[:, 1].numel() * a.element_size() for a in arena.values())
    assert costmodel.block_copy_cost(cfg, 8) == {"flops": 0.0,
                                                 "bytes": 2 * block}
    bf16 = dataclasses.replace(cfg, kv_quant=False)
    rows = 10 + 4
    got = costmodel.lm_step_cost(cfg, 1, 10, 10, 4, 1)
    want = costmodel.lm_step_cost(bf16, 1, 10, 10, 4, 1)
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    assert got["flops"] == want["flops"]
    assert want["bytes"] - got["bytes"] == \
        rows * (2 * hkv * dh * 2 - 2 * hkv * (dh + 4))


# ==========================================================================
# Every family and the SC frontend.
# ==========================================================================

FAMILY_ARCHS = {"moe": ("deepseek_moe_16b", {}),
                "hybrid": ("hymba_1_5b", {}),
                "encdec": ("whisper_medium", {}),
                "vlm": ("llama32_vision_90b", {}),
                "rwkv": ("rwkv6_7b", {}),
                "sc": ("stablelm_3b", {"first_layer_mode": "sc"})}


def _family_setup(name):
    """A float32 smoke model of ``name``'s family on the CPU, its params
    and the ``extras`` callable its adapters take (None for the
    families that take none)."""
    arch, over = FAMILY_ARCHS[name]
    cfg = dataclasses.replace(configs.smoke_config(arch),
                              param_dtype="float32", **over)
    params = __import__("repro_torch.models.lm", fromlist=["lm"]).init(
        cfg, torch.Generator().manual_seed(0))
    key = engine.EXTRAS_KEYS.get(cfg.family)
    extras = None
    if key is not None:
        emb = torch.from_numpy(np.random.default_rng(3).normal(
            0, 1, (1, cfg.cross_len, cfg.d_model)).astype(np.float32))
        extras = lambda: {key: emb}                  # noqa: E731
    return cfg, params, extras


def _elementwise_flops(cfg, tokens, prompt):
    """The FLOPs the plain version computes elementwise, where
    ``FlopCounterMode`` sees no matrix product, written out from the
    shapes: the selective scan's state update (one multiply-add per state
    element a token and layer; its readout is a product the counter sees),
    and on a tick ``wkv6_step``'s k^T v update and readout (2 Dh^2
    multiply-adds a head; the prompt's chunked wkv is matrix products)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        return 2 * tokens * L * cfg.inner * cfg.ssm_state
    if cfg.family == "rwkv" and not prompt:
        return 4 * tokens * L * cfg.n_heads * cfg.d_head ** 2
    return 0


@pytest.mark.parametrize("stage", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(FAMILY_ARCHS))
def test_family_stage_counts_match_flop_counter(name, stage):
    """The dense adapter's (for rwkv the state slots') prefill of a
    16-token prompt and tick over 3 lanes of 24 positions: ``"analytic"``,
    the FLOPs within 10 % of ``FlopCounterMode`` over the plain version
    plus :func:`_elementwise_flops` and, for the SC frontend's prompt, the
    bit operations of the ``sc_dot`` call it really makes (an AND and an
    add per stream bit of every product, from the recorded shapes); the
    weights the counts read equal the parameter tree's elements."""
    cfg, params, extras = _family_setup(name)
    n, max_len, plen = 3, 24, 16
    ad = make_adapter(cfg, params, n_slots=n, max_len=max_len,
                      extras=extras)
    stages = ad.cost_args(prompt_len=plen)
    entry = obs.attribute(stages)["stages"][stage]
    assert entry["source"] == "analytic", name
    calls = []
    plain = ref.sc_dot

    def recorded(x, w, *a, **kw):
        calls.append((x.shape, w.shape))
        return plain(x, w, *a, **kw)
    with mock.patch.object(ref, "sc_dot", recorded):
        if stage == "prefill":
            kw = {} if extras is None else {
                k: v for k, v in extras().items()}
            counted = _flops(engine.prefill, cfg, params,
                             torch.zeros((1, plen), dtype=torch.int64), **kw)
            tokens = plen
        else:
            state = ad.state if cfg.family == "rwkv" else ad.cache
            counted = _flops(engine.decode_step, cfg, params, state,
                             torch.zeros((n, 1), dtype=torch.int64))
            tokens = n
    counted += _elementwise_flops(cfg, tokens, stage == "prefill")
    if name == "sc" and stage == "prefill":
        (M, K, _), (_, O, _) = calls[0]
        assert len(calls) == 1 and (M, K, O) == (plen, cfg.d_model,
                                                 2 * cfg.d_model)
        counted += 2 * M * K * O * (1 << cfg.sc_bits)
    else:
        assert not calls
    assert entry["flops"] == pytest.approx(counted, rel=0.1)
    w = costmodel.lm_weights(cfg)
    tree = sum(a.numel() for k, a in _leaves(params).items()
               if k != "embed" and not k.startswith("lm_head"))
    assert w["read"] + w["admit"] + w["sc"] == tree
    assert w["head"] == cfg.d_model * cfg.vocab_padded


def _leaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}{k}."))
        else:
            out[path + k] = v
    return out


def test_family_state_and_cross_bytes():
    """The terms only some families have, in bytes: a hybrid or rwkv
    lane's state read and written once a tick (the state tensors' own
    sizes), an encdec tick reading every lane's cross K/V once, an
    admission writing its cross K/V rows, the moe tick running every
    expert's capacity buffer of one routed group a lane."""
    for name in ("hybrid", "rwkv"):
        cfg, _, _ = _family_setup(name)
        st = engine.init_state(cfg, 1, "cpu")
        keys = ("conv", "ssm") if name == "hybrid" else engine.RWKV_KEYS
        assert costmodel.state_bytes(cfg) == sum(
            st[k].numel() * st[k].element_size() for k in keys)
        one = costmodel.lm_step_cost(*costmodel.lm_stage(
            cfg, costmodel.tick_work(cfg, 1, []))[1])
        two = costmodel.lm_step_cost(*costmodel.lm_stage(
            cfg, costmodel.tick_work(cfg, 2, []))[1])
        # a lane more: its embedding row, its logits and its state twice
        assert two["bytes"] - one["bytes"] == \
            2 * costmodel.state_bytes(cfg) + 4 * cfg.d_model \
            + 4 * cfg.vocab_padded + (costmodel.kv_row_bytes(cfg)
                                      * cfg.n_layers if name == "hybrid"
                                      else 0)
    cfg, params, extras = _family_setup("encdec")
    xk, _ = engine.encode_cross(cfg, params, extras()["enc_embed"])
    work = costmodel.tick_work(cfg, 3, [])
    assert work["cross_read"] == 3 * xk.shape[0] * xk.shape[2]
    admit = costmodel.admission_cost(cfg)
    assert admit["bytes"] - 4 * cfg.enc_len * cfg.d_model == \
        2 * xk.numel() * xk.element_size()
    cfg, _, _ = _family_setup("moe")
    work = costmodel.tick_work(cfg, 3, [])
    assert work["expert_rows"] == (cfg.n_layers - 1) * 3 * \
        cfg.n_experts * max(cfg.top_k, 4 * -(-int(
            cfg.top_k / cfg.n_experts * cfg.capacity_factor) // 4))

