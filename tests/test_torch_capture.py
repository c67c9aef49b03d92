"""The port's jit layer (``serve/capture.py``) on the CPU: the captured
steps' static buffers and counts, the gateway's and the paged adapter's
capture counts against the reference's jit cache sizes, the recompile
detector on both, the captured tick bit for bit a direct
``engine.decode_step_paged`` call, and the launch-counter bookkeeping of a
capture with a fake graph; the paged adapter's counts and the captured
tick also for the moe family (deepseek-moe-16b's smoke size), the
hybrid family (hymba-1.5b's, the lanes' state bit for bit) and the encdec
family (whisper-medium's with the reference tests' frames: the lanes'
cross K/V, written in place at each admission, so that a tick after a
re-admission reads the new ones).  The graphs themselves run only on a
card (``tests/test_torch_cuda.py``)."""
import contextlib

import numpy as np
import pytest
import torch

from repro.serve import obs as jobs
from repro.serve.gateway import frontend as jfe
from repro.serve.gateway import gateway as jgw
from repro.serve.gateway import sensors as jsensors
from repro.serve.gateway import slots as jslots
from repro.serve.kvcache import PagedKVSlotAdapter as JPagedKVSlotAdapter
from repro_torch import kernels
from repro_torch.kernels import paged_attn
from repro_torch.serve import capture, engine
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway import gateway as gw
from repro_torch.serve.gateway import sensors, slots
from repro_torch.serve.kvcache import paged
from repro_torch.serve.obs import RecompileDetector
from test_torch_lm import ENCDEC, HYMBA, MOE, extras_pair, frames, smoke_pair

# one intra-op thread: the suite's worker processes share the CPU
torch.set_num_threads(1)

BS = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    return smoke_pair()


@pytest.fixture(scope="module")
def moe_pair():
    return smoke_pair(arch=MOE)


@pytest.fixture(scope="module")
def hymba_pair():
    return smoke_pair(arch=HYMBA)


@pytest.fixture(scope="module")
def encdec_pair():
    return smoke_pair(arch=ENCDEC)


# -- CapturedStep ------------------------------------------------------------

def test_static_buffers_are_refilled_in_place_per_key():
    seen = []

    def fn(a, b):
        seen.append((a.data_ptr(), b.data_ptr()))
        return a.to(torch.float32) + b

    step = capture.CapturedStep(fn, CPU)
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = torch.full((2, 3), 0.5)
    torch.testing.assert_close(step(a, b), torch.from_numpy(a) + 0.5,
                               rtol=0, atol=0)
    torch.testing.assert_close(step(a + 1, b * 2),
                               torch.from_numpy(a + 1) + 1.0, rtol=0, atol=0)
    assert seen[0] == seen[1] and step._cache_size() == 1
    assert all(p % capture.ALIGN == 0 for p in seen[0])
    # a new shape is a new key; loading alone runs nothing and counts none
    static = step.load(np.zeros((4, 3), np.int32), torch.zeros(4, 3))
    assert [tuple(t.shape) for t in static] == [(4, 3), (4, 3)]
    assert static[0].dtype == torch.int32 and step._cache_size() == 1
    step(np.ones((4, 3), np.int32), torch.zeros(4, 3))
    assert step._cache_size() == 2 and len(seen) == 3
    # bool and uint8 arrays keep their values through the byte buffers
    mask = np.array([[True, False, True]])
    flag = capture.CapturedStep(lambda m: m.clone(), CPU)
    assert flag(mask).dtype == torch.bool
    np.testing.assert_array_equal(flag(mask).numpy(), mask)
    with pytest.raises(TypeError):
        step(a, 3)


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a capture records the pool
    and, with ``fail``, raises at its end as a failed capture does; a
    replay runs nothing."""
    fail = None

    def __init__(self):
        self.replays = 0
        self.pool = None

    def capture_begin(self, pool=None):
        self.pool = pool

    def capture_end(self):
        if self.fail is not None:
            raise self.fail

    def replay(self):
        self.replays += 1


def _fake_capture(monkeypatch, fail=None):
    """Route ``CapturedStep._capture`` on the CPU through ``_FakeGraph``."""
    monkeypatch.setattr(_FakeGraph, "fail", fail)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "fresh")


def test_counter_bookkeeping_with_a_fake_counted_function(monkeypatch):
    """The eager first call counts its launches; the capture records each
    counter's delta and takes it back; every replay adds it once."""
    wrap = paged_attn.paged_decode_attention_with_state
    for fn in (paged_attn.scatter_kv_rows, wrap):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(wrap, "fused_merges", wrap.fused_merges)

    def counted(x):                # a step that launches three kernels
        paged_attn.scatter_kv_rows.launches += 1
        wrap.launches += 2
        wrap.fused_merges += 2
        return x * 2

    step = capture.CapturedStep(counted, CPU)
    x = np.arange(4, dtype=np.int32)
    base = kernels.read_counts()
    step(x)
    eager = kernels.read_counts()
    want = {name: 0 for name in kernels.COUNTERS}
    want.update({"scatter_kv_rows": 1,
                 "paged_decode_attention_with_state": 2,
                 "merge_attn_states (fused)": 2})
    assert {k: eager[k] - base[k] for k in eager} == want
    _fake_capture(monkeypatch)
    entry, = step._entries.values()
    step._capture(entry)
    assert kernels.read_counts() == eager           # taken back
    assert entry.graph.pool is step.pool.handle is None
    assert entry.launches == want
    for i in range(3):
        out = step(x + i)
        assert out is entry.outputs                 # the static outputs
    assert entry.graph.replays == 3
    after = kernels.read_counts()
    assert {k: after[k] - eager[k] for k in after} == \
        {k: 3 * v for k, v in want.items()}
    assert step._cache_size() == 1


def test_failed_capture_raises_and_leaves_counts_and_keys(monkeypatch):
    monkeypatch.setattr(paged_attn.scatter_kv_rows, "launches", 0)

    def counted(x):
        paged_attn.scatter_kv_rows.launches += 1
        return x + 1

    pool = capture.GraphPool(CPU)
    step = capture.CapturedStep(counted, CPU, pool)
    step(np.zeros(3, np.int32))
    _fake_capture(monkeypatch, fail=RuntimeError("capture invalidated"))
    entry, = step._entries.values()
    with pytest.raises(RuntimeError, match="capture invalidated"):
        step._capture(entry)
    assert paged_attn.scatter_kv_rows.launches == 1
    assert step._cache_size() == 0 and not step._entries
    # the owner's steps move to a fresh pool
    assert step.pool is pool and pool.handle == "fresh"


# -- the frame gateway -------------------------------------------------------

def test_capture_collects_garbage_before_and_none_during(monkeypatch):
    """Garbage in reference cycles (a dropped owner's graphs) is collected
    just before a capture, and the cyclic collector stays off while ``fn``
    is captured (freeing a graph inside a capture invalidates it on a
    card); it is on again after, also when the capture fails."""
    import gc

    seen = []

    class Dropped:                 # an owner whose steps sit in a cycle
        def __init__(self):
            self.me = self

        def __del__(self):
            seen.append("collected")

    step = capture.CapturedStep(
        lambda x: seen.append(("capturing", gc.isenabled())) or x + 1, CPU)
    step(np.zeros(2, np.int32))
    seen.clear()
    Dropped()
    assert gc.isenabled()
    for fail in (None, RuntimeError("capture invalidated")):
        _fake_capture(monkeypatch, fail=fail)
        entry, = step._entries.values()
        if fail is None:
            step._capture(entry)
        else:
            with pytest.raises(RuntimeError):
                step._capture(entry)
        assert gc.isenabled()
    assert seen[:2] == ["collected", ("capturing", False)]
    assert seen[2:] == [("capturing", False)]


def _frame_trace(arrival, n, dt=0.001, start=0.0):
    """``tests/test_gateway.py``'s fixed-rate trace, for either package."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, size=(n, 28, 28, 1), dtype=np.uint8)
    return [arrival(uid=i, t=start + i * dt, endpoint=i % 4, kind="frame",
                    payload=frames[i]) for i in range(n)]


TRACES = ((1,), (7,), (23,), (5, 0.1))      # ragged + sparse arrivals


def test_gateway_compile_counts_match_reference():
    """2 captured steps per bucket after warmup, unchanged by traffic, equal
    to the reference's jit cache sizes on the same config
    (``tests/test_gateway.py::test_bucket_shapes_never_recompile``)."""
    kw = dict(bucket_sizes=(1, 2, 4), service_model="fixed",
              fixed_service_s=1e-4)
    port = gw.MicroBatchGateway(gw.GatewayConfig(**kw),
                                fe.FrontendSpec(mode="sc", bits=2),
                                device="cpu")
    ref = jgw.MicroBatchGateway(jgw.GatewayConfig(**kw),
                                jfe.FrontendSpec(mode="sc", bits=2))
    assert port.compile_counts() == {1: 0, 2: 0, 4: 0}
    port.warmup()
    ref.warmup()
    baseline = port.compile_counts()
    assert baseline == ref.compile_counts() == {1: 2, 2: 2, 4: 2}
    det = RecompileDetector()
    det.track("frames", port.jit_fns())
    det.snapshot()
    for args in TRACES:
        tel = port.run(_frame_trace(sensors.Arrival, *args))
        ref.run(_frame_trace(jsensors.Arrival, *args))
        assert len(tel.records) == args[0]
        assert port.compile_counts() == ref.compile_counts() == baseline
    assert det.steady_state_recompiles() == 0, det.report()
    assert det.report()["tracked_executables"] == 6


def test_jit_fns_keys_match_reference(pair):
    """The port names the reference's entry points, less those it runs
    eagerly or inside the cascade tick's graph (``NOT_CAPTURED``; the
    encoder's ``encode`` only for the encdec family)."""
    jcfg, jparams, cfg, params = pair
    jx, px = extras_pair(cfg)
    kw = dict(bucket_sizes=(1, 4))
    frames = gw.MicroBatchGateway(gw.GatewayConfig(**kw), fe.FrontendSpec(),
                                  device="cpu")
    jframes = jgw.MicroBatchGateway(jgw.GatewayConfig(**kw),
                                    jfe.FrontendSpec())
    assert list(frames.jit_fns()) == list(jframes.jit_fns()) == \
        ["sensor_b1", "gateway_b1", "sensor_b4", "gateway_b4"]
    for backend, jbackend in (("plain", "xla"), ("gather", "gather"),
                              ("cascade", "cascade")):
        port = paged.PagedKVSlotAdapter(cfg, params, 2, 16, block_size=BS,
                                        extras=px, backend=backend)
        ref = JPagedKVSlotAdapter(jcfg, jparams, 2, 16, block_size=BS,
                                  extras=jx, backend=jbackend)
        ours, theirs = set(port.jit_fns()), set(ref.jit_fns())
        assert ours <= theirs and not ours & set(paged.NOT_CAPTURED)
        assert theirs - ours <= set(paged.NOT_CAPTURED)
        assert all(isinstance(f, capture.CapturedStep)
                   for f in port.jit_fns().values())
        prompt = gw.PromptGateway(slots.ContinuousBatcher(port))
        jprompt = jgw.PromptGateway(jslots.ContinuousBatcher(ref))
        assert set(prompt.jit_fns()) == ours
        assert set(jprompt.jit_fns()) - ours <= set(paged.NOT_CAPTURED)
    encoded = set() if cfg.family == "encdec" else {"encode"}
    assert theirs - ours == set(paged.NOT_CAPTURED) - encoded  # cascade


def _prompt_arrivals(cfg, n, plen=8, seed=0, dt=0.001):
    rng = np.random.default_rng(seed)
    return [sensors.Arrival(t=i * dt, uid=i, endpoint=0, kind="prompt",
                            payload=rng.integers(0, cfg.vocab, plen)
                            .astype(np.int32)) for i in range(n)]


def test_prompt_gateway_zero_steady_state_recompiles(pair):
    """``tests/test_obs.py::test_gateway_jit_fns_zero_steady_state_
    recompiles`` on the port."""
    cfg, params = pair[2], pair[3]
    ad = slots.make_adapter(cfg, params, n_slots=2, max_len=16,
                            extras=extras_pair(cfg)[1], paged=True,
                            block_size=BS)
    prompt = gw.PromptGateway(slots.ContinuousBatcher(ad), max_new_tokens=3)
    prompt.warmup((8,))
    det = RecompileDetector()
    det.track("gateway", prompt.jit_fns())
    assert det.snapshot() == {"gateway.decode": 1}
    tel = prompt.run(_prompt_arrivals(cfg, 4))
    assert len(tel.records) == 4
    assert det.steady_state_recompiles() == 0, det.report()


def test_moe_prompt_gateway_zero_steady_state_recompiles(moe_pair):
    test_prompt_gateway_zero_steady_state_recompiles(moe_pair)


def test_hymba_prompt_gateway_zero_steady_state_recompiles(hymba_pair):
    test_prompt_gateway_zero_steady_state_recompiles(hymba_pair)


def test_encdec_prompt_gateway_zero_steady_state_recompiles(encdec_pair):
    test_prompt_gateway_zero_steady_state_recompiles(encdec_pair)


def test_encdec_jit_fns_keys_match_reference(encdec_pair):
    """The encdec adapters name the reference's entry points less
    ``NOT_CAPTURED``, ``encode`` among them (the encoder runs eagerly,
    once per admission)."""
    test_jit_fns_keys_match_reference(encdec_pair)


def test_encdec_capture_counts_match_reference_jit_caches(encdec_pair):
    """The same admissions and ticks through the port's and the
    reference's paged adapters: every captured step's keys equal the
    reference's jit cache entries of the same name, and the reference's
    one ``encode`` executable is the port's eager encoder, run once per
    admission (a prefix hit included)."""
    jcfg, jparams, cfg, params = encdec_pair
    jx, px = extras_pair(cfg)
    port = _shared(paged.PagedKVSlotAdapter(cfg, params, 4, 64, block_size=BS,
                                            extras=px, backend="cascade"),
                   cfg.vocab)
    ref = _shared(JPagedKVSlotAdapter(jcfg, jparams, 4, 64, block_size=BS,
                                      extras=jx, backend="cascade"),
                  jcfg.vocab)
    forced = np.random.default_rng(52).integers(0, cfg.vocab, 4
                                                ).astype(np.int32)
    for _ in range(3):
        np.testing.assert_array_equal(
            port.decode(forced, np.ones(4, bool)),
            np.asarray(ref.decode(forced, np.ones(4, bool))))
    theirs = ref.jit_fns()
    for name, step in port.jit_fns().items():
        assert step._cache_size() == theirs[name]._cache_size(), name
    assert theirs["encode"]._cache_size() == 1 and "encode" in \
        paged.NOT_CAPTURED and "encode" not in port.jit_fns()
    assert port.pool_stats()["prefill_tokens_skipped"] > 0


def test_recompile_detector_flags_a_new_key():
    """``tests/test_obs.py``'s detector test, on captured steps."""
    f = capture.CapturedStep(lambda x: x + 1, CPU)
    g = capture.CapturedStep(lambda x: x * 2, CPU)
    f(np.zeros(2, np.float32))
    g(np.zeros(2, np.float32))
    det = RecompileDetector()
    det.track("t", {"f": f, "g": g})
    with pytest.raises(RuntimeError):
        det.deltas()
    det.snapshot()
    f(np.ones(2, np.float32))                   # same key
    assert det.steady_state_recompiles() == 0
    f(np.zeros(3, np.float32))                  # a new shape: a capture
    assert det.steady_state_recompiles() == 1
    rep = det.report()
    assert rep["recompiles_by_fn"] == {"t.f": 1}
    assert rep["tracked_executables"] == 2
    with pytest.raises(TypeError):
        det.track("bad", {"plain": lambda x: x})


# -- the paged adapter --------------------------------------------------------

def _shared(ad, vocab, *, n_lanes=3, shared_len=5 * BS, tail=3, seed=11):
    """``tests/test_cascade.py``'s ``_shared_adapters`` admission."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=shared_len).tolist()
    for s in range(n_lanes):
        toks = shared + rng.integers(1, vocab, size=tail + s).tolist()
        ad.insert(s, np.asarray(toks, np.int32), max_new=8)
    ad.insert(n_lanes, rng.integers(1, vocab, size=shared_len // 2,
                                    dtype=np.int32), max_new=8)
    return ad


def test_cascade_bucket_crossing_counts_match_reference(pair):
    """``tests/test_cascade.py::test_cascade_meta_bucket_crossing_is_a_
    detectable_leak`` on both packages: the cascade tick's captured keys
    equal the reference's jit cache entries tick by tick, steady inside a
    bucket, one more when the suffix tables cross a pow2 bucket; the
    detector attributes it to ``decode_cascade``."""
    jcfg, jparams, cfg, params = pair
    port = _shared(paged.PagedKVSlotAdapter(cfg, params, 4, 64, block_size=BS,
                                            backend="cascade"), cfg.vocab)
    ref = _shared(JPagedKVSlotAdapter(jcfg, jparams, 4, 64, block_size=BS,
                                      backend="cascade"), jcfg.vocab)
    rng = np.random.default_rng(51)
    active = np.ones(4, bool)
    forced = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
    np.testing.assert_array_equal(port.decode(forced, active),
                                  np.asarray(ref.decode(forced, active)))
    assert port._decode_cascade._cache_size() == \
        ref._decode_cascade._cache_size() == 1
    det, jdet = RecompileDetector(), jobs.RecompileDetector()
    det.track("cascade", port.jit_fns())
    jdet.track("cascade", ref.jit_fns())
    det.snapshot()
    jdet.snapshot()
    sizes = []
    for tick in range(11):
        np.testing.assert_array_equal(port.decode(forced, active),
                                      np.asarray(ref.decode(forced, active)))
        assert port.last_groups == ref.last_groups == 1
        sizes.append(port._decode_cascade._cache_size())
        assert sizes[-1] == ref._decode_cascade._cache_size(), tick
        if tick < 3:
            assert det.steady_state_recompiles() == 0, det.report()
    assert sizes[-1] > sizes[0]
    assert det.steady_state_recompiles() >= 1
    assert det.deltas()["cascade.decode_cascade"] == \
        jdet.deltas()["cascade.decode_cascade"] >= 1
    assert det.deltas()["cascade.decode"] == 0


def test_hymba_cascade_bucket_crossing_counts_match_reference(hymba_pair):
    """The hybrid family's cascade tick: the same captured keys as the
    reference's jit cache entries, tick by tick."""
    test_cascade_bucket_crossing_counts_match_reference(hymba_pair)


def _direct_tick(ad, forced, active):
    """The tick's logits and arena from a direct
    ``engine.decode_step_paged`` call on a copy of the adapter's state."""
    arena = {k: a.clone() for k, a in ad.arena.items()}
    state = {k: a.clone() for k, a in ad.state.items()}
    wbids = np.zeros(ad.n_slots, np.int32)
    for s in np.nonzero(active)[0]:
        wbids[s] = ad.tables[s, int(ad.lens[s]) // ad.bs]
    groups = ad._cascade_plan(np.nonzero(active)[0]) \
        if ad.backend == "cascade" else []
    meta = {k: torch.from_numpy(v)
            for k, v in ad._cascade_meta(groups).items()} if groups else None
    logits = engine.decode_step_paged(
        ad.cfg, ad.params, torch.from_numpy(forced[:, None].copy()),
        tables=torch.from_numpy(ad.tables.copy()),
        lens=torch.from_numpy(ad.lens.astype(np.int32)), arena=arena,
        wbids=torch.from_numpy(wbids),
        backend="cascade" if groups else ad.flat_backend, cascade=meta,
        state=state or None,
        active=torch.from_numpy(active) if ad.hybrid else None)
    return logits, arena, state


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_captured_tick_bitwise_to_direct_decode_step(pair, backend):
    """Tokens, logits and the arena through the captured step equal a
    direct ``engine.decode_step_paged`` call on the same state bit for bit,
    and ``last_logits`` of a tick is unchanged by the next tick."""
    cfg, params = pair[2], pair[3]
    ad = _shared(paged.PagedKVSlotAdapter(cfg, params, 4, 48, block_size=BS,
                                          extras=extras_pair(cfg)[1],
                                          backend=backend), cfg.vocab)
    rng = np.random.default_rng(61)
    active = np.ones(4, bool)
    kept = None
    for _ in range(3):
        forced = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
        want, arena, state = _direct_tick(ad, forced, active)
        toks = ad.decode(forced, active)
        assert torch.equal(ad.last_logits, want)
        np.testing.assert_array_equal(toks, want.argmax(-1).numpy())
        for key in ad.seq_keys:
            assert torch.equal(ad.arena[key], arena[key])
        for key in ad.state:
            assert torch.equal(ad.state[key], state[key])
        if kept is not None:
            assert torch.equal(kept[0], kept[1])
        kept = (ad.last_logits, ad.last_logits.clone())
        assert backend == "plain" or ad.last_groups == 1
    step = ad._decode_cascade if backend == "cascade" else ad._decode
    assert step._cache_size() == 1
    assert tuple(ad._cascade_meta(ad._cascade_plan(range(4)))) == \
        paged.CASCADE_META


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_moe_captured_tick_bitwise_to_direct_decode_step(moe_pair, backend):
    test_captured_tick_bitwise_to_direct_decode_step(moe_pair, backend)


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_hymba_captured_tick_bitwise_to_direct_decode_step(hymba_pair,
                                                           backend):
    """The hybrid family: the lanes' state, a static buffer the captured
    tick writes in place, bit for bit the direct call's."""
    test_captured_tick_bitwise_to_direct_decode_step(hymba_pair, backend)


@pytest.mark.parametrize("backend", ["plain", "cascade"])
def test_encdec_captured_tick_bitwise_to_direct_decode_step(encdec_pair,
                                                            backend):
    """The encdec family: the captured tick reads the lanes' cross K/V, a
    static tensor of the adapter's, and leaves it as the direct call
    does."""
    test_captured_tick_bitwise_to_direct_decode_step(encdec_pair, backend)


@pytest.mark.parametrize("paged_slots", [True, False])
def test_encdec_tick_after_readmission_reads_the_new_cross_kv(encdec_pair,
                                                              paged_slots):
    """A slot whose cross K/V an earlier tick read is cleared and admitted
    again with other frames: the admission copies its cross K/V into the
    lane's tensors in place (the captured step's, whose addresses do not
    move), and the next tick is bit for bit the tick of an adapter that
    admitted those frames first."""
    cfg, params = encdec_pair[2], encdec_pair[3]
    enc_a = torch.from_numpy(frames(cfg))
    enc_b = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, tuple(enc_a.shape)).astype(np.float32))
    rng = np.random.default_rng(8)
    p0, p1, p2 = (rng.integers(0, cfg.vocab, n).astype(np.int32)
                  for n in (6, 9, 7))
    which = {"enc": enc_a}

    def make():
        return slots.make_adapter(
            cfg, params, n_slots=2, max_len=24,
            extras=lambda: {"enc_embed": which["enc"]}, paged=paged_slots,
            block_size=BS)
    ad = make()
    lane = ad.state if paged_slots else ad.cache
    ptrs = {k: lane[k].data_ptr() for k in engine.CROSS_KEYS}
    ad.insert(0, p0, max_new=6)
    ad.insert(1, p1, max_new=6)
    active = np.ones(2, bool)
    ad.decode(np.array([3, 4], np.int32), active)
    ad.clear(0)
    which["enc"] = enc_b
    tok = ad.insert(0, p2, max_new=6)
    got = ad.decode(np.array([tok, 5], np.int32), active)
    assert {k: lane[k].data_ptr() for k in engine.CROSS_KEYS} == ptrs
    fresh = make()
    assert fresh.insert(0, p2, max_new=6) == tok
    which["enc"] = enc_a
    fresh.insert(1, p1, max_new=6)
    fresh.decode(np.array([0, 4], np.int32), np.array([False, True]))
    want = fresh.decode(np.array([tok, 5], np.int32), np.array([True, True]))
    assert got[0] == want[0]
    assert torch.equal(ad.last_logits[0], fresh.last_logits[0])
    xk = lane["xk"]
    fresh_lane = fresh.state if paged_slots else fresh.cache
    assert torch.equal(xk[:, 0], fresh_lane["xk"][:, 0])
    assert not torch.equal(xk[:, 0], xk[:, 1])
