"""Per-stage cost/roofline attribution from analytic counts + spans.

The port of the reference's ``repro.serve.obs.costmodel``.  It joins two
sources:

  static   every serving component's ``cost_args()`` registry: per stage a
           count function and its arguments, ``(count, args)``, where
           ``count(*args)`` returns the stage's FLOPs and bytes per call,
           counted from the stage's shapes (the functions below).  The
           reference lowers each jitted entry point through XLA's
           ``cost_analysis()``; the port has no XLA, and its kernels are
           ``nvcc``-built libraries called through ``ctypes``, which no
           tracing FLOP counter sees;
  dynamic  the tracer's measured span durations for the stage's serving
           span (decode ``tick``, ``prefill_chunk`` folds, frame ``batch``
           steps).

Per stage the attributor reports arithmetic intensity (FLOPs/byte),
achieved FLOP/s and B/s over the measured spans, and a roofline verdict:
**compute-bound** when intensity clears the ridge point, **memory-bound**
below it.  ``source`` reads ``"analytic"`` where the reference writes
``"xla"``; the degradation ladder is the reference's: ``"bytes-only"`` (no
FLOP count; verdict from traffic alone) and ``"measured-only"`` (no count
at all, e.g. a family the counts do not cover; span timings still
attributed, verdict ``"unknown"``), never an obs-path crash.

How the counts count, as the kernels' bounds in PERF.md do: each input
read once, each output written once.  An LM step's FLOPs are its matrix
products (2 per multiply-add: the projections, the MLP and the vocabulary
head) plus its attention's score and value products (4 x heads x head
width per query-key pair); its bytes are every weight but the embedding
(the embedding's gathered rows instead), the float32 copy of the
vocabulary head that a bf16 model writes and reads, the K/V rows the
attention reads and writes, and the float32 logits.  Activations between
the products are not counted.  Each family adds its own terms
(:func:`family_work`): the moe family's routed experts over every
expert's capacity buffers (so every expert's weights are read every
step), the router and the dense layer 0; the hybrid family's SSM products,
its scan's multiply-adds and each lane's state read and written; the
encdec family's encoder and the cross K/V projections per admission and
the cross-attention over the lanes' cross K/V; the vlm family's cross
layers and the admission's vision K/V; the rwkv family's time and channel
mixes, the wkv's state work and each lane's state, with no K/V rows.  The
SC sensor stage and the LM's SC frontend count the bit operations of
``sc_dot`` (an AND and an add per stream bit of every product, as the b1
tensor cores' rate is counted), and the packed streams ``sng_pack``
writes and ``sc_dot`` reads.

:data:`DEFAULT_RIDGE` stays the reference's 0.6 F/B, which is calibrated on
XLA's per-op byte counts; analytic counts put a decode tick near
2 x lanes / bytes-per-weight F/B, so a caller on a card passes the card's
own ridge (``ridge=``): dense bf16 tensor peak over memory rate.

The energy cross-check (:func:`stage_energy`) re-folds the request spans'
``energy_parts`` into per-stage nJ totals; the grand total reproduces the
telemetry ledger's conserved ``fleet_energy_nj`` bitwise, because the span
stream carries the ledger's own addends in fold order.
"""
from __future__ import annotations

import math

from repro_torch.serve.obs.tracer import _bump

# the reference's roofline ridge point (FLOPs/byte), kept as its default;
# see the module docstring for the card's own
DEFAULT_RIDGE = 0.6

# stage base name -> the traced serving span whose measured durations the
# stage's cost attributes over (stages without one are static-only)
STAGE_SPANS = (
    ("decode", "tick"),
    ("chunk_fold", "prefill_chunk"),
    ("prefill", "prefill"),
    ("copy", "migrate"),
    ("sensor", "batch"),
    ("gateway", "batch"),
)

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def span_for(stage: str) -> str | None:
    """Serving span name for a ``cost_args()`` stage key (slice prefixes
    ``sliceN.`` and bucket suffixes ``_b8`` stripped)."""
    base = stage.rsplit(".", 1)[-1]
    for key, span in STAGE_SPANS:
        if base == key or base.startswith(key + "_"):
            return span
    return None


def analyze(fn, args) -> dict | None:
    """FLOPs + bytes per call of one stage, ``fn(*args)`` (a count function
    of ``cost_args()``), or None when it has nothing to say (it raises,
    returns no dict, or counts neither term): callers degrade, they never
    crash."""
    try:
        cost = fn(*args)
    except Exception:
        return None
    if not isinstance(cost, dict):
        return None
    flops = float(cost.get("flops", 0.0) or 0.0)
    nbytes = float(cost.get("bytes", 0.0) or 0.0)
    if flops <= 0.0 and nbytes <= 0.0:
        return None
    return {"flops": flops, "bytes": nbytes}


def attribute(stages: dict, tracer=None, *, ridge: float = DEFAULT_RIDGE,
              telemetry=None) -> dict:
    """Roofline-attribute every stage of a ``cost_args()`` registry.

    ``stages`` maps stage name -> ``(count_fn, args)``.  Returns
    ``{"stages": {name: entry}, "ridge_flops_per_byte": ...,
    "energy": ...}`` where each entry carries the static cost (per call),
    the measured span aggregate (count, seconds), the achieved rates, and
    the verdict + its provenance (``source``).  With a ``telemetry``
    ledger attached, the per-stage energy re-fold rides along.
    """
    _bump()
    out: dict = {"ridge_flops_per_byte": ridge, "stages": {}}
    for name, (fn, args) in stages.items():
        cost = analyze(fn, args)
        span = span_for(name)
        spans = tracer.spans(span) if tracer is not None and span else []
        calls = len(spans)
        measured_s = math.fsum(s["dur"] for s in spans)
        entry = {"span": span, "calls": calls, "measured_s": measured_s}
        if cost is None:
            entry.update(source="measured-only", flops=None, bytes=None,
                         intensity=None, verdict="unknown")
        else:
            flops, nbytes = cost["flops"], cost["bytes"]
            if flops > 0.0 and nbytes > 0.0:
                intensity = flops / nbytes
                entry.update(source="analytic", intensity=intensity,
                             verdict="compute-bound" if intensity >= ridge
                             else "memory-bound")
            else:
                # a byte count with no FLOP count still classifies: pure
                # traffic sits at intensity 0, under any ridge
                entry.update(source="bytes-only", intensity=0.0,
                             verdict="memory-bound")
            entry.update(flops=flops, bytes=nbytes)
            if measured_s > 0.0:
                entry["achieved_flops_per_s"] = flops * calls / measured_s
                entry["achieved_bytes_per_s"] = nbytes * calls / measured_s
        out["stages"][name] = entry
    if telemetry is not None and tracer is not None:
        out["energy"] = stage_energy(tracer, telemetry)
    return out


def stage_energy(tracer, telemetry=None) -> dict:
    """Per-stage nJ re-fold of the span stream's ``energy_parts``.

    Stage totals (``fsum`` per part key) answer "where did the energy
    go"; ``total_nj`` left-folds each request's parts in ledger order, so
    when a ``telemetry`` ledger is passed, ``conserved`` asserts the
    cross-check **bitwise** against ``fleet_energy_nj`` — per-stage
    attribution that doesn't re-fold to the conserved ledger means a path
    charged energy the ledger never saw.
    """
    _bump()
    parts_all: dict[str, list[float]] = {}
    total = 0.0
    n = 0
    for e in tracer.events:             # append order == ledger record order
        if e["ph"] != "X" or e["name"] != "request":
            continue
        parts = e["args"].get("energy_parts") or {}
        span_e = 0.0
        for k, v in parts.items():      # ledger fold order per request
            parts_all.setdefault(k, []).append(v)
            span_e += v
        total += span_e
        n += 1
    out = {"stages_nj": {k: math.fsum(v) for k, v in parts_all.items()},
           "total_nj": total, "n_requests": n}
    if telemetry is not None:
        out["fleet_energy_nj"] = telemetry.fleet_energy_nj
        out["conserved"] = total == telemetry.fleet_energy_nj
    return out


# ==========================================================================
# The analytic counts.
# ==========================================================================

def _windows(cfg) -> list[int]:
    """Each attention layer's window, 0 for a global layer, in the order
    ``lm.layers`` runs them: the moe family's dense layer 0 has none and its
    MoE blocks count from 0; the rwkv family has no attention layer."""
    from repro_torch.models.lm import layer_window
    if cfg.family == "rwkv":
        return []
    if cfg.family == "moe":
        return [0] + [layer_window(cfg, i) for i in range(cfg.n_layers - 1)]
    if cfg.family in ("encdec", "vlm"):
        return [0] * cfg.n_layers
    return [layer_window(cfg, i) for i in range(cfg.n_layers)]


def prompt_pairs(cfg, q0: int, c: int) -> tuple[int, int]:
    """A prompt chunk of ``c`` tokens at offset ``q0`` (``q0 = 0``: a whole
    prompt): (query-key pairs its causal attention scores, K/V rows it
    reads), each summed over the layers, within each layer's window."""
    a, b = q0 + 1, q0 + c          # the chunk's queries see a..b keys
    pairs = rows = 0
    for w in _windows(cfg):
        if not w or w >= b:
            pairs += (a + b) * c // 2
        elif w < a:
            pairs += c * w
        else:
            pairs += (a + w) * (w - a + 1) // 2 + (b - w) * w
        rows += (min(q0, w) if w else q0) + c
    return pairs, rows


def tick_pairs(cfg, contexts) -> int:
    """A decode tick: query-key pairs over the lanes' ``contexts`` (each
    lane's positions after its new row), summed over the layers, within
    each layer's window.  The K/V rows a flat tick reads are as many."""
    return sum(min(n, w) if w else n
               for w in _windows(cfg) for n in contexts)


# the terms every family's step has; the others are :func:`family_work`'s
STEP_KEYS = ("tokens", "pairs", "kv_read", "kv_written", "logit_rows")


def lm_stage(cfg, counts: dict) -> tuple:
    """A ``cost_args()`` entry for an LM stage: :func:`lm_step_cost` over
    ``counts`` (its keyword arguments but ``cfg``), the family's own terms
    as its last argument (empty for the decoder)."""
    extra = {k: v for k, v in counts.items() if k not in STEP_KEYS}
    return lm_step_cost, (cfg, *(counts[k] for k in STEP_KEYS), extra)


def _moe_rows(cfg, groups: int, group_tokens: int, dropless: bool) -> int:
    """Rows the routed experts run over in one MoE layer: every expert's
    whole capacity buffer of every dispatch group, as ``nn/moe.py`` runs
    them (E x groups x capacity), whatever the routing filled."""
    import dataclasses
    from repro_torch.nn import moe as moe_lib
    m = dataclasses.replace(cfg.moe, group_size=group_tokens,
                            dropless=dropless)
    return cfg.n_experts * groups * moe_lib.capacity(m, group_tokens)


def family_work(cfg, tokens: int, lanes: int, *, prompt: bool,
                admit: bool = False) -> dict:
    """The terms of a step that only some families have, over ``tokens``
    rows of ``lanes`` lanes (a tick: one row a lane; a prompt chunk: B =
    1): ``expert_rows`` (the routed experts' rows summed over the MoE
    layers: a tick routes each lane as its own group, a prompt as the
    prefill does), ``cross_pairs`` / ``cross_read`` (the cross-attention's
    query-key pairs and the cross K/V rows it reads, summed over the cross
    layers), ``admit`` (the admission's encoder or vision K/V projections:
    a prompt from offset 0), ``state_lanes`` (lanes whose recurrent state
    is read and written), ``wkv_chunk`` (the rwkv prompt's chunk, whose
    pairwise term the chunked wkv computes) and ``sc_tokens`` (rows through
    the SC frontend: prompts only, as ticks skip it)."""
    out: dict = {}
    if cfg.family == "moe":
        if prompt and cfg.moe_dropless_prefill:
            rows = _moe_rows(cfg, 1, tokens, True)
        elif prompt:
            gs = min(cfg.moe_group_size, tokens)
            rows = _moe_rows(cfg, tokens // gs, gs, False)
        else:
            rows = _moe_rows(cfg, lanes, 1, False)
        out["expert_rows"] = (cfg.n_layers - 1) * rows
    if cfg.n_cross:
        out["cross_pairs"] = tokens * cfg.cross_len * cfg.n_cross
        out["cross_read"] = lanes * cfg.cross_len * cfg.n_cross
        if admit:
            out["admit"] = 1
    if cfg.family in ("hybrid", "rwkv"):
        out["state_lanes"] = lanes
    if cfg.family == "rwkv" and prompt:
        out["wkv_chunk"] = min(cfg.rwkv_chunk, tokens)
    if cfg.first_layer_mode == "sc" and prompt:
        out["sc_tokens"] = tokens
    return out


def tick_work(cfg, lanes: int, contexts) -> dict:
    """The counts of a tick over ``lanes`` lanes whose attention reads
    ``contexts`` positions (one per lane that attends): every lane's
    products, logits and written row, and the K/V rows its attention
    reads, as many as its pairs; the family's own terms
    (:func:`family_work`)."""
    pairs = tick_pairs(cfg, contexts)
    return {"tokens": lanes, "pairs": pairs, "kv_read": pairs,
            "kv_written": lanes * len(_windows(cfg)), "logit_rows": lanes,
            **family_work(cfg, lanes, lanes, prompt=False)}


def prompt_work(cfg, q0: int, c: int) -> dict:
    """The counts of a prompt chunk of ``c`` tokens at offset ``q0``: its
    pairs and K/V rows read, its rows written, the last token's logits;
    the family's own terms (:func:`family_work`), the admission's with
    the chunk at offset 0."""
    pairs, rows = prompt_pairs(cfg, q0, c)
    return {"tokens": c, "pairs": pairs, "kv_read": rows,
            "kv_written": c * len(_windows(cfg)), "logit_rows": 1,
            **family_work(cfg, c, 1, prompt=True, admit=q0 == 0)}


def _attn(cfg) -> int:
    """One attention block's products: q, k, v and o."""
    d, dh = cfg.d_model, cfg.d_head
    return d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2


def _mlp(cfg, f: int) -> int:
    return cfg.d_model * f * (3 if cfg.mlp_type == "swiglu" else 2)


def _norm(cfg) -> int:
    return cfg.d_model * (2 if cfg.norm_type == "layernorm" else 1)


def _biases(cfg, f: int) -> int:
    """One block's biases under ``use_bias``: bq, bv, bo and, for a GELU
    MLP, b_in and b_out."""
    if not cfg.use_bias:
        return 0
    return cfg.n_heads * cfg.d_head + cfg.n_kv_heads * cfg.d_head \
        + cfg.d_model + (f + cfg.d_model if cfg.mlp_type != "swiglu" else 0)


def lm_weights(cfg) -> dict:
    """Elements of the weights of one family's step: ``token`` (the
    multiply-adds one token's products take over every layer, the routed
    experts and the vocabulary head aside), ``read`` (every weight a step
    reads but the embedding and the head: a MoE layer's every expert, as
    the routed FFN runs them all), ``head`` (the vocabulary projection),
    ``expert`` (the multiply-adds of one routed expert's row), ``admit``
    (the weights only an admission reads: the encoder and the cross K/V
    projections) and ``sc`` (the SC frontend's, which only prompts run).
    The embedding's rows are gathered per token."""
    from repro_torch.models.lm import FAMILIES, RWKV_LORA
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    d, dh, L = cfg.d_model, cfg.d_head, cfg.n_layers
    hd, kvd = cfg.n_heads * dh, cfg.n_kv_heads * dh
    attn, norm = _attn(cfg), _norm(cfg)
    block = attn + _mlp(cfg, cfg.d_ff)
    out = {"head": d * cfg.vocab_padded, "expert": 0, "admit": 0,
           "sc": d * d + d if cfg.first_layer_mode == "sc" else 0}
    bias = _biases(cfg, cfg.d_ff)
    if cfg.family == "decoder":
        token = L * block
        read = token + L * (2 * norm + bias)
    elif cfg.family == "moe":
        m = cfg.moe
        f0 = cfg.first_dense_ff or cfg.d_ff
        shared = 3 * d * m.n_shared * m.d_expert
        token = L * attn + _mlp(cfg, f0) + (L - 1) * (d * m.n_experts
                                                     + shared)
        out["expert"] = 3 * d * m.d_expert
        read = token + (L - 1) * m.n_experts * out["expert"] \
            + L * 2 * norm + _biases(cfg, f0) + (L - 1) * _biases(cfg, 0)
    elif cfg.family == "hybrid":
        di, N = cfg.inner, cfg.ssm_state
        dtr = cfg.dt_rank or max(16, d // 16)
        ssm = d * 2 * di + di * (dtr + 2 * N) + dtr * di + di * d
        token = L * (block + ssm)
        read = token + L * (4 * norm + bias + cfg.conv_k * di + 2 * di
                            + di * N + 2)
    elif cfg.family == "rwkv":
        proj = 4 * d * hd + hd * d + d * RWKV_LORA + RWKV_LORA * hd \
            + 2 * d * cfg.d_ff + d * d
        token = L * proj
        read = token + L * (2 * d + 7 * d + 3 * hd)
    else:                       # encdec, vlm: the cross layers' q and o
        G = cfg.n_cross
        xattn = 2 * d * hd
        token = L * block + G * xattn
        read = token + L * (2 * norm + bias) + G * (norm + 1) \
            + (G * (hd + d) if cfg.use_bias else 0)
        out["admit"] = G * 2 * d * kvd + (G * kvd if cfg.use_bias else 0)
        if cfg.family == "encdec":
            out["admit"] += cfg.enc_layers * (block + 2 * norm + bias) + norm
    out.update(token=token, read=read + norm)
    return out


def state_bytes(cfg) -> int:
    """One lane's recurrent state over every layer: the hybrid family's
    conv taps (K - 1, di) in the model's dtype and SSM state (di, N)
    float32; the rwkv family's wkv state (H, Dh, Dh) float32 and its two
    shift rows (d) in the model's dtype; 0 for the others."""
    isz = _ITEMSIZE[cfg.param_dtype]
    if cfg.family == "hybrid":
        return cfg.n_layers * ((cfg.conv_k - 1) * cfg.inner * isz
                               + cfg.inner * cfg.ssm_state * 4)
    if cfg.family == "rwkv":
        return cfg.n_layers * (cfg.n_heads * cfg.d_head ** 2 * 4
                               + 2 * cfg.d_model * isz)
    return 0


def scan_macs(cfg, wkv_chunk: int = 0) -> int:
    """A token's recurrent multiply-adds over every layer: the selective
    scan's state update and readout (2 di N a layer); the wkv's k^T v
    update and readout (2 Dh^2 a head), and in a prompt of chunk C the
    chunked form's pairwise scores and values (2 C Dh a head) and its
    bonus (Dh a head)."""
    if cfg.family == "hybrid":
        return cfg.n_layers * 2 * cfg.inner * cfg.ssm_state
    if cfg.family == "rwkv":
        dh = cfg.d_head
        per_head = 2 * dh * dh + (2 * wkv_chunk * dh + dh if wkv_chunk
                                  else 0)
        return cfg.n_layers * cfg.n_heads * per_head
    return 0


def admission_cost(cfg) -> dict:
    """An admission's cross K/V (encdec, vlm): FLOPs of the encoder over
    its ``enc_len`` frames (its products and its non-causal attention,
    ``enc_len`` squared pairs a layer) and of every cross layer's K and V
    projections over the ``cross_len`` frames or vision tokens; bytes of
    the input embeddings and the cross K/V rows written (the weights are
    :func:`lm_weights`' ``admit``)."""
    d, T = cfg.d_model, cfg.cross_len
    kvd = cfg.n_kv_heads * cfg.d_head
    isz = _ITEMSIZE[cfg.param_dtype]
    macs = T * cfg.n_cross * 2 * d * kvd
    pairs = 0
    if cfg.family == "encdec":
        macs += T * cfg.enc_layers * (_attn(cfg) + _mlp(cfg, cfg.d_ff))
        pairs = cfg.enc_layers * T * T
    return {"flops": 2 * macs + 4 * cfg.n_heads * cfg.d_head * pairs,
            "bytes": isz * T * d + T * cfg.n_cross * 2 * kvd * isz}


def sc_frontend_cost(cfg, tokens: int) -> dict:
    """The SC frontend over ``tokens`` prompt rows: ``sc_dot``'s bit
    operations (an AND and an add per stream bit of every product: K = d,
    both weight banks as O = 2 d columns, N = 2^bits) and the float32
    surrogate product the straight-through estimator runs; bytes of the
    packed streams ``sng_pack`` writes and ``sc_dot`` reads and of its
    int32 counts (the weights are :func:`lm_weights`' ``sc``)."""
    d = cfg.d_model
    M, K, O, N = tokens, d, 2 * d, 1 << cfg.sc_bits
    streams = 4 * max(1, N // 32) * K * (M + O)
    return {"flops": 2 * M * K * O * N + 2 * M * d * d,
            "bytes": 2 * streams + 4 * M * O}


def lm_step_cost(cfg, tokens: float, pairs: float, kv_read: float,
                 kv_written: float, logit_rows: float,
                 extra: dict | None = None) -> dict:
    """FLOPs and bytes of one forward step of any family over ``tokens``
    rows (a tick's lanes, a chunk's or prompt's tokens): ``pairs``
    query-key pairs of attention, ``kv_read`` / ``kv_written`` K/V rows
    (each over all layers), ``logit_rows`` rows of float32 logits, and the
    family's own terms ``extra`` (:func:`family_work`)."""
    x = extra or {}
    w = lm_weights(cfg)
    isz = _ITEMSIZE[cfg.param_dtype]
    heads = cfg.n_heads * cfg.d_head
    flops = 2 * tokens * (w["token"] + scan_macs(cfg, x.get("wkv_chunk", 0))) \
        + 2 * logit_rows * w["head"] + 4 * heads * pairs \
        + 2 * x.get("expert_rows", 0) * w["expert"] \
        + 4 * heads * x.get("cross_pairs", 0)
    row = kv_row_bytes(cfg)                               # one K and V row
    head_copy = 0 if isz == 4 or cfg.tie_embeddings else 8 * w["head"]
    nbytes = isz * (w["read"] + w["head"]) \
        + head_copy + isz * tokens * cfg.d_model \
        + row * (kv_read + kv_written) + 4 * logit_rows * cfg.vocab_padded \
        + 2 * cfg.n_kv_heads * cfg.d_head * isz * x.get("cross_read", 0) \
        + 2 * state_bytes(cfg) * x.get("state_lanes", 0)
    terms = []
    if x.get("admit"):
        terms.append((admission_cost(cfg), w["admit"]))
    if x.get("sc_tokens"):
        terms.append((sc_frontend_cost(cfg, x["sc_tokens"]), w["sc"]))
    for cost, weights in terms:
        flops += cost["flops"]
        nbytes += cost["bytes"] + isz * weights
    return {"flops": flops, "bytes": nbytes}


def kv_row_bytes(cfg) -> int:
    """Bytes of one position's K and V rows in one layer: 2 Hkv Dh values
    of the model's dtype, or under ``kv_quant`` 2 Hkv (Dh + 4), the int8
    values and a float32 scale per head (the decoder, moe and hybrid
    families: the others keep the model's dtype, as ``engine.quantized``
    says)."""
    if cfg.kv_quant and cfg.family in ("decoder", "moe", "hybrid"):
        return 2 * cfg.n_kv_heads * (cfg.d_head + 4)
    return 2 * cfg.n_kv_heads * cfg.d_head * _ITEMSIZE[cfg.param_dtype]


def block_copy_cost(cfg, block_size: int) -> dict:
    """A copy-on-write block copy: one block's K and V rows of every layer
    read and written; no arithmetic."""
    rows = cfg.n_layers * block_size
    return {"flops": 0.0, "bytes": 2 * rows * kv_row_bytes(cfg)}


def frame_sensor_cost(spec, bs: int) -> dict:
    """The at-sensor stage of a bucket of ``bs`` frames.  SC: the bit
    operations of ``sc_dot`` (an AND and an add per stream bit of every
    window x weight product); bytes: the uint8 frames, the float32 conv1
    weights, the packed streams ``sng_pack`` writes and ``sc_dot`` reads,
    its int32 counts, and the payload.  Binary: a pass-through, no work."""
    c = spec.lenet
    if spec.mode != "sc":
        return {"flops": 0.0, "bytes": 0.0}
    # sc_dot's windows, window length, outputs (both weight banks as one
    # operand) and stream bits
    M, K = bs * c.image_size ** 2, c.ksize ** 2 * c.channels
    O, N = 2 * c.conv1_filters, 1 << spec.bits
    words = max(1, N // 32)
    streams = 4 * words * K * (M + O)
    payload = bs * -(-2 * (c.image_size // 2) ** 2 * c.conv1_filters // 8)
    nbytes = bs * c.image_size ** 2 * c.channels + 4 * K * O // 2 \
        + 2 * streams + 4 * M * O + payload
    return {"flops": 2 * M * K * O * N, "bytes": nbytes}


def frame_gateway_cost(spec, bs: int) -> dict:
    """The host stage of a bucket of ``bs`` frames: conv2 (5 x 5, SAME) on
    the pooled conv1 features, the two dense layers, and for the binary
    partition conv1 as a matrix product; bytes: the payload, the float32
    weights and the float32 logits."""
    c = spec.lenet
    k2 = c.ksize ** 2
    half, quarter = (c.image_size // 2) ** 2, (c.image_size // 4) ** 2
    flat = quarter * c.conv2_filters
    macs = bs * (half * c.conv2_filters * k2 * c.conv1_filters
                 + flat * c.dense + c.dense * c.classes)
    weights = k2 * c.conv1_filters * c.conv2_filters + c.conv2_filters \
        + flat * c.dense + c.dense + c.dense * c.classes + c.classes
    if spec.mode == "sc":
        payload = bs * -(-2 * half * c.conv1_filters // 8)
    else:
        macs += bs * c.image_size ** 2 * k2 * c.channels * c.conv1_filters
        weights += k2 * c.channels * c.conv1_filters
        payload = bs * c.image_size ** 2 * c.channels
    return {"flops": 2 * macs,
            "bytes": payload + 4 * weights + 4 * bs * c.classes}
