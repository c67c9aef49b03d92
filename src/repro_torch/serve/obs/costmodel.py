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
the products are not counted.  The SC sensor stage counts the bit
operations of ``sc_dot`` (an AND and an add per stream bit of every
product, as the b1 tensor cores' rate is counted), and the packed streams
``sng_pack`` writes and ``sc_dot`` reads.  The counts cover the decoder
family and the frame path; the other families degrade to measured-only.

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

def _check_decoder(cfg) -> None:
    if cfg.family != "decoder" or cfg.first_layer_mode != "none":
        raise NotImplementedError(
            f"analytic counts cover the decoder family without the SC "
            f"frontend (family {cfg.family!r}, first_layer_mode "
            f"{cfg.first_layer_mode!r})")


def _windows(cfg) -> list[int]:
    """Each layer's attention window, 0 for a global layer."""
    from repro_torch.models.lm import layer_window
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


def lm_stage(cfg, counts: dict) -> tuple:
    """A ``cost_args()`` entry for an LM stage: :func:`lm_step_cost` over
    ``counts`` (its keyword arguments but ``cfg``)."""
    return lm_step_cost, (cfg, counts["tokens"], counts["pairs"],
                          counts["kv_read"], counts["kv_written"],
                          counts["logit_rows"])


def tick_work(cfg, lanes: int, contexts) -> dict:
    """The counts of a tick over ``lanes`` lanes whose attention reads
    ``contexts`` positions (one per lane that attends): every lane's
    products, logits and written row, and the K/V rows its attention
    reads, as many as its pairs."""
    pairs = tick_pairs(cfg, contexts)
    return {"tokens": lanes, "pairs": pairs, "kv_read": pairs,
            "kv_written": lanes * cfg.n_layers, "logit_rows": lanes}


def prompt_work(cfg, q0: int, c: int) -> dict:
    """The counts of a prompt chunk of ``c`` tokens at offset ``q0``: its
    pairs and K/V rows read, its rows written, the last token's logits."""
    pairs, rows = prompt_pairs(cfg, q0, c)
    return {"tokens": c, "pairs": pairs, "kv_read": rows,
            "kv_written": c * cfg.n_layers, "logit_rows": 1}


def lm_weights(cfg) -> dict:
    """Elements of the decoder family's weights a step reads: ``layer``
    (the matrices one token passes through in one layer), ``head`` (the
    vocabulary projection) and ``other`` (norms and biases of every
    layer); the embedding's rows are gathered per token."""
    _check_decoder(cfg)
    d, dh = cfg.d_model, cfg.d_head
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    mlp = d * cfg.d_ff * (3 if cfg.mlp_type == "swiglu" else 2)
    norm = d * (2 if cfg.norm_type == "layernorm" else 1)
    bias = (cfg.n_heads * dh + cfg.n_kv_heads * dh + d
            + (cfg.d_ff + d if cfg.mlp_type != "swiglu" else 0)) \
        if cfg.use_bias else 0
    return {"layer": attn + mlp, "head": d * cfg.vocab_padded,
            "other": cfg.n_layers * (2 * norm + bias) + norm}


def lm_step_cost(cfg, tokens: float, pairs: float, kv_read: float,
                 kv_written: float, logit_rows: float) -> dict:
    """FLOPs and bytes of one forward step of the decoder family over
    ``tokens`` rows (a tick's lanes, a chunk's or prompt's tokens):
    ``pairs`` query-key pairs of attention, ``kv_read`` / ``kv_written``
    K/V rows (each over all layers), ``logit_rows`` rows of float32
    logits."""
    w = lm_weights(cfg)
    isz = _ITEMSIZE[cfg.param_dtype]
    heads = cfg.n_heads * cfg.d_head
    flops = 2 * tokens * (cfg.n_layers * w["layer"]) \
        + 2 * logit_rows * w["head"] + 4 * heads * pairs
    row = kv_row_bytes(cfg)                               # one K and V row
    head_copy = 0 if isz == 4 or cfg.tie_embeddings else 8 * w["head"]
    nbytes = isz * (cfg.n_layers * w["layer"] + w["head"] + w["other"]) \
        + head_copy + isz * tokens * cfg.d_model \
        + row * (kv_read + kv_written) + 4 * logit_rows * cfg.vocab_padded
    return {"flops": flops, "bytes": nbytes}


def kv_row_bytes(cfg) -> int:
    """Bytes of one position's K and V rows in one layer: 2 Hkv Dh values
    of the model's dtype, or under ``kv_quant`` 2 Hkv (Dh + 4), the int8
    values and a float32 scale per head."""
    if cfg.kv_quant:
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
