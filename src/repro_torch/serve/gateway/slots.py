"""Continuous batching over slot adapters: the request record, the state
slots, the dense KV slots, the adapter factory and the family-agnostic
scheduler loop.

What differs between the families is only how a slot's context is stored.
:class:`StateSlotAdapter` serves the rwkv family, whose whole context is
an O(1) recurrent state: admission is one prefill written into the slot.
The decoder, moe, hybrid, encdec and vlm families keep K/V:
:class:`KVSlotAdapter`, each slot a dense cache of ``max_len`` positions
with its own length (the reference's default), or the paged KV slots
(``serve/kvcache/paged.py``), with chunked or one-shot prefill.

Every adapter masks its tick's state writes with the active-slot mask, so
a freed slot keeps what ``clear`` left: :class:`StateSlotAdapter` zeroes
the slot's state, the KV adapters reset its length to 0.

The batcher discovers paging hooks by presence: ``can_admit`` (queue while
the pool cannot cover a request's worst-case block demand),
``validate_request`` (reject at submit what could never fit),
``at_capacity`` (retire a lane whose context filled every block) and
``slot_stats`` (per-request block accounting stamped onto the Request).
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.dist.sharding import Mesh, slice_mesh
from repro_torch.models.lm import LMConfig
from repro_torch.serve import capture, engine
from repro_torch.serve.kvcache.pool import PoolExhausted
from repro_torch.serve.obs import costmodel


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    generated: list = dataclasses.field(default_factory=list)
    # paged-adapter accounting, stamped at retire
    kv_blocks: int = 0
    prefix_hit_blocks: int = 0
    # prompt tokens whose prefill was skipped via a prefix-cache resume
    prefill_tokens_skipped: int = 0
    # cross-slice migration accounting (sharded gateway, a later slice)
    migrations: int = 0
    migration_bytes: int = 0
    # virtual-clock stamps (-1 = untracked): when the request left the
    # pending queue for a slot, and when its prefill produced the first
    # token — stamped by the batcher when it has a clock
    t_dequeue: float = -1.0
    t_admit: float = -1.0

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated and \
                self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens


def extras_kwargs(cfg: LMConfig, extras, device: torch.device) -> dict:
    """The keywords ``engine.prefill`` takes from an adapter's ``extras``
    callable, the reference's per-family modality stub: the frame
    embeddings ``{"enc_embed": (1, enc_len, d)}`` of the encdec family and
    the patch embeddings ``{"vision_embed": (1, n_vision_tokens, d)}`` of
    the vlm family that it returns (numpy or a tensor), on ``device``;
    nothing for the other families, which take none."""
    key = engine.EXTRAS_KEYS.get(cfg.family)
    if key is None:
        return {}
    return {key: torch.as_tensor(extras()[key], device=device)}


def check_extras(cfg: LMConfig, extras) -> None:
    """The encdec and vlm families need ``extras``; the other families
    take none."""
    key = engine.EXTRAS_KEYS.get(cfg.family)
    if (extras is None) == (key is not None):
        raise ValueError(f"extras= (a callable returning the frame "
                         f"embeddings {{'enc_embed': (1, enc_len, d)}} or "
                         f"the patch embeddings {{'vision_embed': (1, "
                         f"n_vision_tokens, d)}}) is required for the "
                         f"encdec and vlm families and taken by no other "
                         f"(family {cfg.family!r})")


def _dense_tick(cfg, params, cache, tokens, active):
    """The dense and state ticks' captured body: :func:`engine.decode_step`
    with the active-lane mask."""
    return engine.decode_step(cfg, params, cache, tokens, active)[1]


class _CapturedTick:
    """The tick of the state and dense KV slots: one captured step,
    ``self._decode``, over every lane, with the tokens and the active
    mask as its host inputs."""

    def _tick_inputs(self, tokens: np.ndarray, active: np.ndarray
                     ) -> tuple[capture.CapturedStep, tuple, np.ndarray]:
        """The tick's captured step, its host inputs (tokens (n_slots, 1)
        int32 and the active mask) and the lanes that write."""
        active = np.asarray(active, bool)
        return self._decode, (np.asarray(tokens, np.int32)[:, None],
                              active), active

    def decode(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One tick over every lane; returns the greedy token per lane
        (garbage for inactive lanes).  ``last_logits`` is this tick's
        (n_slots, vocab_padded) float32 logits, a copy that later ticks
        leave as it is."""
        step, inputs, _ = self._tick_inputs(tokens, active)
        # the step's output is overwritten by its next replay
        self.last_logits = step(*inputs).clone()
        return self.last_logits.argmax(-1).cpu().numpy()

    def jit_fns(self) -> dict[str, capture.CapturedStep]:
        """Named captured steps, for ``obs.RecompileDetector.track``: the
        reference's ``decode``; its ``prefill`` runs eagerly here."""
        return {"decode": self._decode}


class StateSlotAdapter(_CapturedTick):
    """State slots for the rwkv family: the state holds ``len``
    (n_slots,) int32, wkv (L, n_slots, H, Dh, Dh) float32 and shift1 /
    shift2 (L, n_slots, d) in the model's dtype, on the params' device
    (``max_len`` is None: the state is O(1) in the context).  ``insert``
    prefills one prompt (B=1, one-shot: S must be at most ``rwkv_chunk``
    or a multiple of it, else ``ValueError``) and writes its length and
    state into the slot in place; ``clear`` zeroes the slot's length and
    state; ``decode`` runs one batched tick over every lane
    (:func:`engine.decode_step`), in which an inactive lane's length and
    state stay as they were.

    The tick is one captured step (``serve/capture.py``) over fixed
    ``(n_slots,)`` shapes, the reference's jitted ``decode``; its inputs
    are the tokens and the active mask, copied from pinned memory, and the
    masked state write happens inside it.  Prefill runs eagerly, as in the
    KV adapters (``paged.NOT_CAPTURED``)."""

    STATE_KEYS = engine.RWKV_KEYS

    def __init__(self, cfg: LMConfig, params: dict, n_slots: int):
        if cfg.family != "rwkv":
            raise ValueError(f"state slots serve the rwkv family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = None                 # O(1) state: no length cap
        if self.device.type == "cuda":
            # float32 matrix products in full float32, as the reference
            # computes them
            torch.backends.cuda.matmul.allow_tf32 = False
        self.state = {"len": torch.zeros(n_slots, dtype=torch.int32,
                                         device=self.device),
                      **engine.init_state(cfg, n_slots, self.device)}
        self.last_logits = None
        self.last_prefill_logits = None     # the latest insert's logits
        self._decode = capture.CapturedStep(
            functools.partial(_dense_tick, cfg, params, self.state),
            self.device)

    def insert(self, slot: int, prompt: np.ndarray,
               max_new: int | None = None) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first generated
        token."""
        tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None]
                                  ).to(self.device)
        cache1, logits = engine.prefill(self.cfg, self.params, tokens)
        # in place: the captured tick reads these very tensors
        self.state["len"][slot] = cache1["len"]
        for key in self.STATE_KEYS:
            self.state[key][:, slot] = cache1[key][:, 0]
        self.last_prefill_logits = logits
        return int(logits[0].argmax())

    def clear(self, slot: int) -> None:
        self.state["len"][slot] = 0
        for key in self.STATE_KEYS:
            self.state[key][:, slot] = 0

    def cost_args(self, prompt_len: int = 8) -> dict[str, tuple]:
        """The prefill and the tick with their analytic counts, for
        ``obs.costmodel``: a ``prompt_len``-token prompt and a tick over
        every lane, each reading and writing the lanes' state; there are
        no K/V rows."""
        cfg, n = self.cfg, self.n_slots
        return {"prefill": costmodel.lm_stage(
                    cfg, costmodel.prompt_work(cfg, 0, prompt_len)),
                "decode": costmodel.lm_stage(
                    cfg, costmodel.tick_work(cfg, n, []))}


class KVSlotAdapter(_CapturedTick):
    """Dense KV slots, each lane's length its own: the cache holds k/v
    (L, n_slots, max_len, Hkv, Dh), ``len`` (n_slots,) and the lane state
    (the hybrid family's recurrent state, conv / ssm, (L, n_slots, ...);
    the encdec and vlm families' cross K/V, xk / xv, (n_cross, n_slots,
    ...)), on the params' device; under ``kv_quant`` (the decoder, moe
    and hybrid families) k/v int8 beside k_scale / v_scale (L, n_slots,
    max_len, Hkv, 1) float32.  ``insert`` prefills one prompt (B=1,
    one-shot; for the encdec and vlm families with the embeddings
    ``extras()`` returns) and writes its rows and
    state into the slot in place, the rest of the slot zeros as the
    reference's padded write leaves it; ``clear`` sets the slot's length to
    0 (its rows and state stay, stale but unread); ``decode`` runs one
    batched tick over every lane (:func:`engine.decode_step`), in which an
    inactive lane's rows, state and length stay as they were.

    The tick is one captured step (``serve/capture.py``) over fixed
    ``(n_slots, max_len)`` shapes, the reference's jitted ``decode``; its
    inputs are the tokens and the active mask, copied from pinned memory.
    Prefill runs eagerly, as in the paged adapter (``paged.NOT_CAPTURED``).
    """

    # cache keys whose axis -3 is the sequence axis (k / v, and their
    # scales under kv_quant)
    SEQ_KEYS = engine.PAGED_SEQ_KEYS

    def __init__(self, cfg: LMConfig, params: dict, n_slots: int,
                 max_len: int, extras=None):
        if cfg.family == "rwkv":
            raise ValueError("the rwkv family has no K/V: use "
                             "StateSlotAdapter")
        check_extras(cfg, extras)
        self.cfg = cfg
        self.extras = extras
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        if self.device.type == "cuda":
            # float32 matrix products in full float32, as the reference
            # computes them (TF32 would keep about three digits)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cache = engine.init_cache(cfg, n_slots, max_len, self.device)
        self.cache["len"] = torch.zeros(n_slots, dtype=torch.int32,
                                        device=self.device)
        self.last_logits = None
        self.last_prefill_logits = None     # the latest insert's logits
        self._decode = capture.CapturedStep(
            functools.partial(_dense_tick, cfg, params, self.cache),
            self.device)

    def insert(self, slot: int, prompt: np.ndarray,
               max_new: int | None = None) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first generated
        token."""
        P = len(prompt)
        if P > self.max_len:
            raise ValueError(f"prompt length {P} exceeds slot capacity "
                             f"{self.max_len}")
        tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None]
                                  ).to(self.device)
        cache1, logits = engine.prefill(
            self.cfg, self.params, tokens,
            **extras_kwargs(self.cfg, self.extras, self.device))
        for key in self.SEQ_KEYS:
            if key not in self.cache:
                continue
            self.cache[key][:, slot, :P] = cache1[key][:, 0]
            self.cache[key][:, slot, P:] = 0
        # in place: the captured tick reads these very tensors
        for key in engine.STATE_KEYS + engine.CROSS_KEYS:
            if key in self.cache:
                self.cache[key][:, slot] = cache1[key][:, 0]
        self.cache["len"][slot] = P
        self.last_prefill_logits = logits
        return int(logits[0].argmax())

    def clear(self, slot: int) -> None:
        # length 0 masks the slot: nothing reads past ``len``, and the next
        # admission overwrites every row
        self.cache["len"][slot] = 0

    def cost_args(self, prompt_len: int = 8) -> dict[str, tuple]:
        """The prefill and the tick with their analytic counts, for
        ``obs.costmodel``: a ``prompt_len``-token prompt (the reference's
        representative argument), and a tick whose attention reads every
        lane's whole ``max_len`` cache, as the dense tick does."""
        cfg, n = self.cfg, self.n_slots
        return {"prefill": costmodel.lm_stage(
                    cfg, costmodel.prompt_work(cfg, 0, prompt_len)),
                "decode": costmodel.lm_stage(
                    cfg, costmodel.tick_work(cfg, n, [self.max_len] * n))}


def params_on(params: dict, device: torch.device) -> dict:
    """``params`` on ``device``: the same tree when they already live
    there, else a copy."""
    if params["embed"].device == device:
        return params

    def move(tree: dict) -> dict:
        return {k: move(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}
    return move(params)


def make_adapter(cfg: LMConfig, params: dict, n_slots: int,
                 max_len: int = 128, extras=None, *, paged: bool = False,
                 block_size: int = 16, num_blocks: int | None = None,
                 chunked: bool = True, backend: str | None = None,
                 device: str | torch.device | None = None, mesh=None):
    """The slot adapter for ``cfg``, on ``device`` (None: where ``params``
    live; else the params are copied there unless they already are), or
    placed on ``mesh``, a serving slice's ``("model",)`` sub-mesh or list
    of devices (the sharded-serving entry point, paged only, not for the
    rwkv family: ``ValueError``): the params on its first device and the
    paged arena split over its devices (``engine.arena_specs``; one device
    is exactly the ``device=`` path).  For the rwkv family the state slots
    (:class:`StateSlotAdapter`, whatever ``paged`` is: its O(1) state has
    nothing to page; ``backend`` raises ``ValueError``); for the decoder,
    moe, hybrid, encdec or vlm family (the last two with ``extras``, a
    callable returning ``{"enc_embed": (1, enc_len, d)}`` or
    ``{"vision_embed": (1, n_vision_tokens, d)}`` for each admission, as
    the reference's): dense KV slots (:class:`KVSlotAdapter`, the
    default), or with ``paged=True`` the paged KV slots, admitting prompts through the chunked prefill fold
    (``chunked=True``, prefix hits skip their compute) or one-shot
    (``chunked=False``, storage-only prefix sharing; the vlm family is
    always admitted one-shot); ``backend`` (paged only) picks the decode
    tick's attention ("plain" | "cuda" | "cascade", the last grouping
    lanes over shared prefix chains, or "gather", the gather-tick oracle;
    None: "cuda" on a CUDA device, else "plain"; for the vlm family
    "plain" or "gather" only, None giving "plain")."""
    if mesh is not None:
        if not paged or cfg.family == "rwkv":
            # an unplaced adapter would defeat the sharding silently: only
            # the paged attention families commit their arena to a slice
            raise ValueError("mesh placement requires paged=True and a "
                             f"non-rwkv family (got paged={paged}, "
                             f"family={cfg.family})")
        if device is not None:
            raise ValueError("give the slice's devices as mesh= or one "
                             "device as device=, not both")
        mesh = slice_mesh(mesh)
        mesh = Mesh(np.asarray([resolve_device(d) for d in mesh.device_list],
                               object), mesh.axis_names)
        device = mesh.device_list[0]
    if device is not None:
        params = params_on(params, resolve_device(device))
    if cfg.family == "rwkv":
        if backend is not None:
            raise ValueError(f"backend={backend!r} selects the paged decode "
                             "tick's attention; the rwkv family has no "
                             "attention and nothing to page")
        check_extras(cfg, extras)
        return StateSlotAdapter(cfg, params, n_slots)
    if not paged:
        if backend is not None:
            raise ValueError(f"backend={backend!r} selects the paged decode "
                             "tick's attention; it requires paged=True")
        return KVSlotAdapter(cfg, params, n_slots, max_len, extras)
    from repro_torch.serve.kvcache.paged import PagedKVSlotAdapter
    return PagedKVSlotAdapter(cfg, params, n_slots, max_len,
                              block_size=block_size, num_blocks=num_blocks,
                              extras=extras, chunked=chunked,
                              backend=backend, mesh=mesh)


class ContinuousBatcher:
    """vLLM-style continuous batching over a slot adapter.

    Flow per step():
      1. admit: for each free slot, pop a pending request, prefill (B=1) and
         scatter its context into the slot; a request whose prefill token
         already finishes it (EOS or a 1-token budget) retires immediately
         without occupying the slot;
      2. decode: one batched decode over all slots;
      3. retire: finished requests free their slot.
    """

    def __init__(self, adapter):
        self.adapter = adapter
        self.n_slots = adapter.n_slots
        self.pending: deque[Request] = deque()
        self.active: list[Request | None] = [None] * self.n_slots
        self.last_token = np.zeros((self.n_slots,), np.int32)
        self.peak_active = 0            # max concurrent slots ever decoded
        self.last_active = 0            # slots decoding in the latest step
        # observability hooks (serve/obs/), wired by the prompt gateway for
        # the length of a run; all None by default and every use is
        # guarded, so a bare batcher makes zero obs calls
        self.clock = None               # SimClock for t_dequeue/t_admit
        self.tracer = None              # span recorder
        self.trace_pid = 1              # engine track

    def submit(self, req: Request):
        if self.adapter.max_len is not None and \
                len(req.prompt) + req.max_new_tokens > self.adapter.max_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds slot capacity "
                f"{self.adapter.max_len}")
        validate = getattr(self.adapter, "validate_request", None)
        if validate is not None:        # paged: whole-pool capacity bound
            validate(len(req.prompt), req.max_new_tokens)
        self.pending.append(req)

    def _admissible(self, req: Request) -> bool:
        can = getattr(self.adapter, "can_admit", None)
        return can is None or can(req.prompt, req.max_new_tokens)

    def _stamp_stats(self, slot: int, req: Request) -> None:
        stats = getattr(self.adapter, "slot_stats", None)
        if stats is not None:
            st = stats(slot)
            req.kv_blocks = st.get("kv_blocks", 0)
            req.prefix_hit_blocks = st.get("prefix_hit_blocks", 0)
            req.prefill_tokens_skipped = st.get("prefill_tokens_skipped", 0)

    @property
    def busy(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.active)

    def debug_state(self) -> dict:
        """Occupancy snapshot for incident bundles (serve/obs/incident.py):
        queue depth and per-slot uids only, never prompt or token payloads,
        so a bundle can leave the machine."""
        return {
            "n_slots": self.n_slots,
            "pending": len(self.pending),
            "pending_uids": [r.uid for r in list(self.pending)[:16]],
            "active_uids": [None if r is None else r.uid
                            for r in self.active],
            "last_active": self.last_active,
            "peak_active": self.peak_active,
        }

    def _now(self) -> float:
        """Virtual time for the stamps: the tracer's clock when tracing,
        the bare clock when only stamping, -1 (untracked) otherwise."""
        if self.tracer is not None:
            return self.tracer.now()
        if self.clock is not None:
            return self.clock.t
        return -1.0

    def _retire_trace(self, req: Request, reason: str) -> None:
        if self.tracer is not None and \
                self.tracer.innermost(tid=req.uid) == "decode":
            self.tracer.end("decode", tid=req.uid,
                            args={"tokens": len(req.generated),
                                  "retire": reason})

    def _end_tick(self, **args) -> None:
        """Close the ``tick`` span once the tick's device work is done: the
        span measures the work, not its issue.  Called only when a tracer
        is attached, so an untraced tick adds no synchronize."""
        synchronize(self.adapter.device)
        self.tracer.end("tick", pid=self.trace_pid, tid=0, args=args)

    def step(self, decode: bool = True) -> list[Request]:
        """Admit + one decode tick.  Returns requests completed this tick.
        The ``tick`` span wraps the captured tick from outside (an obs call
        inside a captured step would run only at its capture).

        ``decode=False`` is the prefill role of disaggregated serving
        (``serve/shard/``): admit pending requests and retire at-capacity /
        EOS-at-prefill lanes, but skip the tick; admitted lanes keep their
        prefill token staged in ``last_token`` until the router hands them
        to a decode slice."""
        tr = self.tracer
        if tr is not None:
            tr.begin("tick", pid=self.trace_pid, tid=0)
        finished: list[Request] = []
        stalled = False                 # FIFO: head can't admit -> stop
        for slot in range(self.n_slots):
            while self.active[slot] is None and self.pending and not stalled:
                if not self._admissible(self.pending[0]):
                    stalled = True      # blocks free up as requests retire
                    break
                req = self.pending.popleft()
                req.t_dequeue = self._now()
                if tr is not None:
                    if tr.innermost(tid=req.uid) != "queue_wait":
                        # submitted before the tracer was wired: open the
                        # lifecycle late so the rest of it is traced
                        tr.begin("request", tid=req.uid,
                                 args={"late_open": True})
                        tr.begin("queue_wait", tid=req.uid)
                    tr.end("queue_wait", tid=req.uid)
                    tr.begin("prefill", tid=req.uid,
                             args={"prompt_len": len(req.prompt)})
                    tr.set_ctx(req.uid)
                try:
                    tok = self.adapter.insert(
                        slot, np.asarray(req.prompt, np.int32),
                        max_new=req.max_new_tokens)
                except PoolExhausted:
                    # insert rolled its allocations back; requeue at the
                    # head (can_admit makes this unreachable, but admission
                    # must degrade to queueing, never to a crashed loop)
                    self.pending.appendleft(req)
                    stalled = True
                    if tr is not None:
                        tr.end("prefill", tid=req.uid,
                               args={"admitted": False})
                        tr.begin("queue_wait", tid=req.uid)
                    break
                req.t_admit = self._now()
                if tr is not None:
                    tr.end("prefill", tid=req.uid, args={"slot": slot})
                req.generated.append(tok)
                if req.done:            # EOS fired on the prefill token
                    self._stamp_stats(slot, req)
                    self.adapter.clear(slot)
                    finished.append(req)
                    continue
                if tr is not None:
                    tr.begin("decode", tid=req.uid)
                self.active[slot] = req
                self.last_token[slot] = tok
        # a slot whose context filled every KV block cannot take another
        # token — surface it as finished
        cap = getattr(self.adapter, "at_capacity", None)
        if cap is not None:
            for slot, req in enumerate(self.active):
                if req is not None and cap(slot):
                    self._stamp_stats(slot, req)
                    self._retire_trace(req, "at_capacity")
                    finished.append(req)
                    self.active[slot] = None
                    self.adapter.clear(slot)
                    self.last_token[slot] = 0
        active = np.asarray([r is not None for r in self.active])
        self.last_active = int(active.sum())
        self.peak_active = max(self.peak_active, self.last_active)
        if not active.any():
            if tr is not None:
                self._end_tick(active=0, finished=len(finished))
            return finished
        if not decode:
            if tr is not None:
                self._end_tick(active=self.last_active,
                               finished=len(finished), decode=False)
            return finished
        toks = self.adapter.decode(self.last_token, active)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(toks[slot])
            req.generated.append(tok)
            self.last_token[slot] = tok
            if req.done:
                self._stamp_stats(slot, req)
                self._retire_trace(req, "done")
                finished.append(req)
                self.active[slot] = None
                self.adapter.clear(slot)
                self.last_token[slot] = 0
        if tr is not None:
            self._end_tick(active=self.last_active, finished=len(finished))
        return finished

    def run(self) -> list[Request]:
        """Drain the queue; returns all completed requests."""
        done: list[Request] = []
        while self.busy:
            done.extend(self.step())
        return done
