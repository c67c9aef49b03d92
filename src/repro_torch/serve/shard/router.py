"""Cross-shard gateway router: one bucket ladder and block pool per slice.

The port of the reference's ``repro.serve.shard.router``: the sharded
counterpart of ``gateway.PromptGateway``.  A serving mesh
(``launch.mesh.make_serving_mesh``) is factored into per-slice sub-meshes
(``dist.sharding.slice_meshes``), each slice owning its own
``PagedKVSlotAdapter`` (arena and captured ticks on the slice's device)
and ``ContinuousBatcher``.  The router owns the policy above them:

  admission     a prompt is hashed once (``chain_keys``) and every slice's
                radix index is probed with the same keys.  The request
                routes to the deepest-prefix slice when that slice can take
                it now (**affinity**); a saturated affinity slice spills to
                the least-loaded other slice (**affinity_spill**: the prompt
                is recomputed there, correctness never depends on the hit);
                no hit anywhere routes least-loaded (**load**).

  rebalance     when a slice has queued work it cannot admit while another
                sits idle, the router migrates the loaded slice's cheapest
                active request onto the idle slice (``migrate.py``), the
                bytes moved charged to the request through
                ``frontend.migration_energy_nj``.

  telemetry     per-request records identical to the one-slice gateway's,
                plus per-slice pool snapshots (``Telemetry.pools``), the
                routing counters and the migration byte totals.

Parity contract: slices share ``n_slots``, so every slice's decode tick is
the same fixed-shape captured step, a single-device slice's logits are bit
for bit the unsharded adapter's, and a migrated request's post-move logits
are bit for bit the ones it would have produced in place
(``tests/test_torch_sharded.py`` pins both against the reference).

Disaggregated prefill/decode: a :class:`RolePlan` splits the slice list
into prefill slices (admit-only steps, ``ContinuousBatcher.step(decode=
False)``: chunked folds, no tick) and decode slices (ticks only).  Finished
prefixes hand off prefill -> decode over the migration path, routed by
radix affinity then decode occupancy; the handoff bytes ride the same
``migration_energy_nj`` pricing, so the ledger stays conserved.
``roles=None`` is the colocated gateway (``tests/test_torch_disagg.py``).

Slices may share a device: on one H100 every slice lives on ``cuda:0`` and
on the CPU every slice on ``"cpu"``.  A slice of m devices (a ``("model",)``
sub-mesh) splits its arena over them (tensor parallelism within the slice,
``serve/kvcache/paged.py``); its devices may repeat too, as on one H100.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.dist.sharding import Mesh, slice_mesh, slice_meshes
from repro_torch.serve.gateway import frontend as fe
from repro_torch.serve.gateway.gateway import (drive_prompt_loop,
                                               record_prompt_completion,
                                               wire_flight)
from repro_torch.serve.gateway.slots import (ContinuousBatcher, Request,
                                             make_adapter)
from repro_torch.serve.gateway.telemetry import Telemetry
from repro_torch.serve.kvcache.pool import chain_keys
from repro_torch.serve.obs.tracer import SimClock
from repro_torch.serve.shard.migrate import migrate_slot


@dataclasses.dataclass
class GatewaySlice:
    """One mesh slice: its sub-mesh, paged adapter and batcher."""
    idx: int
    mesh: Mesh
    adapter: object
    batcher: ContinuousBatcher


@dataclasses.dataclass(frozen=True)
class RolePlan:
    """Role partition of a gateway's slice list: which slice indices run
    prefill (admit-only chunked folds) and which run decode (ticks).  The
    sets must be disjoint and non-empty and together cover the gateway's
    slices exactly (the gateway checks coverage at construction;
    ``ValueError`` where the reference asserts)."""
    prefill: tuple[int, ...]
    decode: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "prefill", tuple(self.prefill))
        object.__setattr__(self, "decode", tuple(self.decode))
        if not self.prefill or not self.decode:
            raise ValueError("disaggregation needs at least one slice per "
                             "role")
        if set(self.prefill) & set(self.decode):
            raise ValueError("a slice cannot serve both roles")

    @classmethod
    def split(cls, n_prefill: int, n_decode: int) -> "RolePlan":
        """Leading ``n_prefill`` slices prefill, the rest decode: the layout
        ``launch.mesh.make_disagg_meshes`` produces."""
        return cls(tuple(range(n_prefill)),
                   tuple(range(n_prefill, n_prefill + n_decode)))

    def role_of(self, idx: int) -> str:
        if idx in self.prefill:
            return "prefill"
        if idx not in self.decode:
            raise ValueError(f"slice {idx} not in the plan")
        return "decode"


def build_slices(cfg, params, mesh, *, n_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: int | None = None,
                 extras=None, chunked: bool = True,
                 backend: str | None = None) -> list[GatewaySlice]:
    """One :class:`GatewaySlice` per sub-mesh of ``mesh``.

    ``mesh`` is a serving :class:`Mesh` (factored by ``slice_meshes``) or a
    list of per-slice groups, each a ``("model",)`` sub-mesh or a list of
    devices.  Slices may share devices.  Each slice's paged adapter is
    placed on its sub-mesh (``make_adapter(mesh=)``): on its one device,
    or with its arena split over the sub-mesh's devices (tensor
    parallelism, ``engine.arena_specs``) and the params on the first (the
    params copied there unless they already live there).  ``num_blocks``
    is the per-slice block budget.  The rwkv family has no block pool to
    shard (``ValueError``)."""
    if cfg.family == "rwkv":
        raise ValueError("sharded gateway: rwkv has O(1) state and no block "
                         "pool to shard")
    subs = [slice_mesh(sm) for sm in mesh] \
        if isinstance(mesh, (list, tuple)) else slice_meshes(mesh)
    slices = []
    for i, sm in enumerate(subs):
        ad = make_adapter(cfg, params, n_slots=n_slots, max_len=max_len,
                          extras=extras, paged=True, block_size=block_size,
                          num_blocks=num_blocks, chunked=chunked,
                          backend=backend, mesh=sm)
        slices.append(GatewaySlice(i, sm, ad, ContinuousBatcher(ad)))
    return slices


class ShardedPromptGateway:
    """LM front door over N gateway slices (virtual-time event loop)."""

    def __init__(self, slices: list[GatewaySlice], *,
                 max_new_tokens: int = 16, bytes_per_token: int = 4,
                 max_queue: int = 64,
                 energy_spec: fe.FrontendSpec | None = None,
                 auto_rebalance: bool = True,
                 roles: RolePlan | None = None,
                 tracer=None, metrics=None, slo=None,
                 shed_factor: int = 4, flight=None, incident=None):
        if not slices:
            raise ValueError("need at least one slice")
        if len({sl.adapter.n_slots for sl in slices}) != 1:
            raise ValueError("slices must share n_slots (the bitwise-parity "
                             "contract)")
        if len({(sl.adapter.bs, sl.adapter.nb_max) for sl in slices}) != 1:
            raise ValueError("slices must share block geometry (routing "
                             "hashes prompts at one block size and "
                             "migration needs equal bs / nb_max)")
        self.slices = slices
        # slices tick at the same time only on devices of their own (see
        # _step_cost): every device of every slice's sub-mesh distinct
        devs = [d for sl in slices for d in sl.adapter.devices]
        self.parallel = len(set(devs)) == len(devs)
        # role-partitioned (disaggregated) serving: prefill slices run
        # admit-only steps, decode slices run ticks, finished prefixes
        # hand off through the migration path; roles=None is colocated
        self.roles = roles
        if roles is not None and set(roles.prefill) | set(roles.decode) != \
                set(range(len(slices))):
            raise ValueError("RolePlan must cover the slice list exactly")
        self.max_new_tokens = max_new_tokens
        self.bytes_per_token = bytes_per_token
        self.max_queue = max_queue
        self.auto_rebalance = auto_rebalance
        if energy_spec is None:
            energy_spec = fe.FrontendSpec()
        self.energy_spec = energy_spec
        self._token_energy_nj = fe.lm_token_energy_nj(
            energy_spec, slices[0].adapter.cfg.d_model)
        self.routing = {"affinity": 0, "affinity_spill": 0, "load": 0}
        self.migrations = 0
        self.migration_bytes = 0
        self.handoffs = 0           # prefill -> decode moves (role mode)
        self.handoff_bytes = 0
        self.peak_concurrent = 0    # max simultaneous active, fleet-wide
        # observability (serve/obs/): wired into every slice's batcher and
        # adapter only for the length of run(), so warmup stays untraced
        # and without a tracer the fleet makes no obs call
        self.tracer = tracer
        self.metrics = metrics
        self.slo = slo
        # flight recorder and incident forensics, as the one-slice
        # gateway's; debug_state adds the fleet view
        self.flight = flight
        self.incident = incident
        if incident is not None and incident.context_fn is None:
            incident.context_fn = self.debug_state
        # SLO-driven backpressure: under critical burn the fleet-wide
        # admission bound shrinks by shed_factor
        self.shed_factor = shed_factor
        self._shedding = False
        self._shed_role = None      # role mode: which scheduler sheds
        # the latest round's slice-tick wall times (see _step_cost)
        self._tick_sum = 0.0
        self._tick_max = 0.0
        # every slice tick's wall seconds, by role ("all" when colocated):
        # a decode-slice tick never holds a prefill fold, so its latency
        # is a decode device's between-token time (tick_latency_ms)
        self.tick_times: dict[str, list[float]] = {}
        if slo is not None:
            slo.pressure.subscribe(self._on_pressure)

    def _on_pressure(self, event) -> None:
        self._shedding = event.state == "critical"
        if self.roles is None or not self._shedding:
            self._shed_role = None
        else:
            # per-role shedding: TPOT burn is a decode-side symptom — the
            # decode-occupancy scheduler tightens (handoffs need
            # shed_factor x headroom, so prefill lanes back up and throttle
            # themselves); every other objective (ttft / queue_wait /
            # drop_rate) is admission-side — the prefill-capacity
            # scheduler sheds at the door exactly like the colocated bound
            self._shed_role = "decode" if event.worst == "tpot" \
                else "prefill"

    def _admit_bound(self) -> int:
        if self._shedding and self._shed_role != "decode":
            return max(1, self.max_queue // self.shed_factor)
        return self.max_queue

    def jit_fns(self) -> dict[str, object]:
        """Named jitted entry points across every slice, for
        obs.RecompileDetector.track (slice-prefixed; the chunk-fold
        executables are process-wide, so they repeat under each prefix)."""
        fns: dict[str, object] = {}
        for sl in self.slices:
            for name, fn in sl.adapter.jit_fns().items():
                fns[f"slice{sl.idx}.{name}"] = fn
        return fns

    def cost_args(self) -> dict[str, tuple]:
        """Slice-prefixed adapter stages + representative args, for
        obs.costmodel roofline attribution — per-slice copies are distinct
        executables (each compiled against its own mesh placement), so
        each is costed under its own prefix.  Under a :class:`RolePlan`
        the attribution is per role: a prefill slice only ever runs the
        prefill/chunk-fold stages and a decode slice only the decode tick
        + block copy, so each contributes exactly its role's stages under
        a role-named prefix (``prefill0.chunk_fold``, ``decode2.decode``)."""
        out: dict[str, tuple] = {}
        for sl in self.slices:
            for name, pair in sl.adapter.cost_args().items():
                if self.roles is None:
                    out[f"slice{sl.idx}.{name}"] = pair
                    continue
                role = self.roles.role_of(sl.idx)
                keep = ("prefill", "chunk_fold") if role == "prefill" \
                    else ("decode", "copy")
                if name in keep:
                    out[f"{role}{sl.idx}.{name}"] = pair
        return out

    # -- routing ------------------------------------------------------------

    def _load(self, sl: GatewaySlice) -> tuple[int, int]:
        """Load key: blocks a slice has committed (in use + queued
        worst-case demand), then queue depth as the tie-break."""
        queued = sum(sl.adapter._block_demand(len(r.prompt),
                                              r.max_new_tokens)
                     for r in sl.batcher.pending)
        return (sl.adapter.pool.blocks_in_use() + queued,
                len(sl.batcher.pending))

    def _admission_slices(self) -> list[int]:
        """Slice indices admissions may route to: every slice when
        colocated, only the prefill slices under a :class:`RolePlan`."""
        if self.roles is None:
            return list(range(len(self.slices)))
        return list(self.roles.prefill)

    def route(self, prompt: np.ndarray, max_new: int) -> tuple[int, str]:
        """(slice index, reason): radix-prefix affinity first, then
        least-loaded.  Pure policy — no references taken, no state
        mutated except the routing counters.  Under a :class:`RolePlan`
        only prefill slices are candidates (admission is scheduled by
        prefill capacity; decode slices receive work via handoff)."""
        prompt = np.asarray(prompt, np.int32)
        keys, pkey = chain_keys(prompt, self.slices[0].adapter.bs)
        cand = self._admission_slices()
        hits = {i: len(self.slices[i].adapter.pool.probe_chain(
            keys, pkey, count=False)[0]) for i in cand}
        best = max(cand, key=lambda i: hits[i])
        if hits[best] > 0:
            sl = self.slices[best]
            if len(cand) == 1 or (
                    not sl.batcher.pending and
                    sl.adapter.can_admit(prompt, max_new)):
                self.routing["affinity"] += 1
                return best, "affinity"
            # owning slice saturated: the hit is storage, not correctness —
            # spill to the least-loaded *other* slice and recompute there
            # (queueing on the owner would be an affinity route, not a
            # spill, and would sit behind the very congestion we saw)
            reason = "affinity_spill"
            cand = [i for i in cand if i != best]
        else:
            reason = "load"
        order = sorted(cand, key=lambda i: self._load(self.slices[i]))
        self.routing[reason] += 1
        return order[0], reason

    def submit(self, req: Request) -> int:
        """Route + enqueue; returns the slice index chosen."""
        idx, _ = self.route(req.prompt, req.max_new_tokens)
        self.slices[idx].batcher.submit(req)
        return idx

    # -- rebalancing --------------------------------------------------------

    def _free_slot(self, sl: GatewaySlice) -> int | None:
        for j, r in enumerate(sl.batcher.active):
            if r is None and not sl.adapter.slot_bids[j]:
                return j
        return None

    def migrate(self, src_idx: int, slot: int, dst_idx: int, *,
                kind: str = "migrate") -> int:
        """Move the active request in ``(src_idx, slot)`` to ``dst_idx``.
        Returns bytes moved (also accumulated on the request and the
        router's totals).  ``kind`` names the trace span — "migrate" for
        rebalancing moves, "handoff" for prefill->decode moves."""
        src, dst = self.slices[src_idx], self.slices[dst_idx]
        req = src.batcher.active[slot]
        if req is None:
            raise ValueError(f"slice {src_idx} slot {slot} not active")
        dst_slot = self._free_slot(dst)
        if dst_slot is None:
            raise ValueError(f"slice {dst_idx} has no free slot")
        if self.tracer is not None:
            # child of the request's open decode span — the move happens
            # mid-generation on the request's own track
            self.tracer.begin(kind, tid=req.uid)
        receipt = migrate_slot(src.adapter, slot, dst.adapter, dst_slot,
                               req.prompt)
        if self.tracer is not None:
            self.tracer.end(kind, tid=req.uid,
                            args=receipt.trace_args(src_idx, dst_idx))
        dst.batcher.active[dst_slot] = req
        dst.batcher.last_token[dst_slot] = src.batcher.last_token[slot]
        src.batcher.active[slot] = None
        src.batcher.last_token[slot] = 0
        req.migrations += 1
        req.migration_bytes += receipt.bytes_moved
        # router totals are per-kind: rebalance moves vs prefill->decode
        # handoffs (the request-side bytes above ride the energy pricing
        # identically either way)
        if kind == "handoff":
            self.handoffs += 1
            self.handoff_bytes += receipt.bytes_moved
        else:
            self.migrations += 1
            self.migration_bytes += receipt.bytes_moved
        return receipt.bytes_moved

    # -- disaggregated handoff (role mode) ----------------------------------

    def route_handoff(self, req: Request) -> int | None:
        """Decode slice for a finished prefix: deepest radix-affinity hit
        first (the prompt's chain may already live there from an earlier
        handoff), then lowest decode occupancy.  None when no decode slice
        has a free lane + block headroom right now — the lane then waits
        on its prefill slice (natural backpressure), and under decode-side
        shedding the headroom requirement tightens by ``shed_factor``."""
        prompt = np.asarray(req.prompt, np.int32)
        keys, pkey = chain_keys(prompt, self.slices[0].adapter.bs)
        factor = self.shed_factor if self._shed_role == "decode" else 1
        cands = []
        for i in self.roles.decode:
            sl = self.slices[i]
            if self._free_slot(sl) is None:
                continue
            demand = sl.adapter._block_demand(len(prompt),
                                              req.max_new_tokens)
            if demand * factor > sl.adapter.pool.available():
                continue
            hits = len(sl.adapter.pool.probe_chain(keys, pkey,
                                                   count=False)[0])
            cands.append((-hits, self._load(sl), i))
        return min(cands)[2] if cands else None

    def handoff(self, src_idx: int, slot: int, dst_idx: int) -> int:
        """One prefill->decode handoff: the migration move plus the
        handoff counters, and the handed-off prompt chain is *protected*
        on its owning decode slice — eviction under later handoff or
        allocation pressure prefers unprotected blocks, keeping the hot
        shared prefix resident where its lanes decode (affinity-aware
        eviction; the pool falls back to evicting protected blocks only
        when nothing else is left)."""
        req = self.slices[src_idx].batcher.active[slot]
        moved = self.migrate(src_idx, slot, dst_idx, kind="handoff")
        dst = self.slices[dst_idx]
        keys, _ = chain_keys(np.asarray(req.prompt, np.int32),
                             dst.adapter.bs)
        dst.adapter.pool.protect(keys)
        return moved

    def _handoff_pass(self) -> int:
        """Hand off every prefilled lane whose chosen decode slice can
        take it now; lanes with no target stay put until decode capacity
        frees up.  Returns handoffs performed."""
        n = 0
        for i in self.roles.prefill:
            src = self.slices[i]
            for slot, req in enumerate(src.batcher.active):
                if req is None:
                    continue
                dst_idx = self.route_handoff(req)
                if dst_idx is None:
                    continue
                self.handoff(i, slot, dst_idx)
                n += 1
        return n

    def maybe_rebalance(self) -> int:
        """One rebalance pass: every slice with queued work sheds its
        *cheapest* active request — the one holding the fewest blocks, so
        the move costs the fewest bytes — to an idle slice (free slot +
        no queue), unblocking the queued admission.  Returns migrations
        performed."""
        n = 0
        for src in self.slices:
            if not src.batcher.pending:
                continue
            # only a genuinely *blocked* queue justifies paying for a
            # migration: a pending head that will admit into a free slot
            # this very tick must be left alone
            head = src.batcher.pending[0]
            if self._free_slot(src) is not None and \
                    src.adapter.can_admit(head.prompt,
                                          head.max_new_tokens):
                continue
            victims = [j for j, r in enumerate(src.batcher.active)
                       if r is not None]
            if not victims:
                continue
            slot = min(victims, key=lambda j: len(src.adapter.slot_bids[j]))
            for dst in sorted(self.slices, key=self._load):
                if dst is src or dst.batcher.pending:
                    continue
                dst_slot = self._free_slot(dst)
                req = src.batcher.active[slot]
                demand = dst.adapter._block_demand(
                    len(req.prompt), req.max_new_tokens)
                if dst_slot is None or \
                        demand > dst.adapter.pool.available():
                    continue
                self.migrate(src.idx, slot, dst.idx)
                n += 1
                break
        return n

    # -- the event loop -----------------------------------------------------

    @property
    def busy(self) -> bool:
        return any(sl.batcher.busy for sl in self.slices)

    @property
    def queued(self) -> int:
        return sum(len(sl.batcher.pending) for sl in self.slices)

    def warmup(self, prompt_lens: tuple[int, ...]) -> None:
        """Compile every slice's prefill buckets + decode tick up front
        (the chunk-fold executables are shared process-wide, so slices
        after the first mostly re-trace nothing)."""
        for sl in self.slices:
            for j, n in enumerate(prompt_lens):
                sl.batcher.submit(Request(
                    uid=-1 - j, prompt=np.zeros((n,), np.int32),
                    max_new_tokens=2))
            sl.batcher.run()
            sl.batcher.peak_active = 0

    def step(self) -> list[Request]:
        """Rebalance, then one decode tick on every busy slice (colocated);
        admit → handoff → decode tick in role mode."""
        if self.roles is not None:
            return self._step_disagg()
        if self.auto_rebalance:
            self.maybe_rebalance()
        finished: list[Request] = []
        concurrent = 0
        ticks: list[float] = []
        for sl in self.slices:
            if sl.batcher.busy:
                t0 = time.perf_counter()
                finished.extend(sl.batcher.step())
                ticks.append(time.perf_counter() - t0)
                self.tick_times.setdefault("all", []).append(ticks[-1])
                # lanes that actually decoded this round's tick
                # (batcher.last_active — the same quantity the
                # single-device peak_active maximizes, so the sharded
                # acceptance metric is symmetric with its baseline).
                # Every slice is stepped in the same virtual-time round,
                # so the sum is true simultaneous fleet concurrency —
                # per-slice peaks can occur at different times and must
                # not be added
                concurrent += sl.batcher.last_active
        self.peak_concurrent = max(self.peak_concurrent, concurrent)
        self._tick_sum, self._tick_max = sum(ticks), max(ticks, default=0.0)
        return finished

    def _step_cost(self, wall: float) -> float:
        """Virtual cost of the round just stepped.  Slices on devices of
        their own tick *simultaneously* in a real fleet, so the round
        costs the slowest slice's tick plus the router's serial work
        (routing, rebalance/handoff copies through the host) — not the
        sum a single-host simulation measures.  Slices that share a
        device (every slice on the one card, or on the CPU) tick one
        after another on it, so the round costs its wall time: unlike the
        reference, which prices every round so, the port gives no credit
        for parallelism the device does not have.  Fed to
        ``drive_prompt_loop(step_cost=...)`` for untraced runs; with a
        tracer attached wall accounting stays (sub-tick spans anchor to
        real offsets), which the loop checks."""
        if not self.parallel:
            return wall
        return max(0.0, wall - self._tick_sum) + self._tick_max

    def _step_disagg(self) -> list[Request]:
        """One disaggregated round: prefill slices run admit-only ticks
        (chunked folds, no decode), finished prefixes hand off onto decode
        slices, decode slices run their in-place tick.  Rebalancing is the
        handoff pass itself — ``maybe_rebalance`` never runs in role mode
        (a migration onto a prefill slice would put decode work there)."""
        finished: list[Request] = []
        ticks: list[float] = []
        for i in self.roles.prefill:
            sl = self.slices[i]
            if sl.batcher.busy:
                # admission can retire a request here (EOS at prefill /
                # at_capacity) — those never reach a decode slice
                t0 = time.perf_counter()
                finished.extend(sl.batcher.step(decode=False))
                ticks.append(time.perf_counter() - t0)
                self.tick_times.setdefault("prefill", []).append(ticks[-1])
        self._handoff_pass()
        concurrent = 0
        for i in self.roles.decode:
            sl = self.slices[i]
            if sl.batcher.busy:
                t0 = time.perf_counter()
                finished.extend(sl.batcher.step())
                ticks.append(time.perf_counter() - t0)
                self.tick_times.setdefault("decode", []).append(ticks[-1])
                # only lanes that actually decoded count toward fleet
                # concurrency — prefill lanes parked awaiting handoff are
                # queueing, not decoding
                concurrent += sl.batcher.last_active
        self.peak_concurrent = max(self.peak_concurrent, concurrent)
        self._tick_sum, self._tick_max = sum(ticks), max(ticks, default=0.0)
        return finished

    def run(self, arrivals, telemetry: Telemetry | None = None) -> Telemetry:
        tel = telemetry if telemetry is not None else Telemetry()
        arrivals = [a for a in arrivals if a.kind == "prompt"]
        arr_t = {a.uid: a.t for a in arrivals}
        arr_ep = {a.uid: a.endpoint for a in arrivals}
        self.tracer = wire_flight(self.flight, self.tracer, self.metrics)
        # the t_dequeue/t_admit stamps need one shared virtual clock across
        # every slice, tracer or not
        clock = self.tracer.clock if self.tracer is not None else SimClock()
        if self.metrics is not None:
            m = self.metrics
            m.register("queue_depth", lambda: self.queued)
            m.register("migrations", lambda: self.migrations)
            m.register("spills", lambda: self.routing["affinity_spill"])
            if self.roles is not None:
                # per-role series for the disaggregated gateway: queue
                # depth per scheduler, lane occupancy per role, handoff
                # volume.  Occupancy is lanes-in-use over lanes available,
                # the quantity route_handoff load-balances on
                def occ(idxs):
                    used = sum(
                        sum(r is not None
                            for r in self.slices[i].batcher.active)
                        for i in idxs)
                    return used / (len(idxs) *
                                   self.slices[0].adapter.n_slots)
                m.register("prefill_queue", lambda: sum(
                    len(self.slices[i].batcher.pending)
                    for i in self.roles.prefill))
                m.register("decode_queue", lambda: sum(
                    len(self.slices[i].batcher.pending)
                    for i in self.roles.decode))
                m.register("prefill_occupancy",
                           lambda: occ(self.roles.prefill))
                m.register("decode_occupancy",
                           lambda: occ(self.roles.decode))
                m.register("handoffs", lambda: self.handoffs)
                m.register("handoff_bytes", lambda: self.handoff_bytes)
            for sl in self.slices:
                m.register(f"slice{sl.idx}_blocks_in_use",
                           lambda sl=sl:
                           sl.adapter.pool.gauges()["pool_blocks_in_use"])
                m.register(f"slice{sl.idx}_queue",
                           lambda sl=sl: len(sl.batcher.pending))
                m.register(f"slice{sl.idx}_active",
                           lambda sl=sl: sl.batcher.last_active)
            casc = [sl for sl in self.slices
                    if getattr(sl.adapter, "backend", None) == "cascade"]
            if casc:
                # fleet-aggregated cascade grouping gauges; same
                # cascade_* names as the one-slice gateway, so the
                # repro_cascade_* OpenMetrics families are path-agnostic
                for key in ("groups", "grouped_lanes", "prefix_rows",
                            "prefix_rows_flat"):
                    m.register(f"cascade_{key}", lambda k=key: sum(
                        sl.adapter.cascade_stats()[k] for sl in casc))
        for sl in self.slices:
            sl.batcher.clock = clock
            sl.batcher.tracer = self.tracer
            sl.batcher.trace_pid = 1 + sl.idx       # engine track per slice
            sl.adapter.tracer = self.tracer
        try:
            drive_prompt_loop(
                arrivals, tel,
                busy=lambda: self.busy,
                queue_depth=lambda: self.queued,
                max_queue=self._admit_bound,
                submit=lambda a: self.submit(Request(
                    uid=a.uid, prompt=np.asarray(a.payload, np.int32),
                    max_new_tokens=self.max_new_tokens)),
                step=self.step,
                # .get defaults: requests submitted directly (not via an
                # Arrival) can still drain through run([])
                record=lambda req, now: record_prompt_completion(
                    tel, req, now, arr_t.get(req.uid, 0.0),
                    arr_ep.get(req.uid, -1), self._token_energy_nj,
                    self.bytes_per_token, energy_spec=self.energy_spec,
                    tracer=self.tracer, slo=self.slo),
                clock=clock, tracer=self.tracer, metrics=self.metrics,
                slo=self.slo, incident=self.incident,
                step_cost=self._step_cost if self.tracer is None else None)
        finally:
            for sl in self.slices:
                sl.batcher.clock = None
                sl.batcher.tracer = None
                sl.adapter.tracer = None
        for sl in self.slices:
            tel.record_pool(sl.adapter.pool_stats(), slice_idx=sl.idx)
        tel.record_routing({**self.routing, "migrations": self.migrations,
                            "migration_bytes": self.migration_bytes,
                            "handoffs": self.handoffs,
                            "handoff_bytes": self.handoff_bytes})
        if self.metrics is not None and self.metrics.samples:
            tel.record_series(self.metrics.samples)
        if self.incident is not None:
            self.incident.check_energy(tel, clock.t)
        return tel

    def debug_state(self) -> dict:
        """Fleet forensic state for incident bundles: routing/migration/
        handoff counters, the RolePlan, per-slice batcher + pool snapshots,
        jit-cache sizes — aggregate state only, no request payloads."""
        state: dict = {
            "kind": "sharded_gateway",
            "n_slices": len(self.slices),
            "max_queue": self.max_queue,
            "admit_bound": self._admit_bound(),
            "shedding": self._shedding,
            "shed_role": self._shed_role,
            "routing": dict(self.routing),
            "migrations": self.migrations,
            "migration_bytes": self.migration_bytes,
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "peak_concurrent": self.peak_concurrent,
            "jit_cache_sizes": {name: fn._cache_size()
                                for name, fn in self.jit_fns().items()},
        }
        if self.roles is not None:
            state["roles"] = {"prefill": list(self.roles.prefill),
                              "decode": list(self.roles.decode)}
        slices = []
        for sl in self.slices:
            rec = {"idx": sl.idx,
                   "role": self.roles.role_of(sl.idx)
                   if self.roles is not None else "all",
                   "batcher": sl.batcher.debug_state(),
                   "pool": sl.adapter.pool.debug_snapshot()}
            if getattr(sl.adapter, "backend", None) == "cascade":
                rec["cascade"] = sl.adapter.cascade_stats()
            slices.append(rec)
        state["slices"] = slices
        return state

    def capture_incident(self, reason: str, *, extra: dict | None = None):
        """Explicit forensic capture (trigger ``explicit``); requires an
        IncidentCapture attached at construction."""
        if self.incident is None:
            raise RuntimeError(
                "capture_incident() needs an IncidentCapture attached "
                "(ShardedPromptGateway(..., incident=...) or "
                "ServeSpec(incident_dir=...))")
        return self.incident.capture(reason, extra=extra)

    # -- telemetry ----------------------------------------------------------

    def peak_active_total(self) -> int:
        """Aggregate concurrency: the fleet-wide maximum of *simultaneous*
        active slots, tracked per step round.  Deliberately not the sum of
        per-slice peaks — those can occur at different times and would
        overstate what the fleet ever ran at once."""
        return self.peak_concurrent

    def tick_latency_ms(self, role: str = "all", q: float = 99.0) -> float:
        """Percentile of per-slice tick wall time in ms, the decode
        head-of-line metric: each tick is one generated token for every
        lane it decodes, so a slice's tick-latency distribution is its
        between-token time.  Colocated ticks ("all") absorb admission's
        chunked-prefill folds; a decode-role tick never does — under a
        prefill burst p99("decode") on a disaggregated gateway beating
        p99("all") on a colocated one at equal device budget is exactly
        the head-of-line relief disaggregation buys
        (the reference's ``benchmarks/kvcache_bench.py --disagg`` gates this)."""
        ts = self.tick_times.get(role, ())
        if not ts:
            return 0.0
        return float(np.percentile(np.asarray(ts, np.float64), q) * 1e3)
