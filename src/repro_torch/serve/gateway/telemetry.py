"""Per-request energy/bandwidth/latency accounting for the gateway.

Every completed request is charged:
  - frontend energy — the calibrated gate-level model of ``core.energy``
    projected onto the serving layer's geometry (``scaled_report``): SC
    streams for the sc frontend, the k-bit MAC datapath for binary;
  - link energy — bytes crossing the sensor->host link at a nominal
    near-sensor serial-link cost (``E_LINK_PJ_PER_BYTE``).

The ledger keeps an independent running fleet total next to the per-request
records; ``assert_conserved`` checks they agree exactly (no energy is
created or dropped by the aggregation), which the tier-1 suite exercises.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ~10 pJ/bit: MIPI-class near-sensor serial link at 65nm (order-of-magnitude
# constant; what matters for the paper's claim is bytes, reported alongside).
E_LINK_PJ_PER_BYTE = 80.0


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    uid: int
    endpoint: int
    kind: str                    # "frame" | "prompt"
    t_arrival: float
    t_done: float
    energy_nj: float             # frontend + link
    link_bytes: int
    output: int = -1             # predicted class / last token
    kv_blocks: int = 0           # paged KV blocks reserved (0 = dense slots)
    prefix_hit_blocks: int = 0   # of those, satisfied from the radix index
    # prompt tokens never prefilled (prefix-cache resume); energy_nj covers
    # only the tokens actually processed, energy_saved_nj is the frontend
    # energy those skipped tokens would have cost (scaled_report pricing)
    prefill_tokens_skipped: int = 0
    energy_saved_nj: float = 0.0
    # cross-slice KV-block migration (sharded gateway): bytes this request's
    # context moved between slices; the move's energy is already inside
    # energy_nj (frontend.migration_energy_nj), keeping the ledger conserved
    migration_bytes: int = 0
    migrations: int = 0
    # serving SLO timestamps (virtual clock; -1 = not tracked): when the
    # request left the queue for its slot, and when its first token existed
    # (prefill done) — TTFT/TPOT and the queue-wait breakdown in report()
    t_dequeue: float = -1.0
    t_admit: float = -1.0
    tokens_out: int = 0          # generated tokens (TPOT denominator)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival


class Telemetry:
    """Append-only request ledger + conserved fleet totals."""

    def __init__(self):
        # (uid, kind, reason, t) rejections; indices 0/1 keep the legacy
        # (uid, kind) tuple shape for existing consumers
        self.records: list[RequestRecord] = []
        self.dropped: list[tuple[int, str, str, float]] = []
        self._fleet_energy_nj = 0.0
        self._fleet_link_bytes = 0
        self.pool: dict = {}          # paged KV pool snapshot (LM path)
        self.pools: dict = {}         # per-slice snapshots (sharded gateway)
        self.routing: dict = {}       # cross-slice routing/migration counts
        self.series: list[dict] = []  # interval metric snapshots (serve/obs)

    # -- charging ----------------------------------------------------------
    def record(self, rec: RequestRecord) -> None:
        self.records.append(rec)
        self._fleet_energy_nj += rec.energy_nj
        self._fleet_link_bytes += rec.link_bytes

    def drop(self, uid: int, kind: str, reason: str = "unspecified",
             t: float = 0.0) -> None:
        """Rejection accounting: *why* (queue-full / capacity / deadline /
        pool-exhausted) and *when* (virtual clock), not just who.  The old
        2-tuple call shape still works — reason/t default."""
        self.dropped.append((uid, kind, reason, t))

    def record_pool(self, stats: dict, slice_idx: int | None = None) -> None:
        """Snapshot the paged KV pool's counters (blocks in use, prefix-hit
        rate, bytes saved vs dense, evictions) into the ledger.  The
        sharded gateway passes ``slice_idx`` to keep one snapshot per mesh
        slice (``pools``); ``pool`` then aggregates the additive counters
        across slices."""
        if slice_idx is None:
            self.pool = dict(stats)
            return
        self.pools[slice_idx] = dict(stats)
        agg: dict = {}
        for st in self.pools.values():
            for k, v in st.items():
                if k == "block_size" or isinstance(v, bool) or \
                        not isinstance(v, (int, float)):
                    agg[k] = v                   # per-slice constant
                elif k == "prefix_hit_rate":
                    agg[k] = agg.get(k, 0.0)     # re-derived below
                elif k.startswith("peak_"):
                    # per-slice high-water marks are asynchronous: their
                    # sum overstates any fleet-simultaneous peak.  Max is
                    # the defensible aggregate (a lower bound on the true
                    # fleet peak); the per-slice marks stay in ``pools``
                    agg[k] = max(agg.get(k, 0), v)
                else:
                    agg[k] = agg.get(k, 0) + v   # additive counter
        # the fleet hit rate comes from the summed raw counters, not a
        # mean of per-slice rates (a busy cold slice would otherwise be
        # averaged 1:1 against an idle warm one)
        q = agg.get("prefix_queries", 0)
        agg["prefix_hit_rate"] = (agg.get("prefix_hits", 0) / q) if q \
            else 0.0
        agg["n_slices"] = len(self.pools)
        self.pool = agg

    def record_routing(self, counts: dict) -> None:
        """Cross-slice routing decisions + migration totals (sharded
        gateway): affinity vs load routes, spills, migrations, bytes."""
        self.routing = dict(counts)

    def record_series(self, samples: list[dict]) -> None:
        """Attach the interval metric snapshots a run sampled
        (serve/obs.MetricsRegistry): occupancy/queue-depth curves ride in
        ``report()`` next to the end-of-run aggregates."""
        self.series = list(samples)

    # -- aggregation -------------------------------------------------------
    @property
    def fleet_energy_nj(self) -> float:
        return self._fleet_energy_nj

    @property
    def fleet_link_bytes(self) -> int:
        return self._fleet_link_bytes

    def assert_conserved(self) -> None:
        per_req = sum(r.energy_nj for r in self.records)
        if not np.isclose(per_req, self._fleet_energy_nj, rtol=0, atol=1e-9):
            raise AssertionError(
                f"energy ledger leak: sum(per-request)={per_req} != "
                f"fleet total={self._fleet_energy_nj}")
        if sum(r.link_bytes for r in self.records) != self._fleet_link_bytes:
            raise AssertionError("link-byte ledger leak")

    def report(self, duration_s: float, kind: str | None = None) -> dict:
        recs = [r for r in self.records
                if kind is None or r.kind == kind]
        dropped = [d for d in self.dropped
                   if kind is None or d[1] == kind]
        out = {
            "completed": len(recs),
            "dropped": len(dropped),
            # n_samples rides along so downstream gates (check_bench) can
            # refuse percentile claims built on tiny samples
            "n_samples": len(recs),
            "throughput_hz": len(recs) / duration_s if duration_s > 0
            else 0.0,
        }
        if dropped:
            by_reason: dict[str, int] = {}
            for d in dropped:
                r = d[2] if len(d) > 2 else "unspecified"
                by_reason[r] = by_reason.get(r, 0) + 1
            out["dropped_by_reason"] = by_reason
        if recs:
            lat = np.asarray([r.latency_s for r in recs])
            energy = np.asarray([r.energy_nj for r in recs])
            link = np.asarray([r.link_bytes for r in recs])
            out.update(
                p50_latency_ms=float(np.percentile(lat, 50) * 1e3),
                p99_latency_ms=float(np.percentile(lat, 99) * 1e3),
                mean_energy_nj=float(energy.mean()),
                j_per_inference=float(energy.mean() * 1e-9),
                link_bytes_per_req=float(link.mean()),
            )
            kv = sum(r.kv_blocks for r in recs)
            if kv:
                out["kv_blocks_per_req"] = kv / len(recs)
                out["kv_prefix_hit_blocks_per_req"] = \
                    sum(r.prefix_hit_blocks for r in recs) / len(recs)
                out["prefill_tokens_skipped_per_req"] = \
                    sum(r.prefill_tokens_skipped for r in recs) / len(recs)
                out["prefill_energy_saved_nj"] = \
                    float(sum(r.energy_saved_nj for r in recs))
            mig = sum(r.migrations for r in recs)
            if mig:
                out["migrations"] = mig
                out["migration_bytes_total"] = \
                    int(sum(r.migration_bytes for r in recs))
            # serving SLO stats, from requests that tracked the admission
            # timestamps (LM paths; frame requests have no queue/prefill
            # split so they simply don't contribute)
            slo = [r for r in recs if r.t_admit >= 0]
            if slo:
                ttft = np.asarray([r.t_admit - r.t_arrival for r in slo])
                tpot = np.asarray([(r.t_done - r.t_admit)
                                   / max(1, r.tokens_out - 1) for r in slo])
                out.update(
                    slo_n_samples=len(slo),
                    ttft_p50_ms=float(np.percentile(ttft, 50) * 1e3),
                    ttft_p99_ms=float(np.percentile(ttft, 99) * 1e3),
                    tpot_p50_ms=float(np.percentile(tpot, 50) * 1e3),
                    tpot_p99_ms=float(np.percentile(tpot, 99) * 1e3),
                )
                qw = [r for r in slo if r.t_dequeue >= 0]
                if qw:
                    w = np.asarray([r.t_dequeue - r.t_arrival for r in qw])
                    out["queue_wait_p50_ms"] = \
                        float(np.percentile(w, 50) * 1e3)
                    out["queue_wait_p99_ms"] = \
                        float(np.percentile(w, 99) * 1e3)
        if self.pool and kind in (None, "prompt"):
            out["pool"] = dict(self.pool)
        if self.pools and kind in (None, "prompt"):
            out["pools"] = {i: dict(st) for i, st in self.pools.items()}
        if self.routing and kind in (None, "prompt"):
            out["routing"] = dict(self.routing)
        if self.series:
            out["series"] = list(self.series)
        return out
