"""Declarative gateway construction: one ``ServeSpec``, one factory.

``ServeSpec`` names the configuration of a prompt gateway once, as a frozen
dataclass, and ``make_gateway`` validates it and builds the gateway it
describes.  Ported so far: the colocated gateway over dense KV slots (the
reference's default ``paged=False``) or paged KV slots (``paged=True``),
admitting prompts through the chunked prefill fold (the reference's
default ``chunked=True``) or one-shot (``chunked=False``), with the flat
decode tick (``backend`` "plain" | "cuda"), the shared-prefix cascade tick
(``backend="cascade"``) or the gather-tick oracle (``backend="gather"``),
with the observability attachments (``tracer``, ``metrics``, ``slo``,
``shed_factor``, ``flight``, ``incident_dir``).  ``mesh``/``roles`` (sharded
and disaggregated serving) raise until their slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Slot/cache geometry: ``n_slots`` decode lanes of ``max_len`` tokens;
    ``paged`` KV in ``block_size``-token blocks, ``num_blocks`` of them
    (None: dense-equivalent); ``chunked`` prefill.  ``backend`` picks the
    decode tick's attention ("plain" | "cuda" | "cascade" | "gather"; None:
    "cuda" on a CUDA device, "plain" on the CPU).  Scheduling:
    ``max_new_tokens``, ``bytes_per_token``, ``max_queue``,
    ``shed_factor`` and the observability attachments (``tracer`` /
    ``metrics`` / ``slo``) pass straight to the gateway; ``energy_spec``
    prices tokens for the energy ledger.  Forensics: ``flight`` attaches
    an always-on bounded flight recorder (``True`` builds a default
    ``obs.FlightRecorder``, or pass one); ``incident_dir`` arms an
    ``obs.IncidentCapture`` wired to ``slo``, ``flight`` and ``metrics``
    that writes validated bundles into that directory on its triggers and
    on ``gateway.capture_incident(reason)``."""
    n_slots: int = 4
    max_len: int = 128
    paged: bool = False
    block_size: int = 16
    num_blocks: int | None = None
    chunked: bool = True
    backend: str | None = None
    mesh: object | None = None
    roles: object | None = None
    max_new_tokens: int = 16
    bytes_per_token: int = 4
    max_queue: int = 64
    energy_spec: object | None = None
    tracer: object = None
    metrics: object = None
    slo: object = None
    shed_factor: int = 4
    flight: object = None
    incident_dir: str | None = None

    def replace(self, **kw) -> "ServeSpec":
        return dataclasses.replace(self, **kw)


def make_gateway(cfg, params: dict, spec: ServeSpec | None = None, *,
                 extras=None, device: str | torch.device = "cuda",
                 **overrides):
    """Build the ``PromptGateway`` that ``spec`` (plus field ``overrides``)
    describes, on ``device``, where ``params`` must already live.
    ``extras`` is the per-family modality stub ``make_adapter`` takes (the
    encdec family's frame embeddings)."""
    from repro_torch.serve.gateway.gateway import PromptGateway
    from repro_torch.serve.gateway.slots import ContinuousBatcher, make_adapter

    spec = spec or ServeSpec()
    if overrides:
        spec = spec.replace(**overrides)
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"gateway on {dev}")
    if spec.mesh is not None or spec.roles is not None:
        raise NotImplementedError(
            "mesh/roles (sharded and disaggregated serving) are not ported "
            "yet: ROADMAP.md §1, sharded and disaggregated serving")
    if spec.backend is not None and not spec.paged:
        raise ValueError(f"backend={spec.backend!r} selects the paged decode "
                         "tick's attention; it requires paged=True")
    # forensics: flight=True builds the default bounded ring;
    # incident_dir arms the capture pipeline against slo + flight (the
    # gateway hangs its debug_state off context_fn)
    flight = spec.flight
    if flight is True:
        from repro_torch.serve.obs import FlightRecorder
        flight = FlightRecorder()
    incident = None
    if spec.incident_dir is not None:
        from repro_torch.serve.obs import IncidentCapture
        incident = IncidentCapture(spec.incident_dir, flight=flight,
                                   slo=spec.slo, metrics=spec.metrics)
    adapter = make_adapter(
        cfg, params, n_slots=spec.n_slots, max_len=spec.max_len,
        extras=extras, paged=spec.paged, block_size=spec.block_size,
        num_blocks=spec.num_blocks, chunked=spec.chunked,
        backend=spec.backend)
    return PromptGateway(
        ContinuousBatcher(adapter), max_new_tokens=spec.max_new_tokens,
        bytes_per_token=spec.bytes_per_token, max_queue=spec.max_queue,
        energy_spec=spec.energy_spec, tracer=spec.tracer,
        metrics=spec.metrics, slo=spec.slo, shed_factor=spec.shed_factor,
        flight=flight, incident=incident)
