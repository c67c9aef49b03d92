"""Continuous batching front (the reference's compatibility module).

The scheduler lives in :mod:`repro_torch.serve.gateway.slots` as a
family-generic loop over slot adapters: state slots for the rwkv family
(O(1) state, one write on admission) and KV slots for the attention
families.  :class:`RwkvContinuousBatcher` stays the entry point for the
rwkv family, as in the reference.
"""
from __future__ import annotations

from repro_torch.models.lm import LMConfig
from repro_torch.serve.gateway.slots import (ContinuousBatcher, KVSlotAdapter,
                                             Request, StateSlotAdapter,
                                             make_adapter)
from repro_torch.serve.kvcache.paged import PagedKVSlotAdapter
from repro_torch.serve.kvcache.pool import BlockPool

__all__ = ["BlockPool", "ContinuousBatcher", "KVSlotAdapter",
           "PagedKVSlotAdapter", "Request", "RwkvContinuousBatcher",
           "StateSlotAdapter", "make_adapter"]


class RwkvContinuousBatcher(ContinuousBatcher):
    """Continuous batching for the rwkv family over :class:`StateSlotAdapter`
    slots (``ValueError`` for another family)."""

    def __init__(self, cfg: LMConfig, params: dict, n_slots: int = 4):
        super().__init__(StateSlotAdapter(cfg, params, n_slots))
        self.cfg = cfg
        self.params = params
