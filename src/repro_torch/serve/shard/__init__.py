"""Sharded paged serving: per-slice KV arenas and cross-slice routing.

A serving mesh is factored into slices (``dist.sharding.slice_meshes``);
each slice owns a full paged serving stack on its device, and the
:class:`ShardedPromptGateway` routes admissions across slices by
radix-prefix affinity, spills by load, and migrates live requests between
slices with refcounts and prefix sharing kept (:func:`migrate_slot`).  A
:class:`RolePlan` disaggregates the slices into prefill slices (admit-only
chunked folds) and decode slices (ticks), finished prefixes handing off
prefill -> decode over the migration path.

On the CPU the tests' slices all share ``"cpu"`` (the reference's tests
force 8 host devices instead); on one card every slice shares
``cuda:0``.
"""
from repro_torch.serve.shard.migrate import MigrationReceipt, migrate_slot
from repro_torch.serve.shard.router import (GatewaySlice, RolePlan,
                                            ShardedPromptGateway,
                                            build_slices)

__all__ = ["GatewaySlice", "MigrationReceipt", "RolePlan",
           "ShardedPromptGateway", "build_slices", "migrate_slot"]
