"""Sharded MTTKRP on ``torch.distributed``, the port of ``repro.distributed.mttkrp_dist``.

  * ``repro_torch.distributed.mttkrp_dist`` — the partitions, each rank's
    setup and the sharded MTTKRP in both schemes (``mode_ordered``,
    ``allreduce``), each rank's shard through the split kernel;
  * ``repro_torch.distributed.spawn`` — one process per shard on this
    host, and the backend rule (gloo on the CPU or a shared card, NCCL
    with a card per rank).
"""

from repro_torch.distributed.mttkrp_dist import (
    SCHEMES,
    ShardedModeSetup,
    build_sharded_mode_setup,
    mttkrp_sharded,
    mttkrp_sharded_apply,
    partition_by_output_rows,
)
from repro_torch.distributed.spawn import backend_for, rank_device, spawn

__all__ = [
    "ShardedModeSetup",
    "build_sharded_mode_setup",
    "mttkrp_sharded",
    "mttkrp_sharded_apply",
    "partition_by_output_rows",
    "SCHEMES",
    "backend_for",
    "rank_device",
    "spawn",
]
