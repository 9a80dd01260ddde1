"""The port's distributed layer, over ``torch.distributed`` (port of
``repro.distributed``).

  * ``repro_torch.distributed.mttkrp_dist`` — the partitions, each rank's
    setup and the sharded MTTKRP in both schemes (``mode_ordered``,
    ``allreduce``), each rank's shard through the split kernel;
  * ``repro_torch.distributed.spawn`` — one process per shard on this
    host, and the backend rule (gloo on the CPU or a shared card, NCCL
    with a card per rank);
  * ``repro_torch.distributed.layout`` — the "2d" / "dp_only" policy;
  * ``repro_torch.distributed.sharding`` — JAX's sharding rules as
    ``PartitionSpec``s leaf by leaf, and states placed on a mesh as
    ``DTensor``s (``shard_state``, ``gather_state``);
  * ``repro_torch.distributed.sharded_step`` — the sharded train step, the
    port's counterpart of JAX's pjit step;
  * ``repro_torch.distributed.sharded_serve`` — the sharded prefill and
    decode, the port's counterparts of JAX's pjit prefill and decode;
  * ``repro_torch.distributed.tensor_parallel`` — compute over the model
    axis: Megatron's operators, the vocabulary-parallel lookup and loss;
  * ``repro_torch.distributed.decode`` — the decode with the KV cache
    sharded on sequence, combined by the log-sum-exp;
  * ``repro_torch.distributed.collectives`` — ``compressed_psum`` and
    ``ring_allgather_matmul``.

Meshes are ``repro_torch.launch.mesh``'s.
"""

from repro_torch.distributed.collectives import compressed_psum, ring_allgather_matmul
from repro_torch.distributed.layout import get_layout, layout_scope, pick_layout, set_layout
from repro_torch.distributed.mttkrp_dist import (
    SCHEMES,
    ShardedModeSetup,
    build_sharded_mode_setup,
    mttkrp_sharded,
    mttkrp_sharded_apply,
    partition_by_output_rows,
)
from repro_torch.distributed.sharding import (
    P,
    PartitionSpec,
    batch_shardings,
    decode_state_shardings,
    gather_state,
    param_shardings,
    placements,
    shard_state,
    train_state_shardings,
)
from repro_torch.distributed.spawn import backend_for, rank_device, spawn

# The step modules import the models, and the models import
# ``tensor_parallel`` from this package: those two load on first use.
_LAZY = {"sharded_decode_attention": "repro_torch.distributed.decode",
         "sharded_train_step": "repro_torch.distributed.sharded_step"}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value

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
    "P",
    "PartitionSpec",
    "batch_shardings",
    "compressed_psum",
    "decode_state_shardings",
    "gather_state",
    "get_layout",
    "layout_scope",
    "param_shardings",
    "pick_layout",
    "placements",
    "ring_allgather_matmul",
    "set_layout",
    "shard_state",
    "sharded_decode_attention",
    "sharded_train_step",
    "train_state_shardings",
]
