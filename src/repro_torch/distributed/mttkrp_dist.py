"""Sharded MTTKRP on ``torch.distributed``: one process per shard.

The counterpart of ``repro.distributed.mttkrp_dist``, with its two schemes:

  * ``allreduce`` (naive baseline): the nonzeros are cut into equal
    blocks of the raw (or strategy) order; every shard computes a
    full-height partial MTTKRP over its block, and one ``all_reduce``
    sums them;
  * ``mode_ordered`` (paper-faithful): the nonzeros are partitioned by
    OUTPUT ROW RANGE at the row ends closest to an even split of the
    nonzeros (the paper's per-PE mapping), and shard ``r`` owns the
    equal-height output block ``[r * rows_per, (r + 1) * rows_per)``,
    ``rows_per = ceil(I / n)``.  The blocks need no reduction: one
    ``all_gather`` puts them side by side.  The nonzeros that the
    row-range cut gives a shard outside its block (the leftovers) are
    added by a residual pass that every rank runs, as the JAX package's
    does.

Where the JAX package runs the shards as one ``shard_map`` program over a
device mesh, here each shard is a rank of a ``torch.distributed`` group
(``repro_torch.distributed.spawn`` starts them on one host) and holds only
its own part: its shard as a ``SparseTensor`` (``mode_ordered``: in local
rows), that shard's ``MTTKRPPlan`` (its buffers uploaded once, at setup)
and the plan of the leftovers.  Each rank's local MTTKRP is one launch of the split kernel
(``csrc/mttkrp_split.cu``) over its shard's plan on a CUDA device, and the
kernel's plain version on the CPU; so is the residual pass, over the
leftovers' plan.  JAX's residual pass is plain ``jnp``; the port's runs
through the kernel because a plain pass on the card is either unordered
(``index_add_`` adds by atomics, so ``mode_ordered`` would not repeat bit
for bit) or slow (the sorted ``index_put_(accumulate=True)`` took
0.38-1.38 s a call on an NVIDIA H100 over the 2.3-5.3M leftovers of a
NELL-2 stand-in at Table II size on 4 ranks, summing hot rows one nonzero
at a time).  Input factors are replicated.

A shard's plan runs its nonzeros in the order ``executed_input_traces(
impl="sharded")`` reports for the shard (``build_mttkrp_plan(order=)``
over the shard's own layout), except under ``allreduce`` with no
ordering, whose trace is the raw COO order: the kernel needs a stream
grouped by output block, so that plan takes the ``lex`` order of the
block (so the experiment engine refuses that pair).  The leftovers of
``mode_ordered`` run in the residual pass, not in the shard's plan;
``residual_shares`` gives their share of each shard's trace.  Each rank's
sorts run on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.memo import IdentityKeyedCache
from repro_torch.core.sparse_tensor import MTTKRPPlan, SparseTensor, build_mttkrp_plan
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.mttkrp.ops import TensorOperands, mttkrp_from_plan, plan_device_buffers
from repro_torch.reorder.strategies import nonzero_order

__all__ = [
    "SCHEMES",
    "ShardedModeSetup",
    "all_reduce_sum",
    "build_sharded_mode_setup",
    "local_mttkrp",
    "mttkrp_sharded",
    "mttkrp_sharded_apply",
    "partition_by_output_rows",
    "require_group",
    "residual_shares",
    "sharded_fit_operands",
    "sharded_setup",
]

SCHEMES = ("mode_ordered", "allreduce")

# Setups per (tensor, mode, scheme, ordering, shards, rank, device), so that
# an eager CP-ALS partitions each mode once, as ops.get_plan plans it once.
_SETUP_CACHE = IdentityKeyedCache()
# The fit's operands per (tensor, shards, rank, device, dtype).
_FIT_CACHE = IdentityKeyedCache()


def require_group(group=None) -> tuple[int, int]:
    """``(rank, world size)`` in ``group``; raises without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "impl='sharded' runs one process per shard and needs an initialized "
            "process group: start the ranks with repro_torch.distributed.spawn, or "
            "call torch.distributed.init_process_group in each of them"
        )
    return dist.get_rank(group), dist.get_world_size(group)


def _check_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")


def _row_cuts(rows: np.ndarray, i_out: int, n_shards: int):
    """The JAX partition's cuts, from the row histogram instead of a sort.

    Returns ``(bounds, ends, shard_of_nnz)``: shard ``i`` holds positions
    ``[bounds[i], bounds[i + 1])`` of the stable output-mode sort, row
    ``r`` ends at position ``ends[r]`` of it, and ``shard_of_nnz`` is each
    nonzero's shard.  Each cut is the end of the row at an even split of
    the nonzeros, as ``np.searchsorted`` finds it over the sorted rows.
    """
    counts = np.bincount(rows, minlength=i_out)
    ends = np.cumsum(counts)
    nnz = int(rows.shape[0])
    targets = np.array([(nnz * (i + 1)) // n_shards for i in range(n_shards - 1)], np.int64)
    # The row at sorted position t is the first whose end passes t.
    at = np.searchsorted(ends, np.minimum(targets, nnz - 1), side="right")
    bounds = np.concatenate([[0], ends[at], [nnz]]).astype(np.int64)
    shard_of_row = np.searchsorted(bounds[1:-1], ends - counts, side="right")
    return bounds, ends, shard_of_row[rows]


def _row_start(bounds: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """JAX's ``row_start``: each shard's first row; for an empty shard the
    row just before its cut (0 at the front)."""
    a, b = bounds[:-1], bounds[1:]
    first = np.searchsorted(ends, a, side="right")  # the sorted row at position a
    before = np.searchsorted(ends, np.maximum(a - 1, 0), side="right")
    return np.where(b > a, first, np.where(a > 0, before, 0)).astype(np.int32)


def _stable_argsort(keys: np.ndarray, device: torch.device | None = None) -> np.ndarray:
    """``np.argsort(keys, kind="stable")``, on ``device`` when it is a CUDA
    device (a stable sort has one answer, so both give the same array)."""
    if device is None or device.type != "cuda":
        return np.argsort(keys, kind="stable")
    return torch.sort(torch.as_tensor(keys, device=device), stable=True).indices.cpu().numpy()


def _shard_members(
    tensor: SparseTensor, mode: int, shard_of_nnz: np.ndarray, shard: int,
    count: int, order: np.ndarray | None, device: torch.device | None = None,
) -> np.ndarray:
    """Positions of ``shard``'s nonzeros in its layout: the stable
    output-mode sort (on ``device``), or ``order`` restricted to the shard."""
    if order is None:
        sel = np.flatnonzero(shard_of_nnz == shard)
        return sel[_stable_argsort(tensor.indices[sel, mode], device)]
    members = order[shard_of_nnz[order] == shard]
    if members.shape[0] != count:  # membership is order-independent
        raise ValueError(
            f"order is not a permutation of this tensor's nonzeros: shard {shard} "
            f"collected {members.shape[0]} members, row ownership says {count}"
        )
    return members


def partition_by_output_rows(
    tensor: SparseTensor, mode: int, n_shards: int, *, order: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by output mode and pad-split nonzeros into equal shard blocks.

    Returns (indices (n_shards, m, nmodes), values (n_shards, m),
    row_start (n_shards,)) where shard i owns output rows
    [row_start[i], row_start[i+1]), array for array those of the JAX
    package.  Shard boundaries are placed at row ends closest to an even
    nnz split; padding entries carry value 0 at the shard's first row.
    ``order`` optionally injects a nonzero execution permutation: shard
    membership is unchanged, but each shard's nonzeros are laid out in it.
    """
    rows = tensor.indices[:, mode]
    bounds, ends, shard_of_nnz = _row_cuts(rows, tensor.shape[mode], n_shards)
    per = int(np.diff(bounds).max())
    out_idx = np.zeros((n_shards, per, tensor.nmodes), np.int32)
    out_val = np.zeros((n_shards, per), tensor.values.dtype)
    row_start = _row_start(bounds, ends)
    for i in range(n_shards):
        a, b = int(bounds[i]), int(bounds[i + 1])
        members = _shard_members(tensor, mode, shard_of_nnz, i, b - a, order)
        n = members.shape[0]
        if n:
            out_idx[i, :n] = tensor.indices[members]
            out_val[i, :n] = tensor.values[members]
            out_idx[i, n:, mode] = row_start[i]
    return out_idx, out_val, row_start


@dataclasses.dataclass(frozen=True)
class ShardedModeSetup:
    """One rank's part of the sharded MTTKRP for one (mode, scheme).

    The partitioning work of the sharded path, done once per mode so that
    callers running many MTTKRPs (the fused executor) pay it once.
    ``shard`` holds the nonzeros this rank's kernel runs: under
    ``mode_ordered`` the owned ones, output rows counted from ``row_base``
    (a multiple of the plan's ``rows_per_block``, so that the shard's
    blocks are the tensor's, which the ``blocked`` order needs), and under
    ``allreduce`` its equal block, in the tensor's rows.  ``plan`` is the
    shard's plan, its buffers on the rank's device.  ``leftovers`` are the
    JAX package's residual nonzeros (its ``leftover_idx``/``leftover_val``,
    on the host), or None, and ``leftover_plan`` their plan, in the
    tensor's rows.
    """

    mode: int
    scheme: str
    nmodes: int
    i_out: int
    n_shards: int
    rank: int
    rows_per: int  # mode_ordered: output block height; allreduce: nonzeros per block
    shard: SparseTensor
    row_base: int
    plan: MTTKRPPlan
    row_start: np.ndarray | None  # mode_ordered only
    leftovers: SparseTensor | None
    leftover_plan: MTTKRPPlan | None

    @property
    def block_offset(self) -> int:
        """Local output row where this rank's block starts (``mode_ordered``)."""
        return self.rank * self.rows_per - self.row_base if self.scheme == "mode_ordered" else 0


def build_sharded_mode_setup(
    tensor: SparseTensor,
    mode: int,
    n_shards: int,
    *,
    rank: int | None = None,
    scheme: str = "mode_ordered",
    ordering: str | None = None,
    rows_per_block: int = 256,
    tile_nnz: int = 256,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ShardedModeSetup:
    """Partition ``tensor`` for ``mode`` and build ``rank``'s part of it
    (default: this process's rank in the default group) on ``device``.

    The cuts come from the row histogram, so each rank sorts only its own
    shard and the leftovers, on ``device``, never the whole tensor; an
    ``ordering`` other than None sorts the whole tensor once on ``device``
    (``nonzero_order``).
    """
    _check_scheme(scheme)
    if rank is None:
        rank, _ = require_group()
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} out of range for {n_shards} shards")
    if not 0 <= mode < tensor.nmodes:
        raise ValueError(f"mode {mode} out of range for {tensor.nmodes}-mode tensor")
    dev = resolve_device(device)
    i_out, nnz = tensor.shape[mode], tensor.nnz
    order = None
    if ordering is not None:
        order = nonzero_order(tensor, mode, ordering, rows_per_block=rows_per_block, device=dev)
    label = "lex" if ordering is None else ordering
    row_start = leftovers = leftover_plan = None

    if scheme == "allreduce":
        rows_per = -(-nnz // n_shards)
        lo, hi = min(rank * rows_per, nnz), min((rank + 1) * rows_per, nnz)
        sel = np.arange(lo, hi) if order is None else order[lo:hi]
        shard = SparseTensor(tensor.indices[sel], tensor.values[sel], tensor.shape)
        row_base = 0
        # The raw order is not grouped by output block: that plan sorts it.
        own_order = (_stable_argsort(shard.indices[:, mode], dev) if order is None
                     else np.arange(shard.nnz))
    else:
        rows = tensor.indices[:, mode]
        bounds, ends, shard_of_nnz = _row_cuts(rows, i_out, n_shards)
        rows_per = -(-i_out // n_shards)
        block_of = rows // rows_per
        members = _shard_members(tensor, mode, shard_of_nnz, rank,
                                 int(bounds[rank + 1] - bounds[rank]), order, dev)
        own = members[block_of[members] == rank]
        row_base = (rank * rows_per // rows_per_block) * rows_per_block
        idx = tensor.indices[own].astype(np.int32)
        idx[:, mode] -= row_base
        shape = tensor.shape[:mode] + ((rank + 1) * rows_per - row_base,) + tensor.shape[mode + 1:]
        shard = SparseTensor(idx, tensor.values[own], shape)
        own_order = np.arange(shard.nnz)
        # JAX's residual nonzeros: shard-major, each shard in its layout.
        left = (shard_of_nnz != block_of) & (tensor.values != 0)
        if order is None:
            pos = np.flatnonzero(left)
            pos = pos[_stable_argsort(rows[pos], dev)]
        else:
            pos = order[left[order]]
            pos = pos[_stable_argsort(shard_of_nnz[pos], dev)]
        if pos.size:
            leftovers = SparseTensor(tensor.indices[pos].astype(np.int32),
                                     tensor.values[pos].astype(np.float32), tensor.shape)
            # Its own order, whatever the shards': the residual pass is not traced.
            leftover_plan = build_mttkrp_plan(
                leftovers, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block,
                ordering="lex", order=_stable_argsort(leftovers.indices[:, mode], dev),
                device=dev)
            plan_device_buffers(leftover_plan, dev)  # uploaded here, not at the first call
        row_start = _row_start(bounds, ends)

    plan = build_mttkrp_plan(shard, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block,
                             ordering=label, order=own_order, device=dev)
    plan_device_buffers(plan, dev)
    return ShardedModeSetup(
        mode=mode, scheme=scheme, nmodes=tensor.nmodes, i_out=i_out, n_shards=n_shards,
        rank=rank, rows_per=rows_per, shard=shard, row_base=row_base, plan=plan,
        row_start=row_start, leftovers=leftovers, leftover_plan=leftover_plan,
    )


def residual_shares(tensor: SparseTensor, mode: int, n_shards: int) -> np.ndarray:
    """Per shard, the share of its ``mode_ordered`` trace (its real
    nonzeros, ``executed_input_traces(impl="sharded")``) that falls outside
    its equal-height output block: the leftovers, which the residual pass
    runs on every rank instead of the shard's plan.  Order-independent."""
    rows = tensor.indices[:, mode]
    _, _, shard_of_nnz = _row_cuts(rows, tensor.shape[mode], n_shards)
    real = tensor.values != 0
    left = real & (shard_of_nnz != rows // -(-tensor.shape[mode] // n_shards))
    traced = np.bincount(shard_of_nnz[real], minlength=n_shards)
    return np.bincount(shard_of_nnz[left], minlength=n_shards) / np.maximum(traced, 1)


def local_mttkrp(setup: ShardedModeSetup, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """This rank's MTTKRP over its shard's plan, float32, ``(..., height, R)``:
    a split-kernel launch on a CUDA device, the plain version on the CPU."""
    return mttkrp_from_plan(setup.plan, factors, out_dtype=torch.float32)


def mttkrp_sharded_apply(
    setup: ShardedModeSetup, factors: Sequence[torch.Tensor], *, group=None
) -> torch.Tensor:
    """The sharded MTTKRP over a prepared setup; ``(..., I_mode, R)`` in the
    factor dtype, the same on every rank.

    ``factors`` are ``(I_k, R)`` or batched ``(B, I_k, R)`` on the rank's
    device, replicated.  Collective: every rank of ``group`` calls it with
    its own setup of the same mode and scheme.
    """
    rank, world = require_group(group)
    if (rank, world) != (setup.rank, setup.n_shards):
        raise ValueError(f"a setup of rank {setup.rank} of {setup.n_shards} called by rank "
                         f"{rank} of {world}")
    local = local_mttkrp(setup, factors)
    if setup.scheme == "allreduce":
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=group)
        return local.to(factors[setup.mode].dtype)
    off = setup.block_offset
    mine = local[..., off : off + setup.rows_per, :].contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    out = torch.cat(parts, dim=-2)[..., : setup.i_out, :].contiguous()
    if setup.leftover_plan is not None:  # the residual pass, on every rank
        out += mttkrp_from_plan(setup.leftover_plan, factors, out_dtype=torch.float32)
    return out.to(factors[setup.mode].dtype)


def mttkrp_sharded(
    tensor: SparseTensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    group=None,
    scheme: str = "mode_ordered",
    ordering: str | None = None,
    rows_per_block: int = 256,
) -> torch.Tensor:
    """Sharded MTTKRP for ``mode``; ``(I_mode, R)`` (or ``(B, I_mode, R)``).

    Collective over ``group`` (default: the default group): every rank
    calls it with the same tensor and factors.  ``ordering`` selects each
    shard's nonzero execution order (``repro_torch.reorder``); shard
    ownership stays fixed.  ``rows_per_block`` is the plans' block height
    and the blocked strategy's; it must match the value the trace capture
    uses (``executed_input_traces``).  The setup is memoized per
    (tensor, mode, scheme, ordering, shards, rank, device) by
    ``sharded_setup``.
    """
    setup = sharded_setup(tensor, mode, scheme=scheme, ordering=ordering,
                          rows_per_block=rows_per_block, device=factors[0].device, group=group)
    return mttkrp_sharded_apply(setup, factors, group=group)


def sharded_setup(
    tensor: SparseTensor,
    mode: int,
    *,
    scheme: str = "mode_ordered",
    ordering: str | None = None,
    rows_per_block: int = 256,
    tile_nnz: int = 256,
    device: str | torch.device = DEFAULT_DEVICE,
    group=None,
) -> ShardedModeSetup:
    """This rank's ``build_sharded_mode_setup`` in ``group``, memoized per
    (tensor, mode, scheme, ordering, geometry, shards, rank, device)."""
    rank, world = require_group(group)
    dev = resolve_device(device)
    key = (mode, scheme, ordering, rows_per_block, tile_nnz, world, rank, str(dev))
    setup = _SETUP_CACHE.get(tensor, key)
    if setup is None:
        setup = _SETUP_CACHE.put(tensor, key, build_sharded_mode_setup(
            tensor, mode, world, rank=rank, scheme=scheme, ordering=ordering,
            rows_per_block=rows_per_block, tile_nnz=tile_nnz, device=dev))
    return setup


def sharded_fit_operands(
    tensor: SparseTensor,
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
    group=None,
) -> TensorOperands:
    """This rank's operands of the CP fit's inner product: the rank's equal
    block of the raw COO order (``allreduce``'s blocks), and ``||X||^2`` of
    the whole tensor.  Each rank sums ``<X, X_hat>`` over its block and
    ``all_reduce_sum`` adds the blocks.  Memoized per (tensor, shards,
    rank, device, dtype)."""
    rank, world = require_group(group)
    dev = resolve_device(device)
    key = (world, rank, str(dev), str(dtype))
    ops = _FIT_CACHE.get(tensor, key)
    if ops is None:
        per = -(-tensor.nnz // world)
        lo, hi = min(rank * per, tensor.nnz), min((rank + 1) * per, tensor.nnz)
        norm2 = float((tensor.values.astype(np.float64) ** 2).sum())
        ops = _FIT_CACHE.put(tensor, key, TensorOperands(
            indices=torch.as_tensor(np.array(tensor.indices[lo:hi], np.int32), device=dev),
            values=torch.as_tensor(np.array(tensor.values[lo:hi]), device=dev).to(dtype),
            norm2=torch.tensor(norm2, dtype=dtype, device=dev),
        ))
    return ops


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor)."""
    flat = x.reshape(-1).clone()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat.view(x.shape)
