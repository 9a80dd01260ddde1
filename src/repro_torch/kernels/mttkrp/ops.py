"""Plan-based MTTKRP: plan memo, device residency and dispatch.

The counterpart of ``repro.kernels.mttkrp.ops``.  Work splits as the paper
splits it:

  * host-side, once per (tensor, mode): the mode-ordered linearization
    (``core.sparse_tensor.build_mttkrp_plan``), memoized by ``get_plan``;
  * once per (plan, device): the upload of the plan's arrays, memoized by
    ``plan_device_buffers``;
  * per call: one kernel launch.

Dispatch is by the factors' device, with no override: CUDA tensors go to
the hand-written kernel (``kernel.mttkrp_cuda``), CPU tensors to its plain
PyTorch version (``ref.mttkrp_plan_ref``).  Any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.memo import IdentityKeyedCache
from repro_torch.core.sparse_tensor import MTTKRPPlan, SparseTensor, build_mttkrp_plan
from repro_torch.device import resolve_device
from repro_torch.kernels.mttkrp.kernel import mttkrp_cuda
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref

__all__ = [
    "PlanBuffers",
    "TensorOperands",
    "block_nnz_start",
    "block_real_end",
    "clear_caches",
    "get_plan",
    "mttkrp_from_plan",
    "mttkrp_kernel",
    "plan_device_buffers",
    "tensor_device_operands",
]

# Plan memo per source tensor, keyed by the plan geometry.
_PLAN_CACHE = IdentityKeyedCache()
# Device residency memo per (plan, device): every CP-ALS iteration and every
# fused sweep reuses the same buffers instead of re-staging the plan.
_BUFFER_CACHE = IdentityKeyedCache()
# Device residency memo per (tensor, device, dtype): the raw COO operands
# the CP fit reads.
_OPERAND_CACHE = IdentityKeyedCache()


def clear_caches() -> None:
    """Drop every memoized plan and device buffer (they pin their tensors)."""
    for cache in (_PLAN_CACHE, _BUFFER_CACHE, _OPERAND_CACHE):
        cache.clear()


class PlanBuffers(NamedTuple):
    """Device-resident copies of an ``MTTKRPPlan``'s kernel operands."""

    indices: torch.Tensor  # (nnz_pad, nmodes) int32
    values: torch.Tensor  # (nnz_pad,) float32
    local_row: torch.Tensor  # (nnz_pad,) int32
    block_nnz_start: torch.Tensor  # (num_blocks + 1,) int64 nonzero offset per block
    block_real_end: torch.Tensor  # (num_blocks,) int64 end of each block's real nonzeros
    rows_per_block: int
    index_bound: tuple[int, ...]  # per mode, 1 + the largest index (checked on the host)


class TensorOperands(NamedTuple):
    """Device-resident COO operands of one ``SparseTensor``; ``norm2`` is
    ``||X||^2`` summed in float64, as the CP-ALS drivers need it."""

    indices: torch.Tensor  # (nnz, nmodes) int32
    values: torch.Tensor  # (nnz,)
    norm2: torch.Tensor  # scalar


def block_nnz_start(plan: MTTKRPPlan) -> np.ndarray:
    """(num_blocks + 1,) int64: block ``b``'s nonzeros are ``[start[b], start[b+1])``."""
    first_tile = np.searchsorted(plan.tile_block, np.arange(plan.num_blocks + 1), side="left")
    return first_tile.astype(np.int64) * plan.tile_nnz


def block_real_end(plan: MTTKRPPlan) -> np.ndarray:
    """(num_blocks,) int64: block ``b``'s real nonzeros are
    ``[start[b], real_end[b])``; the rest of the block, up to ``start[b+1]``,
    is padding.

    The plan keeps no count, so the padding is read back from the arrays:
    it is the suffix of the block's last tile (a block pads to whole tiles,
    so never past its last tile) whose entries have value 0, the block's
    first row and every other coordinate 0.  A real nonzero of exactly that
    form at the end of its block counts as padding; it adds 0 to the output
    for finite factors.
    """
    start = block_nnz_start(plan)
    tile = plan.tile_nnz
    tail = start[1:, None] - tile + np.arange(tile)  # each block's last tile
    idx = plan.sorted_indices[tail]  # (num_blocks, tile, nmodes)
    first_row = (np.arange(plan.num_blocks, dtype=np.int64) * plan.rows_per_block)[:, None]
    pad = (plan.sorted_values[tail] == 0) & (idx[..., plan.mode] == first_row)
    pad &= (np.delete(idx, plan.mode, axis=-1) == 0).all(axis=-1)
    suffix = np.cumprod(pad[:, ::-1], axis=1).sum(axis=1)
    return (start[1:] - suffix).astype(np.int64)


def plan_device_buffers(plan: MTTKRPPlan, device: str | torch.device) -> PlanBuffers:
    """The plan's operands on ``device``, uploaded once per (plan, device).

    The plan's indices are checked here, on the host, to lie in
    ``[0, shape[k])``: the kernel gathers without bounds checks.
    """
    dev = resolve_device(device)
    key = (str(dev),)
    bufs = _BUFFER_CACHE.get(plan, key)
    if bufs is None:
        idx = plan.sorted_indices
        if idx.size and (idx.min() < 0 or np.any(idx.max(axis=0) >= np.asarray(plan.shape))):
            raise ValueError(f"plan indices fall outside the tensor shape {plan.shape}")
        bound = tuple(int(b) + 1 for b in idx.max(axis=0)) if idx.size else (0,) * len(plan.shape)
        bufs = _BUFFER_CACHE.put(
            plan,
            key,
            PlanBuffers(
                indices=torch.as_tensor(idx, dtype=torch.int32, device=dev),
                values=torch.as_tensor(plan.sorted_values, dtype=torch.float32, device=dev),
                local_row=torch.as_tensor(plan.local_row, dtype=torch.int32, device=dev),
                block_nnz_start=torch.as_tensor(block_nnz_start(plan), device=dev),
                block_real_end=torch.as_tensor(block_real_end(plan), device=dev),
                rows_per_block=int(plan.rows_per_block),
                index_bound=bound,
            ),
        )
    return bufs


def tensor_device_operands(
    tensor: SparseTensor,
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> TensorOperands:
    """The tensor's COO operands on ``device``, uploaded once per
    (tensor, device, dtype)."""
    dev = resolve_device(device)
    key = (str(dev), str(dtype))
    ops = _OPERAND_CACHE.get(tensor, key)
    if ops is None:
        norm2 = float((tensor.values.astype(np.float64) ** 2).sum())
        ops = _OPERAND_CACHE.put(
            tensor,
            key,
            TensorOperands(
                indices=torch.as_tensor(tensor.indices, dtype=torch.int32, device=dev),
                values=torch.as_tensor(tensor.values, device=dev).to(dtype),
                norm2=torch.tensor(norm2, dtype=dtype, device=dev),
            ),
        )
    return ops


def get_plan(
    tensor: SparseTensor,
    mode: int,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str = "lex",
) -> MTTKRPPlan:
    """The (memoized) plan of ``tensor`` for output mode ``mode``."""
    key = (mode, tile_nnz, rows_per_block, ordering)
    plan = _PLAN_CACHE.get(tensor, key)
    if plan is None:
        plan = _PLAN_CACHE.put(
            tensor,
            key,
            build_mttkrp_plan(
                tensor,
                mode,
                tile_nnz=tile_nnz,
                rows_per_block=rows_per_block,
                ordering=ordering,
            ),
        )
    return plan


def mttkrp_from_plan(plan: MTTKRPPlan, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP from a plan alone; ``(..., I_mode, R)`` in the factor dtype.

    ``factors`` are ``(I_k, R)`` or batched ``(B, I_k, R)``; the plan's
    buffers are uploaded to the factors' device once and reused.
    """
    device = factors[0].device
    bufs = plan_device_buffers(plan, device)
    i_out = plan.shape[plan.mode]
    if device.type == "cuda":
        out = mttkrp_cuda(bufs, factors, plan.mode, i_out)
    else:
        out = mttkrp_plan_ref(bufs, factors, plan.mode, i_out)
    return out.to(factors[plan.mode].dtype)


def mttkrp_kernel(
    tensor: SparseTensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    plan: MTTKRPPlan | None = None,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str = "lex",
) -> torch.Tensor:
    """MTTKRP for ``mode`` via the plan-based kernel family; ``(I_mode, R)``.

    The counterpart of ``repro.kernels.mttkrp.ops.mttkrp_pallas``.  The
    plan geometry (``tile_nnz``, ``rows_per_block``, ``ordering``) only
    matters when ``plan`` is not given.
    """
    if plan is None:
        plan = get_plan(
            tensor,
            mode,
            tile_nnz=tile_nnz,
            rows_per_block=rows_per_block,
            ordering=ordering,
        )
    return mttkrp_from_plan(plan, factors)
