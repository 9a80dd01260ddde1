"""Plan-based MTTKRP: plan memo, device residency and dispatch.

The counterpart of ``repro.kernels.mttkrp.ops``.  Work splits as the paper
splits it:

  * host-side, once per (tensor, mode): the mode-ordered linearization
    (``core.sparse_tensor.build_mttkrp_plan``), memoized by ``get_plan``;
  * once per (plan, device): the upload of the plan's arrays, memoized by
    ``plan_device_buffers``;
  * per call: one kernel launch.

The service (``repro_torch.serve``) runs B distinct tensors of one padded
geometry as one block-diagonal tensor, tensor ``b``'s coordinates offset
by ``b`` times each padded dimension, so that one launch covers the whole
batch: ``stacked_operands`` uploads the batch and ``stacked_plan_buffers``
builds its plan on the device, per batch, with nothing memoized.

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
from repro_torch.device import DEFAULT_DEVICE, resolve_device
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
    "stacked_operands",
    "stacked_plan_buffers",
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
    index_bound: tuple[int, ...]  # per mode, above every index (checked on the host)
    # Each output row's nonzeros are one run of the stream (MTTKRPPlan.rows_contiguous):
    # the split kernel's row-run mode needs it, its tile mode does not.
    rows_contiguous: bool


class TensorOperands(NamedTuple):
    """Device-resident COO operands of one ``SparseTensor``; ``norm2`` is
    ``||X||^2`` over the real values, summed in float64, as CP-ALS
    needs it.  ``indices``/``values`` may be padded past the real
    nonzeros with value-0 entries at coordinate (0, ..., 0)."""

    indices: torch.Tensor  # (nnz_pad, nmodes) int32
    values: torch.Tensor  # (nnz_pad,)
    norm2: torch.Tensor  # scalar

    @property
    def nnz_pad(self) -> int:
        return int(self.values.shape[0])


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


def _upload(plan: MTTKRPPlan, dev: torch.device) -> PlanBuffers:
    """The plan's operands on ``dev``; its indices are checked here, on the
    host, to lie in ``[0, shape[k])``: the kernel gathers without bounds
    checks."""
    idx = plan.sorted_indices
    # Column by column: numpy's reduction over axis 0 of (nnz, N) is five times slower.
    low = [int(idx[:, k].min()) for k in range(idx.shape[1])] if idx.size else []
    high = [int(idx[:, k].max()) for k in range(idx.shape[1])] if idx.size else []
    if idx.size and (min(low) < 0 or any(h >= s for h, s in zip(high, plan.shape))):
        raise ValueError(f"plan indices fall outside the tensor shape {plan.shape}")
    bound = tuple(h + 1 for h in high) if idx.size else (0,) * len(plan.shape)
    return PlanBuffers(
        indices=torch.as_tensor(idx, dtype=torch.int32, device=dev),
        values=torch.as_tensor(plan.sorted_values, dtype=torch.float32, device=dev),
        local_row=torch.as_tensor(plan.local_row, dtype=torch.int32, device=dev),
        block_nnz_start=torch.as_tensor(block_nnz_start(plan), device=dev),
        block_real_end=torch.as_tensor(block_real_end(plan), device=dev),
        rows_per_block=int(plan.rows_per_block),
        index_bound=bound,
        rows_contiguous=plan.rows_contiguous,
    )


def plan_device_buffers(plan: MTTKRPPlan, device: str | torch.device) -> PlanBuffers:
    """The plan's operands on ``device``, uploaded once per (plan, device)."""
    dev = resolve_device(device)
    key = (str(dev),)
    bufs = _BUFFER_CACHE.get(plan, key)
    if bufs is None:
        bufs = _BUFFER_CACHE.put(plan, key, _upload(plan, dev))
    return bufs


def _bucket_rows_per_block(dims: Sequence[int], mode: int) -> int:
    """Rows per output block of a stacked plan: 256, or the whole padded
    dimension when it is smaller.  Both are powers of two, so each tensor's
    rows in a stacked plan are whole blocks."""
    return min(256, int(dims[mode]))


def _host_to(array: np.ndarray, out: torch.Tensor) -> None:
    """Copy ``array`` into ``out``; to the card from pinned memory, a copy
    that does not wait for the work already queued."""
    src = torch.from_numpy(array)
    if out.device.type == "cuda":
        out.copy_(src.pin_memory(), non_blocking=True)
    else:
        out.copy_(src)


def stacked_operands(
    tensors: Sequence[SparseTensor],
    dims: Sequence[int],
    nnz_pad: int,
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B tensors' COO operands as one batch on ``device``: ``indices``
    ``(B, nnz_pad, N)`` int32, ``values`` ``(B, nnz_pad)`` and ``norm2``
    ``(B,)`` (over the real values, summed in float64), padded as
    ``tensor_device_operands`` pads one tensor.

    Nothing is memoized: each call uploads its tensors once each (a tensor
    repeated in the batch, as the service's pad slots repeat request 0, is
    copied on the device), and on the card no copy waits for the device.
    The indices are checked here, on the host, to lie in each tensor's
    shape, and the shapes to fit ``dims``: the kernel gathers without
    bounds checks.
    """
    dims = tuple(int(d) for d in dims)
    dev = resolve_device(device)
    if not tensors:
        raise ValueError("stacked_operands needs at least one tensor")
    indices = torch.zeros((len(tensors), nnz_pad, len(dims)), dtype=torch.int32, device=dev)
    values = torch.zeros((len(tensors), nnz_pad), dtype=dtype, device=dev)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    first: dict[int, int] = {}
    for b, t in enumerate(tensors):
        src = first.setdefault(id(t), b)
        if src != b:
            indices[b].copy_(indices[src])
            values[b].copy_(values[src])
            continue
        if t.nmodes != len(dims) or any(d < s for d, s in zip(dims, t.shape)):
            raise ValueError(f"tensor of shape {t.shape} does not fit the bucket dims {dims}")
        if t.nnz > nnz_pad:
            raise ValueError(f"nnz_pad={nnz_pad} < tensor nnz {t.nnz}")
        idx = np.ascontiguousarray(t.indices, dtype=np.int32)
        # Read as unsigned, a negative index is above every bound.  Column by
        # column: numpy's reduction over axis 0 of (nnz, N) is five times slower.
        if any(idx[:, k].view(np.uint32).max() >= s for k, s in enumerate(t.shape)):
            raise ValueError(f"tensor indices fall outside its shape {t.shape}")
        _host_to(idx, indices[b, : t.nnz])
        _host_to(np.ascontiguousarray(t.values, dtype=np_dtype), values[b, : t.nnz])
    norm2 = values.to(torch.float64).square().sum(-1).to(dtype)
    return indices, values, norm2


def stacked_plan_buffers(
    indices: torch.Tensor,
    values: torch.Tensor,
    nnz: Sequence[int],
    dims: Sequence[int],
    mode: int,
    *,
    tile_nnz: int = 256,
) -> PlanBuffers:
    """One plan for B tensors of one padded geometry, built on the device
    from their batched operands (``stacked_operands``): the plan of their
    block-diagonal tensor, whose MTTKRP is the B MTTKRPs stacked.

    ``indices`` ``(B, nnz_pad, N)`` and ``values`` ``(B, nnz_pad)`` hold
    tensor ``b``'s ``nnz[b]`` nonzeros first; each coordinate must lie in
    ``[0, dims[k])``, which is not checked here.  Tensor ``b``'s
    coordinates are offset by ``b * dims[k]`` in every mode, so its output
    rows are ``[b * dims[mode], (b + 1) * dims[mode])`` and its factors rows
    ``[b * dims[k], (b + 1) * dims[k])`` of the stacked ``(B * dims[k], R)``
    factors.  The arrays are ``build_mttkrp_plan``'s for that tensor
    (``rows_per_block = min(256, dims[mode])``, so no block holds two
    tensors' rows), with one difference: the stream has a length fixed on
    the host, each tensor's ``nnz[b] + blocks * tile_nnz`` in whole tiles,
    and what the blocks do not fill is more padding of the last block.  The
    host then needs no count from the device: the build enqueues a stable
    sort and scatters, and waits for nothing.
    """
    dims = tuple(int(d) for d in dims)
    batch, nmodes = int(indices.shape[0]), len(dims)
    dev = indices.device
    if len(nnz) != batch or not batch:
        raise ValueError(f"{len(nnz)} nonzero counts for a batch of {batch}")
    if batch * max(dims) >= 2**31:
        raise ValueError(f"a batch of {batch} at dims {dims} overflows int32 coordinates")
    rpb = _bucket_rows_per_block(dims, mode)
    blocks = dims[mode] // rpb
    nb = batch * blocks
    length = sum((int(n) + blocks * tile_nnz) // tile_nnz * tile_nnz for n in nnz)

    offsets = torch.stack(
        [torch.arange(batch, dtype=torch.int32, device=dev) * d for d in dims], dim=1)
    real_idx = torch.cat([indices[b, :n] + offsets[b] for b, n in enumerate(nnz)])
    real_val = torch.cat([values[b, :n] for b, n in enumerate(nnz)]).to(torch.float32)
    rows, order = torch.sort(real_idx[:, mode], stable=True)
    src_start = torch.searchsorted(
        rows, torch.arange(nb + 1, dtype=torch.int32, device=dev) * rpb)
    count = src_start[1:] - src_start[:-1]
    padded = torch.clamp(-(-count // tile_nnz) * tile_nnz, min=tile_nnz)
    padded[-1] += length - padded.sum()
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(padded, 0)])
    blk = rows.to(torch.int64) // rpb
    pos = torch.arange(rows.shape[0], device=dev) - src_start[blk] + start[blk]

    out_idx = torch.zeros((length, nmodes), dtype=torch.int32, device=dev)
    # Padding: value 0 at its block's first row, 0 in every other coordinate.
    pad_block = torch.searchsorted(start[1:], torch.arange(length, device=dev), right=True)
    out_idx[:, mode] = (pad_block * rpb).to(torch.int32)
    out_idx.index_copy_(0, pos, real_idx[order])
    out_val = torch.zeros(length, dtype=torch.float32, device=dev)
    out_val.index_copy_(0, pos, real_val[order])
    local = torch.zeros(length, dtype=torch.int32, device=dev)
    local.index_copy_(0, pos, (rows - (blk * rpb).to(torch.int32)))
    return PlanBuffers(
        indices=out_idx,
        values=out_val,
        local_row=local,
        block_nnz_start=start,
        block_real_end=start[:-1] + count,
        rows_per_block=rpb,
        index_bound=tuple(batch * d for d in dims),
        rows_contiguous=True,  # the stream is sorted by (block-diagonal) output row
    )


def tensor_device_operands(
    tensor: SparseTensor,
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
    nnz_pad: int | None = None,
) -> TensorOperands:
    """The tensor's COO operands on ``device``, uploaded once per
    (tensor, device, dtype, nnz_pad).

    ``nnz_pad`` pads the nonzero stream to a fixed length so tensors of
    different nnz can share one bucket (``repro_torch.serve``); ``None``
    keeps the exact length.  Padding entries carry value 0 at coordinate
    (0, ..., 0): they gather a real factor row and add an exact 0.
    """
    if nnz_pad is None:
        nnz_pad = tensor.nnz
    if nnz_pad < tensor.nnz:
        raise ValueError(f"nnz_pad={nnz_pad} < tensor nnz {tensor.nnz}")
    dev = resolve_device(device)
    key = (str(dev), str(dtype), int(nnz_pad))
    ops = _OPERAND_CACHE.get(tensor, key)
    if ops is None:
        idx, val = tensor.indices, tensor.values
        if nnz_pad > tensor.nnz:
            idx = np.zeros((nnz_pad, tensor.nmodes), dtype=idx.dtype)
            val = np.zeros((nnz_pad,), dtype=val.dtype)
            idx[: tensor.nnz] = tensor.indices
            val[: tensor.nnz] = tensor.values
        norm2 = float((tensor.values.astype(np.float64) ** 2).sum())
        ops = _OPERAND_CACHE.put(
            tensor,
            key,
            TensorOperands(
                indices=torch.as_tensor(idx, dtype=torch.int32, device=dev),
                values=torch.as_tensor(val, device=dev).to(dtype),
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
    device: str | torch.device = DEFAULT_DEVICE,
) -> MTTKRPPlan:
    """The (memoized) plan of ``tensor`` for output mode ``mode``; an
    ordering other than ``"lex"`` is sorted on ``device``."""
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
                device=device,
            ),
        )
    return plan


def mttkrp_from_plan(
    plan: MTTKRPPlan, factors: Sequence[torch.Tensor], *, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """MTTKRP from a plan alone; ``(..., I_mode, R)`` in ``out_dtype``
    (default: the factor dtype; the sum itself is float32).

    ``factors`` are ``(I_k, R)`` or batched ``(B, I_k, R)``; the plan's
    buffers are uploaded to the factors' device once and reused.  On a
    CUDA device the call is one launch of the split kernel, on the CPU
    the kernel's plain version.
    """
    device = factors[0].device
    bufs = plan_device_buffers(plan, device)
    i_out = plan.shape[plan.mode]
    if device.type == "cuda":
        out = mttkrp_cuda(bufs, factors, plan.mode, i_out)
    else:
        out = mttkrp_plan_ref(bufs, factors, plan.mode, i_out)
    return out.to(factors[plan.mode].dtype if out_dtype is None else out_dtype)


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
    matters when ``plan`` is not given; an ordered plan is sorted on the
    factors' device.
    """
    if plan is None:
        plan = get_plan(
            tensor,
            mode,
            tile_nnz=tile_nnz,
            rows_per_block=rows_per_block,
            ordering=ordering,
            device=factors[0].device,
        )
    return mttkrp_from_plan(plan, factors)
