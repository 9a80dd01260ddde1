"""The split MTTKRP kernel's partition of the nonzero stream, in plain PyTorch.

``csrc/mttkrp_split.cu`` gives each warp of its grid an equal slice of the
plan's padded nonzero stream (``slice_bounds``).  In its row-run mode a
warp stores the rows whose run starts and ends inside its slice,
zero-fills the empty rows between two of its runs, and leaves its first
and last run as carries; a second launch sums the carries of each shared
row in slice order, stores it once and zero-fills the empty rows between
slices.  In its tile mode a warp accumulates each output block it touches
in a tile, stores the tiles of the blocks that start and end inside its
slice, and leaves the tiles of its first and last block as carries; a
second launch sums each shared block's carry tiles in slice order and
stores the block once.

``emulate_split`` (row-run mode) and ``emulate_tiles`` (tile mode) replay
those launches on the CPU, with a count of the stores each output row
receives, so that a test can show that every row is stored exactly once
and that the result is the MTTKRP.  They sum in another order than the
kernel and are used by tests only; the kernel's arithmetic is held
against ``ref.mttkrp_plan_ref`` on the card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = ["emulate_split", "emulate_tiles", "real_mask", "slice_bounds"]


def slice_bounds(nnz_pad: int, slices: int) -> np.ndarray:
    """(slices + 1,) int64: slice ``w`` is ``[bounds[w], bounds[w + 1])``,
    ``nnz_pad * w // slices`` as the kernel computes it from ``w``."""
    return nnz_pad * np.arange(slices + 1, dtype=np.int64) // slices


def real_mask(plan_bufs: "PlanBuffers") -> torch.Tensor:
    """(nnz_pad,) bool: the entries the kernel reads as nonzeros, i.e. not
    past their block's ``block_real_end``."""
    start = plan_bufs.block_nnz_start
    pos = torch.arange(int(plan_bufs.values.shape[0]), dtype=torch.int64)
    blk = torch.searchsorted(start, pos, right=True) - 1
    return pos < plan_bufs.block_real_end[blk]


def _products(plan_bufs: "PlanBuffers", factors: Sequence[torch.Tensor], mode: int):
    """Every stream entry's product, ``(..., nnz_pad, R)`` float32."""
    indices, values = plan_bufs.indices, plan_bufs.values
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    prod = values.to(torch.float32)[:, None].expand(lead + (values.shape[0], rank))
    for k, f in enumerate(factors):
        if k != mode:
            prod = prod * f.index_select(-2, indices[:, k]).to(torch.float32)
    return prod


def emulate_split(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    slices: int,
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Both launches of the split kernel over ``slices`` slices.

    Returns ``(out, stores, carry_rows)``: the ``(..., i_out, R)`` float32
    output (rows never stored stay NaN), the number of stores each output
    row received, and the ``(slices, 2)`` rows of the carries (-1: none).
    """
    indices, values = plan_bufs.indices, plan_bufs.values
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    real = real_mask(plan_bufs)
    prod = _products(plan_bufs, factors, mode)

    out = torch.full(lead + (i_out, rank), float("nan"))
    stores = torch.zeros(i_out, dtype=torch.int64)

    def store(rows: slice | int, value) -> None:
        out[..., rows, :] = value
        stores[rows] += 1

    # Launch 1: each slice's interior runs, its gaps and its carries.
    bounds = slice_bounds(int(values.shape[0]), slices)
    carry_row = np.full((slices, 2), -1, dtype=np.int64)
    carry_val = torch.zeros((slices, 2) + lead + (rank,))
    for w in range(slices):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        keep = real[lo:hi]
        rows = indices[lo:hi, mode][keep]
        if rows.numel() == 0:
            continue
        runs, counts = torch.unique_consecutive(rows, return_counts=True)
        seg = torch.repeat_interleave(torch.arange(runs.numel()), counts)
        terms = prod[..., lo:hi, :][..., keep, :]
        sums = torch.zeros(lead + (runs.numel(), rank)).index_add_(-2, seg, terms)
        runs = runs.tolist()
        carry_row[w, 0] = runs[0]
        carry_val[w, 0] = sums[..., 0, :]
        for j in range(1, len(runs)):
            if runs[j - 1] + 1 < runs[j]:
                store(slice(runs[j - 1] + 1, runs[j]), 0.0)
            if j < len(runs) - 1:
                store(runs[j], sums[..., j, :])
        if len(runs) > 1:
            carry_row[w, 1] = runs[-1]
            carry_val[w, 1] = sums[..., -1, :]

    # Launch 2: one step per slice, and one after the last slice.
    def finish(v: int, row: int, slot: int, goes_on: bool) -> None:
        total = carry_val[v, slot].clone()
        j = v + 1
        while goes_on and j < slices:
            first, last = carry_row[j]
            if first == row:
                total += carry_val[j, 0]
                if last >= 0:
                    break
            elif first != -1:
                break
            j += 1
        store(row, total)

    prev = -1  # the last real row before slice v
    for v in range(slices):
        first, last = (int(r) for r in carry_row[v])
        if first < 0:
            continue
        if first != prev:
            if prev + 1 < first:
                store(slice(prev + 1, first), 0.0)
            finish(v, first, 0, last < 0)
        if last >= 0:
            finish(v, last, 1, True)
        prev = last if last >= 0 else first
    if prev + 1 < i_out:
        store(slice(prev + 1, i_out), 0.0)
    return out, stores, carry_row


def emulate_tiles(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    slices: int,
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Both launches of the split kernel's tile mode over ``slices`` slices.

    Returns ``(out, stores, carry_blocks)``: the ``(..., i_out, R)`` float32
    output (rows never stored stay NaN), the number of stores each output
    row received, and the ``(slices, 2)`` blocks of each slice's carry
    tiles (-1: none).
    """
    indices = plan_bufs.indices
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    rpb = int(plan_bufs.rows_per_block)
    real = real_mask(plan_bufs)
    prod = _products(plan_bufs, factors, mode)
    starts = plan_bufs.block_nnz_start.numpy()
    num_blocks = starts.shape[0] - 1

    out = torch.full(lead + (i_out, rank), float("nan"))
    stores = torch.zeros(i_out, dtype=torch.int64)

    def store(block: int, tile: torch.Tensor) -> None:
        rows = slice(block * rpb, min((block + 1) * rpb, i_out))
        out[..., rows, :] = tile[..., : max(rows.stop - rows.start, 0), :]
        stores[rows] += 1

    # Launch 1: each slice's tiles, stored whole or left as carries.
    bounds = slice_bounds(int(plan_bufs.values.shape[0]), slices)
    carry_blk = np.full((slices, 2), -1, dtype=np.int64)
    carry_val: dict[tuple[int, int], torch.Tensor] = {}
    for w in range(slices):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        if lo == hi:
            continue
        first = int(np.searchsorted(starts, lo, side="right")) - 1
        last = int(np.searchsorted(starts, hi - 1, side="right")) - 1
        for b in range(first, last + 1):
            a, z = max(lo, int(starts[b])), min(hi, int(starts[b + 1]))
            keep = real[a:z]
            local = indices[a:z, mode][keep] - b * rpb
            tile = torch.zeros(lead + (rpb, rank)).index_add_(
                -2, local, prod[..., a:z, :][..., keep, :])
            if starts[b] >= lo and starts[b + 1] <= hi:
                store(b, tile)
            else:
                slot = 0 if b == first else 1
                carry_blk[w, slot] = b
                carry_val[w, slot] = tile

    # Launch 2: each shared block's carry tiles, summed in slice order.
    for b in range(num_blocks):
        holders = [(w, s) for w in range(slices) for s in (0, 1) if carry_blk[w, s] == b]
        if holders:
            total = carry_val[holders[0]].clone()
            for h in holders[1:]:
                total += carry_val[h]
            store(b, total)
    return out, stores, carry_blk
