"""The split MTTKRP kernel's partition of the nonzero stream, in plain PyTorch.

``csrc/mttkrp_split.cu`` gives each warp of its grid an equal slice of the
plan's padded nonzero stream (``slice_bounds``).  In its row-run mode a
warp stores the rows whose run starts and ends inside its slice,
zero-fills the empty rows between two of its runs, and leaves its first
and last run as carries; a second launch sums the carries of each shared
row in slice order, stores it once and zero-fills the empty rows between
slices.  Its tile mode slices the stream by CTA instead: a CTA
accumulates each output block it touches in a shared-memory tile (each of
its warps half the columns of one of the pass's ``b_pass`` restarts), stores
the tiles of the blocks that start and end inside its slice, and leaves
the tiles of its first and last block as carries; a second launch sums
each shared block's carry tiles in slice order and stores the block once.
Within a slice a warp takes 16 entries a step, 2 lanes each, from a
multiple of 4 entries at or before the slice's start, and adds a step's
entries of one block to the tile by runs of one row, one turn per
non-descending segment of rows.

``emulate_split`` (row-run mode) and ``emulate_tiles`` (tile mode) replay
those launches on the CPU, with a count of the stores each output element
receives, so that a test can show that every row is stored exactly once
and that the result is the MTTKRP; ``emulate_tiles`` also replays the
steps and checks that no two lanes of one turn add to one row.  They sum
in another order than the kernel and are used by tests only; the
kernel's arithmetic is held against ``ref.mttkrp_plan_ref`` on the card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = ["TileReplay", "emulate_split", "emulate_tiles", "real_mask", "slice_bounds"]

TILE_STEP = 16  # entries per warp step of the tile mode, 2 lanes each
TILE_ALIGN = 4  # a CTA's steps start at a multiple of this many entries


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


class TileReplay(NamedTuple):
    """What ``emulate_tiles`` returns."""

    out: torch.Tensor  # (..., i_out, R) float32; elements never stored stay NaN
    stores: torch.Tensor  # (..., i_out) int64: the stores each output element received
    carry_blocks: np.ndarray  # (ctas, 2) int64: each slice's carry tiles' blocks (-1: none)
    max_turns: int  # the most turns a warp step's entries of one block took
    repeated_rows: int  # warp steps whose entries of one block hold a row in two runs


def _step_turns(rows: np.ndarray, blocks: np.ndarray, real: np.ndarray, lo: int, hi: int,
                rpb: int) -> tuple[int, int]:
    """The tile mode's warp steps over one slice ``[lo, hi)`` of the stream:
    ``(max_turns, repeated_rows)``.  Raises ``AssertionError`` if two lanes
    of one turn would add to one tile row."""
    pos = np.arange(lo, hi)
    keep = real[lo:hi]
    pos, blk = pos[keep], blocks[lo:hi][keep]
    if pos.size == 0:
        return 0, 0
    key = rows[pos] - blk * rpb
    step = (pos - (lo - lo % TILE_ALIGN)) // TILE_STEP
    # A step's entries of one block are one contiguous range of lanes.
    same_prev = np.zeros(pos.size, bool)
    same_prev[1:] = (step[1:] == step[:-1]) & (blk[1:] == blk[:-1])
    group = np.cumsum(~same_prev) - 1
    key_prev = np.concatenate([[-1], key[:-1]])
    head = ~same_prev | (key != key_prev)
    desc = same_prev & (key_prev > key)
    seg = np.cumsum(desc)
    seg = seg - seg[np.flatnonzero(~same_prev)][group]  # turn of each entry, from 0
    tail = np.concatenate([head[1:], [True]])
    t_group, t_seg, t_key = group[tail], seg[tail], key[tail]
    # Within a turn the rows of the runs' last lanes differ.
    turn_rows = np.unique(np.stack([t_group, t_seg, t_key]), axis=1).shape[1]
    if turn_rows != t_key.size:
        raise AssertionError("two lanes of one turn add to one tile row")
    pairs, counts = np.unique(np.stack([t_group, t_key]), axis=1, return_counts=True)
    repeated = np.unique(pairs[0][counts > 1]).size
    return int(seg.max()) + 1, int(repeated)


def emulate_tiles(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    ctas: int,
    b_pass: int = 1,
) -> TileReplay:
    """Both launches of the split kernel's tile mode over ``ctas`` slices,
    ``b_pass`` restarts a pass over the stream (the last pass ragged when
    ``b_pass`` does not divide the batch)."""
    indices = plan_bufs.indices
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    batch = lead[0] if lead else 1
    rpb = int(plan_bufs.rows_per_block)
    real = real_mask(plan_bufs)
    prod = _products(plan_bufs, factors, mode).reshape((batch, -1, rank))
    starts = plan_bufs.block_nnz_start.numpy()
    num_blocks = starts.shape[0] - 1
    nnz_pad = int(plan_bufs.values.shape[0])
    pos = np.arange(nnz_pad)
    blocks = np.searchsorted(starts, pos, side="right") - 1
    rows = indices[:, mode].numpy().astype(np.int64)

    out = torch.full((batch, i_out, rank), float("nan"))
    stores = torch.zeros((batch, i_out), dtype=torch.int64)

    def store(block: int, restarts: slice, tile: torch.Tensor) -> None:
        rows_ = slice(block * rpb, min((block + 1) * rpb, i_out))
        out[restarts, rows_, :] = tile[:, : max(rows_.stop - rows_.start, 0), :]
        stores[restarts, rows_] += 1

    bounds = slice_bounds(nnz_pad, ctas)
    carry_blk = np.full((ctas, 2), -1, dtype=np.int64)
    max_turns = repeated_rows = 0
    for c in range(ctas):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        if lo < hi:
            turns, repeated = _step_turns(rows, blocks, real.numpy(), lo, hi, rpb)
            max_turns = max(max_turns, turns)
            repeated_rows += repeated
    for b0 in range(0, batch, b_pass):
        restarts = slice(b0, min(b0 + b_pass, batch))
        # Launch 1: each slice's tiles, stored whole or left as carries.
        carry_val: dict[tuple[int, int], torch.Tensor] = {}
        for c in range(ctas):
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            if lo == hi:
                continue
            first, last = int(blocks[lo]), int(blocks[hi - 1])
            for blk in range(first, last + 1):
                a, z = max(lo, int(starts[blk])), min(hi, int(starts[blk + 1]))
                keep = real[a:z]
                local = indices[a:z, mode][keep] - blk * rpb
                tile = torch.zeros((restarts.stop - b0, rpb, rank)).index_add_(
                    1, local, prod[restarts, a:z, :][:, keep, :])
                if starts[blk] >= lo and starts[blk + 1] <= hi:
                    store(blk, restarts, tile)
                else:
                    slot = 0 if blk == first else 1
                    carry_blk[c, slot] = blk
                    carry_val[c, slot] = tile
        # Launch 2: each shared block's carry tiles, summed in slice order.
        for blk in range(num_blocks):
            holders = [(c, s) for c in range(ctas) for s in (0, 1) if carry_blk[c, s] == blk]
            if holders:
                total = carry_val[holders[0]].clone()
                for h in holders[1:]:
                    total += carry_val[h]
                store(blk, restarts, total)
    if not lead:
        out, stores = out[0], stores[0]
    return TileReplay(out, stores, carry_blk, max_turns, repeated_rows)
