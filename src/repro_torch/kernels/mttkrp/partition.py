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
steps and checks that no two lanes of one turn add to one row.  Both count
what the kernel consumes (``census``: the values, index columns and factor
rows of the nonzeros, and the output elements stored, per restart), and
both start launch 1's carries as NaN with a written flag per slot, and
count launch 2's reads of a slot launch 1 did not write (``uninit_reads``)
or marked empty (``unmarked_reads``).  ``repro_torch.analysis`` holds them
to the kernel contracts; ``stream_entries_read`` gives the entries the
kernel reads or stages, which its audit build counts on the card.  They sum
in another order than the kernel and are used by tests and the analysis
only; the kernel's arithmetic is held against ``ref.mttkrp_plan_ref`` on
the card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = ["SplitReplay", "TileReplay", "emulate_split", "emulate_tiles", "real_mask",
           "slice_bounds", "stream_entries_read"]

TILE_STEP = 16  # entries per warp step of the tile mode, 2 lanes each
TILE_ALIGN = 4  # a CTA's steps start at a multiple of this many entries
ROW_STEP = 8  # entries per warp step of the row-run mode, 4 lanes each
ROW_UNROLL = {True: 4, False: 2}  # the row-run mode's steps in flight, by batch == 1


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


def stream_entries_read(nnz_pad: int, slices: int, split_mode: str, batch: int = 1) -> int:
    """Stream entries the kernel reads in its first pass over the stream: in
    the row-run mode each warp's whole steps over its slice (an entry past
    the slice is read again in its last entry's place), in the tile mode the
    entries each CTA stages, from a multiple of ``TILE_ALIGN`` at or before
    its slice's start to one at or after its end, cut at the stream's end."""
    bounds = slice_bounds(nnz_pad, slices)
    lo, hi = bounds[:-1], bounds[1:]
    busy = hi > lo
    if split_mode == "tiles":
        a0 = lo - lo % TILE_ALIGN
        hi4 = np.minimum(-(-hi // TILE_ALIGN) * TILE_ALIGN, nnz_pad)
        return int((hi4 - a0)[busy].sum())
    step = ROW_STEP * ROW_UNROLL[batch == 1]
    return int((-(-(hi - lo) // step) * step)[busy].sum())


class _Census:
    """What a replay consumes, per restart: each nonzero's value, its row
    column and the columns of the factors it gathers, and those rows."""

    def __init__(self, batch: int) -> None:
        self.per_restart = [dict(values=0, indices=0, factor_rows=0, output_stores=0)
                            for _ in range(batch)]

    def products(self, plan_bufs: "PlanBuffers", factors: Sequence[torch.Tensor], mode: int,
                 pos: torch.Tensor, restarts: range) -> torch.Tensor:
        """The products of the nonzeros at stream positions ``pos``,
        ``(len(restarts), len(pos), R)`` float32 (``(len(pos), R)`` for
        unbatched factors), counted as consumed by ``restarts``."""
        n = int(pos.numel())
        prod = plan_bufs.values[pos].to(torch.float32)[:, None]
        gathered = 0
        for k, f in enumerate(factors):
            if k != mode:
                rows = f.index_select(-2, plan_bufs.indices[pos, k])
                if rows.dim() == 3:
                    rows = rows[restarts.start:restarts.stop]
                prod = prod * rows.to(torch.float32)
                gathered += 1
        for b in restarts:
            c = self.per_restart[b]
            c["values"] += n
            c["indices"] += n * (1 + gathered)  # the row column and the gathered ones
            c["factor_rows"] += n * gathered
        return prod


class _Carries:
    """Launch 1's carry slots, two per slice: values start as NaN, each slot
    with a written flag and its row or block (-1: none); launch 2's reads are
    counted, with those of a slot never written or marked -1."""

    def __init__(self, slices: int, shape: tuple[int, ...]) -> None:
        self.val = torch.full((slices, 2) + shape, float("nan"))
        self.written = np.zeros((slices, 2), dtype=bool)
        self.key = np.full((slices, 2), -1, dtype=np.int64)
        self.reads = self.uninit = self.unmarked = 0

    def put(self, w: int, slot: int, key: int, value: torch.Tensor) -> None:
        self.key[w, slot] = key
        self.val[w, slot] = value
        self.written[w, slot] = True

    def get(self, w: int, slot: int) -> torch.Tensor:
        self.reads += 1
        self.uninit += not self.written[w, slot]
        self.unmarked += self.key[w, slot] < 0
        return self.val[w, slot]


class SplitReplay(NamedTuple):
    """What ``emulate_split`` returns."""

    out: torch.Tensor  # (..., i_out, R) float32; rows never stored stay NaN
    stores: torch.Tensor  # (i_out,) int64: the stores each output row received
    carry_rows: np.ndarray  # (slices, 2) int64: each slice's carry rows (-1: none)
    census: list[dict]  # per restart: values, indices, factor_rows, output_stores
    carry_reads: int  # launch 2's reads of a carry slot
    uninit_reads: int  # ... of a slot launch 1 did not write
    unmarked_reads: int  # ... of a slot marked -1


def emulate_split(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    slices: int,
) -> SplitReplay:
    """Both launches of the split kernel over ``slices`` slices."""
    indices, values = plan_bufs.indices, plan_bufs.values
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    batch = lead[0] if lead else 1
    real = real_mask(plan_bufs)
    census = _Census(batch)

    out = torch.full(lead + (i_out, rank), float("nan"))
    stores = torch.zeros(i_out, dtype=torch.int64)

    def store(rows: slice | int, value) -> None:
        out[..., rows, :] = value
        stores[rows] += 1

    # Launch 1: each slice's interior runs, its gaps and its carries.
    bounds = slice_bounds(int(values.shape[0]), slices)
    carries = _Carries(slices, lead + (rank,))
    for w in range(slices):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        pos = lo + torch.nonzero(real[lo:hi]).flatten()
        if pos.numel() == 0:
            continue
        rows = indices[pos, mode]
        runs, counts = torch.unique_consecutive(rows, return_counts=True)
        seg = torch.repeat_interleave(torch.arange(runs.numel()), counts)
        terms = census.products(plan_bufs, factors, mode, pos, range(batch))
        sums = torch.zeros(lead + (runs.numel(), rank)).index_add_(-2, seg, terms)
        runs = runs.tolist()
        carries.put(w, 0, runs[0], sums[..., 0, :])
        for j in range(1, len(runs)):
            if runs[j - 1] + 1 < runs[j]:
                store(slice(runs[j - 1] + 1, runs[j]), 0.0)
            if j < len(runs) - 1:
                store(runs[j], sums[..., j, :])
        if len(runs) > 1:
            carries.put(w, 1, runs[-1], sums[..., -1, :])
    carry_row = carries.key

    # Launch 2: one step per slice, and one after the last slice.
    def finish(v: int, row: int, slot: int, goes_on: bool) -> None:
        total = carries.get(v, slot).clone()
        j = v + 1
        while goes_on and j < slices:
            first, last = carry_row[j]
            if first == row:
                total += carries.get(j, 0)
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
    for c in census.per_restart:
        c["output_stores"] = int(stores.sum()) * rank  # each row store covers every restart
    return SplitReplay(out, stores, carry_row, census.per_restart, carries.reads, carries.uninit,
                       carries.unmarked)


class TileReplay(NamedTuple):
    """What ``emulate_tiles`` returns."""

    out: torch.Tensor  # (..., i_out, R) float32; elements never stored stay NaN
    stores: torch.Tensor  # (..., i_out) int64: the stores each output element received
    carry_blocks: np.ndarray  # (ctas, 2) int64: each slice's carry tiles' blocks (-1: none)
    max_turns: int  # the most turns a warp step's entries of one block took
    repeated_rows: int  # warp steps whose entries of one block hold a row in two runs
    census: list[dict]  # per restart: values, indices, factor_rows, output_stores
    tile_rmw: int  # read-modify-writes of a tile row per restart and column part, one per run
    carry_reads: int  # launch 2's reads of a carry tile, every restart pass
    uninit_reads: int  # ... of a tile launch 1 did not write
    unmarked_reads: int  # ... of a slot marked -1


def _step_turns(rows: np.ndarray, blocks: np.ndarray, real: np.ndarray, lo: int, hi: int,
                rpb: int) -> tuple[int, int, int]:
    """The tile mode's warp steps over one slice ``[lo, hi)`` of the stream:
    ``(max_turns, repeated_rows, runs)``, ``runs`` being the runs of one row
    within a step's entries of one block (one tile-row read-modify-write
    each).  Raises ``AssertionError`` if two lanes of one turn would add to
    one tile row."""
    pos = np.arange(lo, hi)
    keep = real[lo:hi]
    pos, blk = pos[keep], blocks[lo:hi][keep]
    if pos.size == 0:
        return 0, 0, 0
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
    return int(seg.max()) + 1, int(repeated), int(t_key.size)


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
    census = _Census(batch)
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
    max_turns = repeated_rows = tile_rmw = 0
    for c in range(ctas):
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        if lo < hi:
            turns, repeated, runs = _step_turns(rows, blocks, real.numpy(), lo, hi, rpb)
            max_turns = max(max_turns, turns)
            repeated_rows += repeated
            tile_rmw += runs
    reads = uninit = unmarked = 0
    for b0 in range(0, batch, b_pass):
        restarts = slice(b0, min(b0 + b_pass, batch))
        # Launch 1: each slice's tiles, stored whole or left as carries.
        carries = _Carries(ctas, (restarts.stop - b0, rpb, rank))
        for c in range(ctas):
            lo, hi = int(bounds[c]), int(bounds[c + 1])
            if lo == hi:
                continue
            first, last = int(blocks[lo]), int(blocks[hi - 1])
            for blk in range(first, last + 1):
                a, z = max(lo, int(starts[blk])), min(hi, int(starts[blk + 1]))
                pos = a + torch.nonzero(real[a:z]).flatten()
                local = indices[pos, mode] - blk * rpb
                terms = census.products(plan_bufs, factors, mode, pos,
                                        range(restarts.start, restarts.stop))
                tile = torch.zeros((restarts.stop - b0, rpb, rank)).index_add_(
                    1, local, terms.reshape(restarts.stop - b0, -1, rank))
                if starts[blk] >= lo and starts[blk + 1] <= hi:
                    store(blk, restarts, tile)
                else:
                    carries.put(c, 0 if blk == first else 1, blk, tile)
        # Launch 2: each shared block's carry tiles, summed in slice order.
        for blk in range(num_blocks):
            holders = [(c, s) for c in range(ctas) for s in (0, 1) if carries.key[c, s] == blk]
            if holders:
                total = carries.get(*holders[0]).clone()
                for h in holders[1:]:
                    total += carries.get(*h)
                store(blk, restarts, total)
        reads, uninit, unmarked = (reads + carries.reads, uninit + carries.uninit,
                                   unmarked + carries.unmarked)
    for b, c in enumerate(census.per_restart):
        c["output_stores"] = int(stores[b].sum()) * rank
    if not lead:
        out, stores = out[0], stores[0]
    return TileReplay(out, stores, carries.key, max_turns, repeated_rows, census.per_restart,
                      tile_rmw, reads, uninit, unmarked)
