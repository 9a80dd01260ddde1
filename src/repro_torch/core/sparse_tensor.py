"""Sparse tensor containers and the mode-ordered MTTKRP execution plan.

A numpy copy of ``repro.core.sparse_tensor``: the same containers, the
same plan and the same random draws, array for array, so the port and
the JAX package compute from identical inputs
(``tests/test_torch_sparse_tensor.py`` holds them equal).

For each output mode the nonzeros are linearized in output-mode order,
grouped by output block of ``rows_per_block`` rows and padded per block
to whole tiles of ``tile_nnz``.  All hyperedges that share an output row
are then consecutive, which is what lets a kernel keep partial sums on
chip and store each output row exactly once (the paper's Algorithm 1,
line 11).  The plan is host-side numpy, built once per (tensor, mode).
Other nonzero orderings (``repro_torch.reorder``) keep the output block
as the primary key; ``MTTKRPPlan.rows_contiguous`` says whether the
ordering also keeps each output row's nonzeros together.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE

__all__ = [
    "SparseTensor",
    "HypergraphStats",
    "MTTKRPPlan",
    "build_mttkrp_plan",
    "random_sparse_tensor",
]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """COO sparse tensor.

    indices: (nnz, nmodes) int32 coordinates.
    values:  (nnz,) floating values.
    shape:   per-mode dimension sizes ``(I_0, ..., I_{N-1})``.
    """

    indices: np.ndarray
    values: np.ndarray
    shape: tuple[int, ...]

    def __post_init__(self):
        if self.indices.ndim != 2:
            raise ValueError(f"indices must be (nnz, nmodes), got {self.indices.shape}")
        if self.values.ndim != 1 or self.values.shape[0] != self.indices.shape[0]:
            raise ValueError("values must be (nnz,) aligned with indices")
        if self.indices.shape[1] != len(self.shape):
            raise ValueError("indices mode count must match shape")

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def density(self) -> float:
        total = float(np.prod([float(s) for s in self.shape]))
        return self.nnz / total if total > 0 else 0.0

    def mode_sorted(self, mode: int) -> "SparseTensor":
        """Return a copy with nonzeros sorted by the given (output) mode."""
        order = np.argsort(self.indices[:, mode], kind="stable")
        return SparseTensor(self.indices[order], self.values[order], self.shape)

    def to_dense(self) -> np.ndarray:
        """Materialize (tests / tiny tensors only)."""
        out = np.zeros(self.shape, dtype=self.values.dtype)
        np.add.at(out, tuple(self.indices.T), self.values)
        return out

    def hypergraph_stats(self) -> "HypergraphStats":
        """|V|, |E| and per-mode vertex-degree statistics (paper Fig. 3)."""
        degrees = []
        for m in range(self.nmodes):
            counts = np.bincount(self.indices[:, m], minlength=self.shape[m])
            degrees.append(counts)
        return HypergraphStats(
            num_vertices=int(sum(self.shape)),
            num_hyperedges=self.nnz,
            mode_degree_mean=tuple(float(d[d > 0].mean()) if (d > 0).any() else 0.0 for d in degrees),
            mode_degree_max=tuple(int(d.max()) if d.size else 0 for d in degrees),
            mode_nonempty=tuple(int((d > 0).sum()) for d in degrees),
        )


@dataclasses.dataclass(frozen=True)
class HypergraphStats:
    num_vertices: int
    num_hyperedges: int
    mode_degree_mean: tuple[float, ...]
    mode_degree_max: tuple[int, ...]
    mode_nonempty: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MTTKRPPlan:
    """Mode-ordered, tile-padded execution plan for one output mode.

    All arrays are host numpy; ``kernels.mttkrp.ops`` uploads them once.

    sorted_indices : (nnz_pad, nmodes) int32 — nonzeros sorted by output
        mode, grouped by output block, padded per block to a multiple of
        ``tile_nnz`` (padding rows point at the block's first output row).
    sorted_values  : (nnz_pad,) — zeros at padding positions.
    local_row      : (nnz_pad,) int32 — output row *within* its block,
        in [0, rows_per_block).
    tile_block     : (num_tiles,) int32 — output block index per tile;
        non-decreasing, every block in [0, num_blocks) appears >= 1 time.
    """

    mode: int
    shape: tuple[int, ...]
    tile_nnz: int
    rows_per_block: int
    num_blocks: int
    sorted_indices: np.ndarray
    sorted_values: np.ndarray
    local_row: np.ndarray
    tile_block: np.ndarray
    # Nonzero-ordering strategy of the linearization (repro_torch.reorder).
    # "lex" is the baseline: stable output-mode sort, COO order within
    # each output row.
    ordering: str = "lex"

    @property
    def rows_contiguous(self) -> bool:
        """Whether each output row's nonzeros are one contiguous run of the
        stream: true for every ordering whose primary key is the output row
        (``lex``, ``secondary-sort``, ``degree``), false for ``blocked``,
        whose rows come back once per input band.  The kernel's row-run
        mode needs it; its tile mode takes any plan."""
        from repro_torch.reorder.strategies import ROW_CONTIGUOUS_ORDERINGS

        return self.ordering in ROW_CONTIGUOUS_ORDERINGS

    @property
    def num_tiles(self) -> int:
        return int(self.tile_block.shape[0])

    @property
    def nnz_pad(self) -> int:
        return int(self.sorted_values.shape[0])

    @property
    def padding_overhead(self) -> float:
        real = int((self.sorted_values != 0).sum())
        return self.nnz_pad / max(real, 1)

    def executed_row_trace(self, k: int, *, include_padding: bool = True) -> np.ndarray:
        """Factor-``k`` row indices in the plan's linearized order.

        The experiment engine's trace-capture hook (DESIGN.md §7): column
        ``k`` of ``sorted_indices`` is the access stream of input factor
        ``k`` in the modelled FPGA's streaming order (Algorithm 1).  The
        CUDA kernel reads the same stream, but its warps run slices of it
        at once, so this is not the card's own access order.
        ``include_padding=True`` keeps the padding rows' gathers (they
        fetch a real factor row); ``False`` keeps real nonzeros only.
        """
        if not (0 <= k < len(self.shape)):
            raise ValueError(f"factor {k} out of range for {len(self.shape)}-mode plan")
        trace = self.sorted_indices[:, k]
        if include_padding:
            return trace.copy()
        return trace[self.sorted_values != 0]


def build_mttkrp_plan(
    tensor: SparseTensor,
    mode: int,
    *,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> MTTKRPPlan:
    """Linearize nonzeros for mode-ordered execution (paper Algorithm 1).

    Steps:
      1. order the hyperedges by the ``ordering`` strategy
         (``repro_torch.reorder``; every strategy keeps the output block as
         the primary key, so steps 2-4 see contiguous ascending blocks):
         ``"lex"`` is a stable sort by output-mode index on the host, the
         other strategies sort on ``device`` (``nonzero_order``);
      2. group by output block (``rows_per_block`` consecutive output rows);
      3. pad every block's nonzero count to a multiple of ``tile_nnz`` so no
         tile spans two output blocks (padding nonzeros carry value 0 and
         point at the block's first row — they contribute nothing);
      4. blocks with no nonzeros get one all-padding tile, so every output
         block is visited and stored.
    """
    if not (0 <= mode < tensor.nmodes):
        raise ValueError(f"mode {mode} out of range for {tensor.nmodes}-mode tensor")
    i_out = tensor.shape[mode]
    num_blocks = max(1, -(-i_out // rows_per_block))

    if ordering == "lex":
        order = np.argsort(tensor.indices[:, mode], kind="stable")
    else:
        from repro_torch.reorder.strategies import nonzero_order  # circular import

        order = nonzero_order(
            tensor, mode, ordering, rows_per_block=rows_per_block, device=device
        )
    idx = tensor.indices[order].astype(np.int32)
    val = tensor.values[order]

    block_of = idx[:, mode] // rows_per_block
    # Nonzeros per block (bincount over all blocks, including empty ones).
    per_block = np.bincount(block_of, minlength=num_blocks)
    padded_per_block = np.maximum(tile_nnz, -(-per_block // tile_nnz) * tile_nnz)

    nnz_pad = int(padded_per_block.sum())
    out_idx = np.zeros((nnz_pad, tensor.nmodes), dtype=np.int32)
    out_val = np.zeros((nnz_pad,), dtype=val.dtype)
    out_local = np.zeros((nnz_pad,), dtype=np.int32)

    block_starts_dst = np.concatenate([[0], np.cumsum(padded_per_block)])[:-1]
    block_starts_src = np.concatenate([[0], np.cumsum(per_block)])[:-1]

    for b in range(num_blocks):
        n = int(per_block[b])
        dst = int(block_starts_dst[b])
        src = int(block_starts_src[b])
        if n:
            out_idx[dst : dst + n] = idx[src : src + n]
            out_val[dst : dst + n] = val[src : src + n]
            out_local[dst : dst + n] = idx[src : src + n, mode] - b * rows_per_block
        # Padding rows: point at the block's first row, value 0, and set
        # non-output coordinates to 0 (a valid row of every factor matrix).
        pad_lo = dst + n
        pad_hi = dst + int(padded_per_block[b])
        if pad_hi > pad_lo:
            out_idx[pad_lo:pad_hi, mode] = b * rows_per_block
            out_local[pad_lo:pad_hi] = 0

    tiles_per_block = padded_per_block // tile_nnz
    tile_block = np.repeat(np.arange(num_blocks, dtype=np.int32), tiles_per_block)

    return MTTKRPPlan(
        mode=mode,
        shape=tensor.shape,
        tile_nnz=tile_nnz,
        rows_per_block=rows_per_block,
        num_blocks=num_blocks,
        sorted_indices=out_idx,
        sorted_values=out_val,
        local_row=out_local,
        tile_block=tile_block,
        ordering=ordering,
    )


def first_occurrences(idx: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Index of the first draw of each distinct coordinate of ``idx``,
    in ascending (C) order of the coordinates.

    The JAX package sorts the raveled keys, which needs the volume to fit
    in an int64; so does this copy when it fits, and sorts the coordinate
    rows (the same order and the same first draws) when it does not, as
    LBNL's at Table II size (1600 x 4200 x 1600 x 4200 x 868100 = 3.9e19).
    """
    if np.prod([float(s) for s in shape]) < float(np.iinfo(np.intp).max):
        keys = np.ravel_multi_index(tuple(idx.T), shape, mode="wrap")
        _, first = np.unique(keys, return_index=True)
    else:
        _, first = np.unique(idx, axis=0, return_index=True)
    return first


def random_sparse_tensor(
    shape: Sequence[int],
    nnz: int,
    *,
    seed: int = 0,
    dtype=np.float32,
    zipf_a: float | None = None,
    correlation: float = 0.0,
    n_clusters: int = 64,
    shuffle: bool = False,
) -> SparseTensor:
    """Random COO tensor with optionally Zipf-skewed per-mode indices.

    Draw for draw the generator of ``repro.core.sparse_tensor``:

    * ``zipf_a`` draws each mode's indices from a bounded Zipf law
      (p_rank ∝ rank^-a, inverse-CDF sampled, rank decorrelated from the
      index value by a permutation);
    * ``correlation`` couples the modes' hot rows through a shared latent
      quantile, one of ``n_clusters`` bands (0 keeps modes independent);
    * duplicate coordinates are coalesced (``first_occurrences``), so the
      result may hold fewer than ``nnz`` nonzeros;
    * ``shuffle`` randomizes the COO storage order after coalescing.
    """
    if not 0.0 <= correlation <= 1.0:
        raise ValueError(f"correlation must be in [0, 1], got {correlation}")
    rng = np.random.default_rng(seed)
    u_shared = rng.random(nnz) if correlation > 0.0 else None
    cols = []
    for dim in shape:
        u = None
        if u_shared is not None:
            band = np.floor(u_shared * n_clusters)
            coupled = (band + rng.random(nnz)) / n_clusters
            u = np.where(rng.random(nnz) < correlation, coupled, rng.random(nnz))
        if zipf_a is None:
            if u is None:
                cols.append(rng.integers(0, dim, size=nnz, dtype=np.int64))
            else:
                cols.append(np.minimum((u * dim).astype(np.int64), dim - 1))
        else:
            # Bounded Zipf (p ∝ rank^-a) via inverse-CDF sampling.
            p = np.arange(1, dim + 1, dtype=np.float64) ** (-float(zipf_a))
            cdf = np.cumsum(p)
            cdf /= cdf[-1]
            draws = rng.random(nnz) if u is None else u
            ranks = np.searchsorted(cdf, draws, side="left")
            perm = rng.permutation(dim)  # decorrelate rank from index value
            cols.append(perm[np.clip(ranks, 0, dim - 1)])
    idx = np.stack(cols, axis=1)
    idx = idx[first_occurrences(idx, shape)].astype(np.int32)  # coalesce duplicates
    vals = rng.standard_normal(idx.shape[0]).astype(dtype)
    if shuffle:
        perm = rng.permutation(idx.shape[0])
        idx, vals = idx[perm], vals[perm]
    return SparseTensor(idx, vals, tuple(int(s) for s in shape))
