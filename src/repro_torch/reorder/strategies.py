"""Ordering strategies: nonzero execution orders and mode relabelings.

The counterpart of ``repro.reorder.strategies``, with the same strategies
and the same results, array for array (``tests/test_torch_reorder.py``).
Two transformations compose into a strategy:

  * a **relabeling** of mode indices (``reorder_tensor``): it changes
    which factor rows sit together, so CP factors must be row-permuted
    with the returned perms; the caller applies it once, globally;
  * an **execution permutation** of the nonzeros for one output mode
    (``nonzero_order``): it changes the order of the sums only, needs no
    factor surgery and threads through ``build_mttkrp_plan`` and the
    MTTKRP implementations.

Strategies:

  ``lex``            stable sort by output index, COO order within a row.
  ``secondary-sort`` within each output row, by the input indices.
  ``degree``         within each output row, hottest input rows first (as
                     a relabeling: rows renamed by descending degree).
  ``blocked``        primary key the output block (``rows_per_block``
                     rows, the plan's unit), then each input's
                     ``block_rows``-sized degree-rank band, then the
                     output row: the rows of a block come back once per
                     band, so a row's nonzeros are not contiguous.

The first three keep the output row as the primary key
(``ROW_CONTIGUOUS_ORDERINGS``); ``blocked`` keeps only the output block.

The execution permutation is computed with PyTorch on any device:
``np.lexsort``'s permutation is a series of stable sorts, least
significant key first (``torch.sort(stable=True)``), which on the card
takes milliseconds at NELL-2 size where the host's ``lexsort`` takes
minutes.  ``nonzero_order`` hands the permutation back as numpy, as the
JAX package's does; ``nonzero_order_tensor`` keeps it on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "ORDERINGS",
    "ROW_CONTIGUOUS_ORDERINGS",
    "DEFAULT_BLOCK_ROWS",
    "degree_reorder",
    "reorder_tensor",
    "prepare_execution",
    "nonzero_order",
    "nonzero_order_tensor",
    "apply_nonzero_order",
    "trace_view",
    "mode_trace",
]

ORDERINGS = ("lex", "degree", "secondary-sort", "blocked")
# Orderings whose primary key is the output row: every row's nonzeros are
# one contiguous run of the stream.
ROW_CONTIGUOUS_ORDERINGS = ("lex", "degree", "secondary-sort")

# Rows per input-space tile of the "blocked" strategy: 128 factor rows of
# the paper configuration (R = 16 float32, 64 B a row) are 8 KB.
DEFAULT_BLOCK_ROWS = 128


def degree_reorder(tensor: SparseTensor, mode: int) -> np.ndarray:
    """Permutation for one mode: new_label = rank by descending degree.

    Returns ``perm`` with perm[old_index] = new_index; the hottest row
    (touched by the most hyperedges) gets label 0.
    """
    deg = np.bincount(tensor.indices[:, mode], minlength=tensor.shape[mode])
    order = np.argsort(-deg, kind="stable")  # old indices by hotness
    perm = np.empty_like(order)
    perm[order] = np.arange(order.shape[0])
    return perm


def reorder_tensor(
    tensor: SparseTensor,
    modes: list[int] | None = None,
    *,
    strategy: str = "degree",
) -> tuple[SparseTensor, list[np.ndarray]]:
    """Relabel the given modes per the strategy.  Factor matrices of a CP
    model must be row-permuted with the returned perms (old -> new).

    Only ``degree`` relabels; for the other strategies the relabeling is
    the identity.
    """
    if strategy not in ORDERINGS:
        raise ValueError(f"unknown ordering strategy {strategy!r}; known: {ORDERINGS}")
    modes = list(range(tensor.nmodes)) if modes is None else list(modes)
    idx = tensor.indices.copy()
    perms = []
    for m in range(tensor.nmodes):
        if strategy == "degree" and m in modes:
            p = degree_reorder(tensor, m)
            idx[:, m] = p[tensor.indices[:, m]]
            perms.append(p)
        else:
            perms.append(np.arange(tensor.shape[m]))
    return SparseTensor(idx, tensor.values.copy(), tensor.shape), perms


def prepare_execution(
    tensor: SparseTensor, ordering: str | None
) -> tuple[SparseTensor, list[np.ndarray] | None]:
    """The tensor a run must execute for ``ordering``, and the factor perms.

    For ``degree``, the relabeled tensor and the old -> new row perms the
    CP factors must be permuted with; for every pure execution order (and
    ``None``) the tensor unchanged and ``None``.
    """
    if ordering == "degree":
        relabeled, perms = reorder_tensor(tensor, strategy="degree")
        return relabeled, perms
    if ordering is not None and ordering not in ORDERINGS:
        raise ValueError(f"unknown ordering strategy {ordering!r}; known: {ORDERINGS}")
    return tensor, None


def _input_modes(nmodes: int, mode: int, primary_input: int | None) -> list[int]:
    inputs = [k for k in range(nmodes) if k != mode]
    if primary_input is None:
        return inputs
    if primary_input not in inputs:
        raise ValueError(
            f"primary_input {primary_input} is not an input mode of output {mode}"
        )
    return [primary_input] + [k for k in inputs if k != primary_input]


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort(keys)``'s permutation: the last key is the primary one,
    ties keep their index order.  One stable sort per key, least
    significant first, each over the previous pass's order."""
    perm = torch.sort(keys[0], stable=True).indices
    for key in keys[1:]:
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _degree_rank(col: torch.Tensor, dim: int) -> torch.Tensor:
    """``degree_reorder``'s new label of each entry's row (int64)."""
    deg = torch.bincount(col, minlength=dim)
    order = torch.sort(-deg, stable=True).indices
    perm = torch.empty_like(order)
    perm[order] = torch.arange(order.shape[0], device=order.device)
    return perm[col]


def nonzero_order_tensor(
    indices: torch.Tensor,
    shape: Sequence[int],
    mode: int,
    strategy: str,
    *,
    rows_per_block: int = 256,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    primary_input: int | None = None,
) -> torch.Tensor:
    """``nonzero_order`` of the ``(nnz, N)`` coordinates ``indices``, on
    their device; an int64 tensor there."""
    nmodes = len(shape)
    if not (0 <= mode < nmodes):
        raise ValueError(f"mode {mode} out of range for {nmodes}-mode tensor")
    if strategy not in ORDERINGS:
        raise ValueError(f"unknown ordering strategy {strategy!r}; known: {ORDERINGS}")
    idx = indices.to(torch.int64)
    out = idx[:, mode]
    if strategy == "lex":
        return torch.sort(out, stable=True).indices
    inputs = _input_modes(nmodes, mode, primary_input)
    if strategy == "secondary-sort":
        keys = [idx[:, k] for k in reversed(inputs)] + [out]
        return _lexsort(keys)
    ranks = [_degree_rank(idx[:, k], int(shape[k])) for k in inputs]
    if strategy == "degree":
        return _lexsort(list(reversed(ranks)) + [out])
    bands = [r // block_rows for r in ranks]  # "blocked"
    keys = list(reversed(ranks)) + [out] + list(reversed(bands)) + [out // rows_per_block]
    return _lexsort(keys)


def nonzero_order(
    tensor: SparseTensor,
    mode: int,
    strategy: str,
    *,
    rows_per_block: int = 256,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    primary_input: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> np.ndarray:
    """Execution permutation of the nonzeros for output ``mode``.

    Returns ``order`` (int64 numpy) such that ``indices[order]`` is the
    strategy's executed nonzero sequence; the sorts run on ``device``.
    Every strategy keeps the output block as the primary key, so the
    result is a valid linearization for ``build_mttkrp_plan``: blocks stay
    contiguous and ascending.  ``primary_input`` promotes one input mode
    to the most significant secondary key; by default inputs rank in
    ascending mode order.
    """
    dev = resolve_device(device)
    idx = torch.as_tensor(tensor.indices, device=dev)
    order = nonzero_order_tensor(
        idx,
        tensor.shape,
        mode,
        strategy,
        rows_per_block=rows_per_block,
        block_rows=block_rows,
        primary_input=primary_input,
    )
    return order.cpu().numpy()


def apply_nonzero_order(tensor: SparseTensor, order: np.ndarray) -> SparseTensor:
    """The tensor with its nonzeros stored in execution order."""
    return SparseTensor(tensor.indices[order], tensor.values[order], tensor.shape)


def trace_view(
    tensor: SparseTensor,
    mode: int,
    strategy: str,
    *,
    rows_per_block: int = 256,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SparseTensor:
    """The remapped COO view whose array order is the executed order.

    For ``degree`` this includes the relabeling; for the pure execution
    orders it is the permuted storage.
    """
    if strategy == "degree":
        tensor, _ = reorder_tensor(tensor, strategy="degree")
    order = nonzero_order(
        tensor, mode, strategy, rows_per_block=rows_per_block, block_rows=block_rows,
        device=device,
    )
    return apply_nonzero_order(tensor, order)


def mode_trace(
    tensor: SparseTensor,
    out_mode: int,
    in_mode: int,
    *,
    strategy: str | None = None,
    secondary_sort: bool = False,
    rows_per_block: int = 256,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    device: str | torch.device = DEFAULT_DEVICE,
) -> np.ndarray:
    """Factor-row access trace for ``in_mode`` under ``strategy``-ordered
    execution of ``out_mode`` (Algorithm 1's traversal), for
    ``core.cache_sim``.

    The traced input mode is promoted to the primary secondary key.
    ``secondary_sort=True`` is the older spelling of
    ``strategy="secondary-sort"``.
    """
    if strategy is None:
        strategy = "secondary-sort" if secondary_sort else "lex"
    order = nonzero_order(
        tensor,
        out_mode,
        strategy,
        rows_per_block=rows_per_block,
        block_rows=block_rows,
        primary_input=None if strategy == "lex" else in_mode,
        device=device,
    )
    return tensor.indices[order, in_mode]
