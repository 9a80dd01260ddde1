"""Mode-wise sparse MTTKRP — the paper's Algorithm 1 as a PyTorch API.

The counterpart of ``repro.core.mttkrp``.  Three execution paths:

  * ``mttkrp_ref``  — gather, Hadamard product, ``index_add_`` (the oracle);
  * ``impl="kernel"`` — the plan-based kernel family
    (``repro_torch.kernels.mttkrp``), the counterpart of the JAX
    ``impl="pallas"``: the hand-written CUDA kernel on CUDA tensors, its
    plain PyTorch version on CPU tensors;
  * ``impl="sharded"`` — one rank per shard of a ``torch.distributed``
    group, each rank's shard through the kernel family
    (``repro_torch.distributed.mttkrp_dist``).

For a tensor with |T| nonzeros, N modes and rank R the per-mode cost is
``N * |T| * R`` flop-pairs (paper §IV-A).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.memo import IdentityKeyedCache
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels.mttkrp.ops import mttkrp_kernel

__all__ = ["IMPLS", "check_impl", "dense_mttkrp_oracle", "khatri_rao", "mttkrp", "mttkrp_ref"]

IMPLS = ("ref", "kernel", "sharded")

# Ordered-view memo of the ref path: the strategy's sort runs once per
# (tensor, mode, ordering), not on every CP-ALS call.
_ORDERED_CACHE = IdentityKeyedCache()


def _ordered_ref_view(
    tensor: SparseTensor, mode: int, ordering: str, device: torch.device
) -> SparseTensor:
    from repro_torch.reorder import apply_nonzero_order, nonzero_order

    view = _ORDERED_CACHE.get(tensor, (mode, ordering))
    if view is None:
        view = _ORDERED_CACHE.put(
            tensor,
            (mode, ordering),
            apply_nonzero_order(tensor, nonzero_order(tensor, mode, ordering, device=device)),
        )
    return view


def check_impl(impl: str) -> None:
    """Raise unless ``impl`` is one of the ported implementations."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def khatri_rao(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product of factor matrices (dense; tests only)."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


def mttkrp_ref(
    tensor: SparseTensor | tuple[torch.Tensor, torch.Tensor, tuple[int, ...]],
    factors: Sequence[torch.Tensor],
    mode: int,
) -> torch.Tensor:
    """Reference MTTKRP: out[i_m, r] = sum_{nnz at i_m} val * prod_k F_k[i_k, r].

    ``tensor`` is a ``SparseTensor`` (its COO arrays are copied to the
    factors' device) or an ``(indices, values, shape)`` triple already on
    that device.  Factors may be batched ``(B, I_k, R)``.  Accumulates in
    ``promote_types(values.dtype, float32)`` into an exact ``(I_mode, R)``
    buffer; returns the factor dtype.
    """
    device = factors[0].device
    if isinstance(tensor, SparseTensor):
        indices = torch.as_tensor(tensor.indices, device=device)
        values = torch.as_tensor(tensor.values, device=device)
        shape = tensor.shape
    else:
        indices, values, shape = tensor
    acc_dtype = torch.promote_types(values.dtype, torch.float32)
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    prod = values.to(acc_dtype)[:, None].expand(lead + (values.shape[0], rank))
    for k, f in enumerate(factors):
        if k != mode:
            prod = prod * f.index_select(-2, indices[:, k]).to(acc_dtype)
    out = torch.zeros(lead + (shape[mode], rank), dtype=acc_dtype, device=device)
    out.index_add_(-2, indices[:, mode], prod)
    return out.to(factors[mode].dtype)


def mttkrp(
    tensor: SparseTensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    impl: str = "ref",
    ordering: str | None = None,
    **kwargs,
) -> torch.Tensor:
    """Dispatching front-end. ``impl`` in {"ref", "kernel", "sharded"}.

    ``"kernel"`` is the counterpart of the JAX ``impl="pallas"``: the
    plan-based kernel family (``kernels.mttkrp.ops.mttkrp_kernel``), which
    takes ``tile_nnz=``, ``rows_per_block=`` and ``plan=`` through
    ``kwargs``.  ``"sharded"`` is collective over a process group
    (``distributed.mttkrp_dist.mttkrp_sharded``, which takes ``scheme=``,
    ``group=`` and ``rows_per_block=``); without one it raises.
    ``ordering`` selects the nonzero execution order
    (``repro_torch.reorder``) for all three: the ref path gathers in the
    permuted COO order, the kernel path linearizes its plan with it, each
    shard lays its nonzeros out in it.  Pure execution orders only: a
    relabeling (``reorder_tensor``) needs factor perms and stays with the
    caller.
    """
    check_impl(impl)
    if impl == "sharded":
        from repro_torch.distributed.mttkrp_dist import mttkrp_sharded  # circular import

        return mttkrp_sharded(tensor, factors, mode, ordering=ordering, **kwargs)
    if impl == "ref":
        if ordering is not None:
            tensor = _ordered_ref_view(tensor, mode, ordering, factors[0].device)
        return mttkrp_ref(tensor, factors, mode)
    if ordering is not None:
        kwargs["ordering"] = ordering
    return mttkrp_kernel(tensor, factors, mode, **kwargs)


def dense_mttkrp_oracle(
    dense: np.ndarray, factors: Sequence[np.ndarray], mode: int
) -> np.ndarray:
    """O(prod(shape)) oracle via explicit unfolding — tiny tensors only."""
    n = dense.ndim
    perm = [mode] + [k for k in range(n) if k != mode]
    unfolded = np.transpose(dense, perm).reshape(dense.shape[mode], -1)
    kr = khatri_rao([torch.as_tensor(factors[k]) for k in range(n) if k != mode]).numpy()
    return unfolded @ kr
