"""Carry state between the JAX package and the port as numpy arrays.

The port imports nothing of the JAX package; these helpers take plain
numpy arrays (``np.asarray`` of JAX arrays) or duck-typed records, so both
sides can compute from identical inputs and their outputs can be compared.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cp_als import CPState
from repro_torch.core.sparse_tensor import MTTKRPPlan
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

__all__ = [
    "bucket_from_numpy",
    "cpstate_to_numpy",
    "factors_from_numpy",
    "lm_params_from_numpy",
    "plan_from_numpy",
]


def factors_from_numpy(
    arrays: Sequence[np.ndarray],
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """Factor matrices (or weights) as contiguous tensors on ``device``."""
    dev = resolve_device(device)
    return [
        torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype).contiguous()
        for a in arrays
    ]


def bucket_from_numpy(
    indices: np.ndarray,
    values: np.ndarray,
    norm2: np.ndarray,
    factors: Sequence[np.ndarray],
    *,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...]]:
    """A bucket batch's operands for ``MultiTensorCPALS.run_batch``: padded
    COO ``(B, nnz_pad, N)`` indices, ``(B, nnz_pad)`` values and ``(B,)``
    norms (in ``promote_types(dtype, float32)``), and ``(B, I_k_pad, R_pad)``
    initial factors in ``dtype``, as a JAX bucket passes them."""
    dev = resolve_device(device)
    compute = torch.promote_types(dtype, torch.float32)
    idx = torch.from_numpy(np.array(indices, dtype=np.int32)).to(dev)
    vals, n2 = factors_from_numpy([values, norm2], device=dev, dtype=compute)
    return idx, vals, n2, tuple(factors_from_numpy(factors, device=dev, dtype=dtype))


def cpstate_to_numpy(state: CPState) -> tuple[list[np.ndarray], np.ndarray]:
    """``(factors, weights)`` of a port ``CPState`` as float32 numpy arrays."""
    factors = [f.detach().to("cpu", torch.float32).numpy() for f in state.factors]
    return factors, state.weights.detach().to("cpu", torch.float32).numpy()


def plan_from_numpy(plan) -> MTTKRPPlan:
    """A port ``MTTKRPPlan`` from any record with the plan's fields (for
    example a JAX-package plan), its arrays copied as numpy."""
    fields = {f.name: getattr(plan, f.name) for f in dataclasses.fields(MTTKRPPlan)}
    for name in ("sorted_indices", "sorted_values", "local_row", "tile_block"):
        fields[name] = np.array(fields[name])
    fields["shape"] = tuple(int(s) for s in fields["shape"])
    return MTTKRPPlan(**fields)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_numpy(cfg: ModelConfig, params: dict, *, device) -> Transformer:
    """A port ``Transformer`` holding the weights of a JAX ``init_model`` pytree.

    ``params`` has numpy leaves (``jax.tree_util.tree_map(np.asarray, ...)``)
    and the JAX layout: the layer stack carries a leading ``num_layers``
    axis, which is split into one module per layer.  Weights are stored in
    ``cfg.param_dtype`` on ``device``.
    """
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        arr = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=cfg.param_dtype)

    ported = {k: _map_tree(tensor, v) for k, v in params.items() if k != "layers"}
    stacked = _map_tree(tensor, params["layers"])
    ported["layers"] = [
        _map_tree(lambda t, i=i: t[i].clone(), stacked) for i in range(cfg.num_layers)
    ]
    return Transformer(cfg, ported)
