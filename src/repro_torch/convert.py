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
    "train_state_from_numpy",
    "tree_to_numpy",
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


def _unstack(stacked: dict, n: int) -> list[dict]:
    return [_map_tree(lambda t, i=i: t[i].clone(), stacked) for i in range(n)]


def _split_layers(cfg: ModelConfig, tree: dict, tensor) -> dict:
    """The JAX layout's stacked layer stacks (``layers``, ``cross`` and
    ``encoder.layers``, each with a leading layer axis) split into lists of
    per-layer dicts; every other subtree (``shared_attn``, the encoder's
    ``final_ln``) as it is."""
    stacks = {"layers": cfg.num_layers, "cross": cfg.num_layers}
    ported = {k: _map_tree(tensor, v) for k, v in tree.items()
              if k not in stacks and k != "encoder"}
    for key, n in stacks.items():
        if key in tree:
            ported[key] = _unstack(_map_tree(tensor, tree[key]), n)
    if "encoder" in tree:
        enc = tree["encoder"]
        ported["encoder"] = {k: _map_tree(tensor, v) for k, v in enc.items() if k != "layers"}
        ported["encoder"]["layers"] = _unstack(_map_tree(tensor, enc["layers"]),
                                               cfg.encoder_layers)
    return ported


def lm_params_from_numpy(cfg: ModelConfig, params: dict, *, device) -> Transformer:
    """A port ``Transformer`` (any family) holding the weights of a JAX
    ``init_model`` pytree.

    ``params`` has numpy leaves (``jax.tree_util.tree_map(np.asarray, ...)``)
    and the JAX layout: each layer stack (``layers``, ``cross``,
    ``encoder.layers``) carries a leading layer axis, which is split into
    one module per layer.  Weights are stored in
    ``cfg.param_dtype`` on ``device``.
    """
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        arr = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=cfg.param_dtype)

    return Transformer(cfg, _split_layers(cfg, params, tensor))


def train_state_from_numpy(cfg: ModelConfig, state: dict, *, device) -> dict:
    """A port train state from a JAX one with numpy leaves: ``params`` becomes
    a ``Transformer``; the params-shaped trees (AdamW's ``m`` and ``v``,
    ``Int8ErrorFeedback``'s ``ef_buffer``) float32 trees with the layer
    stack split; ``step``, ``lr`` and any other array a tensor, as stored."""
    dev = resolve_device(device)
    out = {}
    for key, val in state.items():
        if key == "params":
            out[key] = lm_params_from_numpy(cfg, val, device=dev)
        elif isinstance(val, dict):
            out[key] = _split_layers(cfg, val, lambda a: torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dev))
        else:
            out[key] = torch.from_numpy(np.array(val)).to(dev)
    return out


def tree_to_numpy(tree):
    """A port state, model or tree in the JAX layout with numpy leaves: a
    ``Transformer`` as its ``params()``, each list of per-layer dicts stacked
    on a leading axis."""
    if isinstance(tree, Transformer):
        return tree_to_numpy(tree.params())
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [tree_to_numpy(item) for item in tree]
        return _map_stack(parts)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").numpy()
    return np.asarray(tree)


def _map_stack(parts: list):
    if isinstance(parts[0], dict):
        return {k: _map_stack([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)
