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

__all__ = ["cpstate_to_numpy", "factors_from_numpy", "plan_from_numpy"]


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
