"""Synthetic sparse tensors matching FROSTT characteristics (Table II).

Copy of ``make_frostt_like`` / ``scaled_dims`` from
``repro.data.synthetic_tensors``: a stand-in whose mode-size ratios,
density regime and per-mode index skew match Table II, scaled by
``scale``.  The draws are the JAX package's, array for array.
"""

from __future__ import annotations

from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.data.frostt import FROSTT_TENSORS

__all__ = ["make_frostt_like", "scaled_dims"]


def scaled_dims(name: str, scale: float) -> tuple[int, ...]:
    t = FROSTT_TENSORS[name]
    # Scale each mode by the N-th root so nnz/volume stays comparable.
    per_mode = scale ** (1.0 / t.nmodes)
    return tuple(max(4, int(round(d * per_mode))) for d in t.dims)


def make_frostt_like(
    name: str,
    *,
    scale: float = 1e-3,
    seed: int = 0,
    correlation: float = 0.0,
    n_clusters: int = 64,
    shuffle: bool = False,
) -> SparseTensor:
    """Scaled FROSTT stand-in (nnz capped at 2M, as in the JAX package).

    ``correlation`` adds cross-mode hot-row coupling; 0.0 keeps the modes'
    draws independent."""
    t = FROSTT_TENSORS[name]
    dims = scaled_dims(name, scale)
    nnz = max(64, int(t.nnz * scale))
    nnz = min(nnz, 2_000_000)
    return random_sparse_tensor(
        dims,
        nnz,
        seed=seed,
        zipf_a=t.zipf_alpha,
        correlation=correlation,
        n_clusters=n_clusters,
        shuffle=shuffle,
    )
