"""Synthetic sparse tensors matching FROSTT characteristics (Table II).

Copy of ``repro.data.synthetic_tensors``: ``make_frostt_like`` gives a
stand-in whose mode-size ratios, density regime and per-mode index skew
match Table II, scaled by ``scale`` (the draws are the JAX package's,
array for array); ``scaled_characteristics`` describes a materialized
stand-in for the analytic model; ``EXPERIMENT_SCALES`` are the experiment
engine's default scales.
"""

from __future__ import annotations

from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.data.frostt import FROSTT_TENSORS, FrosttTensor

__all__ = [
    "make_frostt_like",
    "scaled_dims",
    "scaled_characteristics",
    "EXPERIMENT_SCALES",
]

# Default (name, scale) pairs of the experiment engine
# (repro_torch.experiments), the JAX package's: CP-ALS runs in seconds per
# impl on the CPU while each stand-in keeps its dataset's mode-ratio and
# skew regime (LBNL keeps its 5 modes).
EXPERIMENT_SCALES: dict[str, float] = {
    "NELL-2": 2e-4,
    "LBNL": 2e-2,
    "PATENTS": 2e-5,
}


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


def scaled_characteristics(
    name: str, tensor: SparseTensor, *, scale: float
) -> FrosttTensor:
    """Table-II-style characteristics of a MATERIALIZED scaled tensor.

    The analytic model prices a ``FrosttTensor`` record; for the experiment
    engine it must describe the tensor that actually ran (post-coalescing
    nnz, actual dims), so that the measured and the modeled side price the
    same workload (DESIGN.md §7).  The skew is the catalog's
    ``zipf_alpha``, which ``make_frostt_like`` draws with.
    """
    t = FROSTT_TENSORS[name]
    return FrosttTensor(
        name=f"{name}@{scale:g}",
        dims=tensor.shape,
        nnz=tensor.nnz,
        density=tensor.density,
        zipf_alpha=t.zipf_alpha,
    )
