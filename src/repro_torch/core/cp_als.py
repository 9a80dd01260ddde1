"""CP-ALS (Canonical Polyadic Decomposition via Alternating Least Squares).

The counterpart of ``repro.core.cp_als``: each ALS sweep performs one
MTTKRP per mode (the kernel under study) followed by a rank x rank
Hadamard-of-Grams solve.  ``impl="ref"`` runs ``mttkrp_ref``;
``impl="kernel"`` runs the plan-based kernel family (the CUDA kernel on
the GPU).  The per-mode update and the fit below are shared with the
fused executor (``repro_torch.core.cp_als_fused``) and accept a leading
restart batch dimension.

Fit is computed the standard sparse way without materializing the residual:
    ||X - X_hat||^2 = ||X||^2 - 2<X, X_hat> + ||X_hat||^2
    ||X_hat||^2     = lambda^T (hadamard_k A_k^T A_k) lambda
    <X, X_hat>      = sum_r lambda_r * sum_nnz val * prod_k A_k[i_k, r]
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.mttkrp import check_impl, mttkrp, mttkrp_ref
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.mttkrp.ops import tensor_device_operands

__all__ = ["CPState", "cp_als", "cp_init", "reconstruct_values"]

# Nonzeros per chunk of the fit's <X, X_hat> pass: bounds the live
# (restarts, chunk, R) product at Table II sizes.  Chunking changes the
# result only by float re-association.
FIT_NNZ_CHUNK = 1 << 22


@dataclasses.dataclass
class CPState:
    factors: list[torch.Tensor]  # A_k: (I_k, R)
    weights: torch.Tensor  # lambda: (R,)
    fit: float
    fits: list[float]
    iters: int


def cp_init(
    tensor: SparseTensor,
    rank: int,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[torch.Tensor]:
    """Uniform [0, 1) initial factors drawn from a ``torch.Generator``.

    The draws differ from the JAX package's ``cp_init`` (threefry) for the
    same seed; to start both from the same point, draw with one and pass
    the arrays as ``init_factors`` (``repro_torch.convert``).
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return [
        torch.rand((tensor.shape[k], rank), generator=gen).to(device=dev, dtype=dtype)
        for k in range(tensor.nmodes)
    ]


def init_factor_tensors(
    init_factors: Sequence, shape: Sequence[int], rank: int, *, device, dtype
) -> list[torch.Tensor]:
    """Caller-supplied initial factors (arrays or tensors) on ``device``."""
    if len(init_factors) != len(shape):
        raise ValueError(f"{len(init_factors)} initial factors for a {len(shape)}-mode tensor")
    out = []
    for k, f in enumerate(init_factors):
        t = f if isinstance(f, torch.Tensor) else torch.from_numpy(np.array(f))
        t = t.to(device=device, dtype=dtype).contiguous()
        if tuple(t.shape) != (shape[k], rank):
            raise ValueError(f"initial factor {k} has shape {tuple(t.shape)}, expected {(shape[k], rank)}")
        out.append(t)
    return out


def reconstruct_values(
    indices: torch.Tensor, factors: Sequence[torch.Tensor], weights: torch.Tensor
) -> torch.Tensor:
    """X_hat at the given coordinates; ``(..., nnz)`` for factors ``(..., I_k, R)``."""
    prod = factors[0].index_select(-2, indices[:, 0])
    for k in range(1, len(factors)):
        prod = prod * factors[k].index_select(-2, indices[:, k])
    return torch.matmul(prod, weights.unsqueeze(-1)).squeeze(-1)


def _fit(
    tensor_norm2: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    weights: torch.Tensor,
    *,
    nnz_chunk: int = FIT_NNZ_CHUNK,
) -> torch.Tensor:
    grams = [f.mT @ f for f in factors]
    had = grams[0]
    for g in grams[1:]:
        had = had * g
    w = weights.unsqueeze(-1)
    xhat_norm2 = (w.mT @ had @ w)[..., 0, 0].to(tensor_norm2.dtype)
    inner = torch.zeros_like(xhat_norm2)
    for lo in range(0, int(values.shape[0]), nnz_chunk):
        recon = reconstruct_values(indices[lo : lo + nnz_chunk], factors, weights)
        inner = inner + torch.matmul(recon.to(values.dtype), values[lo : lo + nnz_chunk])
    resid2 = torch.clamp(tensor_norm2 - 2.0 * inner + xhat_norm2, min=0.0)
    # An all-zero tensor has ||X|| = 0: report fit 0 instead of 0/0.
    safe_norm2 = torch.where(tensor_norm2 > 0.0, tensor_norm2, torch.ones_like(tensor_norm2))
    fit = 1.0 - torch.sqrt(resid2) / torch.sqrt(safe_norm2)
    return torch.where(tensor_norm2 > 0.0, fit, torch.zeros_like(fit))


def _mode_update(
    factors: Sequence[torch.Tensor], weights: torch.Tensor, m: torch.Tensor, mode: int
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """One ALS mode update from the mode's MTTKRP result ``m``.

    Hadamard-of-Grams normal equations, ridge-stabilized solve (1e-8),
    column normalization into the CP lambda (norms clamped at 1e-12) —
    the math of ``repro.core.cp_als._mode_update``.  The solve runs in
    ``promote_types(m.dtype, float32)``; the new factor is contiguous, as
    the kernel requires.
    """
    rank = int(m.shape[-1])
    solve_dtype = torch.promote_types(m.dtype, torch.float32)
    had = torch.ones(m.shape[:-2] + (rank, rank), dtype=solve_dtype, device=m.device)
    for k in range(len(factors)):
        if k != mode:
            fk = factors[k].to(solve_dtype)
            had = had * (fk.mT @ fk)
    eye = torch.eye(rank, dtype=solve_dtype, device=m.device)
    # Solve A_mode @ had = m  (had is SPD up to rank deficiency).
    a_new = torch.linalg.solve(had + 1e-8 * eye, m.mT.to(solve_dtype)).mT
    norms = torch.clamp(torch.linalg.vector_norm(a_new, dim=-2), min=1e-12)
    out = list(factors)
    out[mode] = (a_new / norms.unsqueeze(-2)).to(factors[mode].dtype).contiguous()
    return tuple(out), norms.to(weights.dtype)


def cp_als(
    tensor: SparseTensor,
    rank: int,
    *,
    n_iters: int = 20,
    tol: float = 1e-5,
    seed: int = 0,
    impl: str = "ref",
    device: str | torch.device = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
    init_factors: Sequence | None = None,
    verbose: bool = False,
) -> CPState:
    """Alternating least squares for CPD.  Returns factors + fit trace.

    ``impl`` is ``"ref"`` or ``"kernel"`` (the counterpart of the JAX
    ``impl="pallas"``).  ``device`` defaults to ``"cuda"`` and raises when
    no GPU is present.  ``dtype`` is the factor storage dtype; values and
    the tensor norm stay in ``promote_types(dtype, float32)``.
    ``init_factors`` (one ``(I_k, rank)`` array per mode) replaces the
    ``cp_init`` draw.  The fused executor with batched restarts is
    ``repro_torch.core.cp_als_fused.cp_als_fused``.
    """
    if tensor.nnz == 0:
        raise ValueError(
            "cp_als requires a tensor with at least one nonzero "
            "(an empty tensor has no factorization and an undefined fit)"
        )
    dev = resolve_device(device)
    check_impl(impl)

    compute_dtype = torch.promote_types(dtype, torch.float32)
    if init_factors is None:
        factors = tuple(cp_init(tensor, rank, seed=seed, dtype=dtype, device=dev))
    else:
        factors = tuple(
            init_factor_tensors(init_factors, tensor.shape, rank, device=dev, dtype=dtype)
        )
    weights = torch.ones((rank,), dtype=factors[0].dtype, device=dev)
    indices, values, tensor_norm2 = tensor_device_operands(
        tensor, device=dev, dtype=compute_dtype
    )

    fits: list[float] = []
    fit_prev = -np.inf
    it = 0
    for it in range(1, n_iters + 1):
        for mode in range(tensor.nmodes):
            if impl == "ref":
                m = mttkrp_ref((indices, values, tensor.shape), factors, mode)
            else:
                m = mttkrp(tensor, factors, mode, impl=impl)  # (I_mode, R)
            factors, weights = _mode_update(factors, weights, m, mode)

        fit = float(_fit(tensor_norm2, indices, values, factors, weights))
        fits.append(fit)
        if verbose:
            print(f"  ALS iter {it:3d}  fit={fit:.6f}")
        if abs(fit - fit_prev) < tol:
            break
        fit_prev = fit

    return CPState(
        factors=list(factors), weights=weights, fit=fits[-1], fits=fits, iters=it
    )
