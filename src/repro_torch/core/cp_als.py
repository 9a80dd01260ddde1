"""CP-ALS (Canonical Polyadic Decomposition via Alternating Least Squares).

The counterpart of ``repro.core.cp_als``: each ALS sweep performs one
MTTKRP per mode (the kernel under study) followed by a rank x rank
Hadamard-of-Grams solve.  ``impl="ref"`` runs ``mttkrp_ref``;
``impl="kernel"`` runs the plan-based kernel family (the CUDA kernel on
the GPU); ``impl="sharded"`` runs one rank per shard of a
``torch.distributed`` group (``repro_torch.distributed``), with the
factors, Grams and solves replicated on every rank and the fit's inner
product summed over the ranks' blocks of nonzeros.  The per-mode update
and the fit below are shared with the fused executor
(``repro_torch.core.cp_als_fused``) and accept a leading restart batch
dimension.

Fit is computed the standard sparse way without materializing the residual:
    ||X - X_hat||^2 = ||X||^2 - 2<X, X_hat> + ||X_hat||^2
    ||X_hat||^2     = lambda^T (hadamard_k A_k^T A_k) lambda
    <X, X_hat>      = sum_r lambda_r * sum_nnz val * prod_k A_k[i_k, r]
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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
    """X_hat at the given coordinates; ``(..., nnz)`` for factors ``(..., I_k, R)``.

    ``indices`` is ``(nnz, N)``, shared by every factor set of the batch, or
    ``(B, nnz, N)``: one tensor's coordinates per factor set (the
    multi-tensor executor).  The latter is gathered in stacked form, tensor
    ``b``'s rows offset by ``b * I_k`` in factors viewed as ``(B * I_k, R)``.
    """
    if indices.dim() == 2:
        prod = factors[0].index_select(-2, indices[:, 0])
        for k in range(1, len(factors)):
            prod = prod * factors[k].index_select(-2, indices[:, k])
        return torch.matmul(prod, weights.unsqueeze(-1)).squeeze(-1)
    batch, nnz, nmodes = (int(n) for n in indices.shape)
    tenant = torch.arange(batch, dtype=indices.dtype, device=indices.device)
    offsets = torch.stack([tenant * f.shape[-2] for f in factors], dim=-1)  # (B, N)
    rows = (indices + offsets.unsqueeze(1)).view(batch * nnz, nmodes)
    # Gather by the columns of ``rows``, as the one-tensor branch does: a
    # contiguous index takes PyTorch's vectorized_gather_kernel, and a served
    # batch's 30 gathers took 302.7 ms that way against 12.5 ms by columns
    # (chip_smoke.py phase 9 profile, NVIDIA H100 80GB HBM3, 700.00 W).
    prod = None
    for k, f in enumerate(factors):
        g = f.reshape(-1, f.shape[-1]).index_select(0, rows[:, k])
        prod = g if prod is None else prod * g
    prod = prod.view(batch, nnz, -1)
    return torch.matmul(prod, weights.unsqueeze(-1)).squeeze(-1)


def _fit(
    tensor_norm2: torch.Tensor,
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    weights: torch.Tensor,
    *,
    nnz_chunk: int = FIT_NNZ_CHUNK,
    reduce_inner: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """The CP fit ``1 - ||X - X_hat|| / ||X||`` (the math of
    ``repro.core.cp_als._fit``, residual clamped at 0).

    Shapes: ``indices`` ``(nnz, N)`` and ``values`` ``(nnz,)`` for one
    tensor (factors ``(I_k, R)``, or ``(B, I_k, R)`` restarts of it), or
    ``(B, nnz, N)`` and ``(B, nnz)`` for B distinct tensors with factors
    ``(B, I_k, R)``, weights ``(B, R)`` and ``tensor_norm2`` ``(B,)``.
    The inner product runs in chunks of ``nnz_chunk`` nonzeros.  The
    sharded path passes each rank's block of the nonzeros and
    ``reduce_inner``, which sums the blocks' inner products over the ranks.
    """
    grams = [f.mT @ f for f in factors]
    had = grams[0]
    for g in grams[1:]:
        had = had * g
    w = weights.unsqueeze(-1)
    xhat_norm2 = (w.mT @ had @ w)[..., 0, 0].to(tensor_norm2.dtype)
    inner = torch.zeros_like(xhat_norm2)
    for lo in range(0, int(values.shape[-1]), nnz_chunk):
        recon = reconstruct_values(indices[..., lo : lo + nnz_chunk, :], factors, weights)
        vals = values[..., lo : lo + nnz_chunk]
        if vals.dim() == 1:
            inner = inner + torch.matmul(recon.to(values.dtype), vals)
        else:  # one tensor per factor set: a dot product per batch entry
            inner = inner + torch.matmul(recon.to(values.dtype).unsqueeze(-2),
                                         vals.unsqueeze(-1))[..., 0, 0]
    if reduce_inner is not None:
        inner = reduce_inner(inner)
    resid2 = torch.clamp(tensor_norm2 - 2.0 * inner + xhat_norm2, min=0.0)
    # An all-zero tensor has ||X|| = 0: report fit 0 instead of 0/0.
    safe_norm2 = torch.where(tensor_norm2 > 0.0, tensor_norm2, torch.ones_like(tensor_norm2))
    fit = 1.0 - torch.sqrt(resid2) / torch.sqrt(safe_norm2)
    return torch.where(tensor_norm2 > 0.0, fit, torch.zeros_like(fit))


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` with ``a @ x = b`` by LU, never waiting for the device.

    ``solve_ex`` without its error check: ``torch.linalg.solve`` reads the
    LU's info on the host.  On the card the solve is also routed to cuSOLVER
    and cuBLAS for the call: for small ranks against up to 1024 right-hand
    sides PyTorch's default takes MAGMA's batched solve, which waits for the
    device (``chip_smoke.py`` phase 9 lists the shapes at which it does).
    """
    if a.device.type != "cuda":
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    previous = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    finally:
        torch.backends.cuda.preferred_linalg_library(previous)


def _mode_update(
    factors: Sequence[torch.Tensor], weights: torch.Tensor, m: torch.Tensor, mode: int
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """One ALS mode update from the mode's MTTKRP result ``m``.

    Hadamard-of-Grams normal equations, ridge-stabilized solve (1e-8),
    column normalization into the CP lambda (norms clamped at 1e-12) —
    the math of ``repro.core.cp_als._mode_update``.  The solve runs in
    ``promote_types(m.dtype, float32)``; the new factor is contiguous, as
    the kernel requires.  Nothing here waits for the device.
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
    a_new = _solve(had + 1e-8 * eye, m.mT.to(solve_dtype)).mT
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
    mttkrp_fn: Callable | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
    init_factors: Sequence | None = None,
    fused: bool = False,
    fit_every: int = 1,
    restarts: int = 1,
    scheme: str = "mode_ordered",
    verbose: bool = False,
) -> CPState:
    """Alternating least squares for CPD.  Returns factors + fit trace.

    ``impl`` is ``"ref"``, ``"kernel"`` (the counterpart of the JAX
    ``impl="pallas"``) or ``"sharded"``: collective, every rank of the
    default process group calls it with the same arguments, each MTTKRP
    runs in ``scheme`` (``distributed.mttkrp_dist``) and the fit's inner
    product is summed over the ranks; it raises without a process group.
    ``mttkrp_fn(tensor, factors, mode) -> (I_mode, R)``
    replaces the impl in the eager loop.  ``device`` defaults to ``"cuda"``
    and raises when no GPU is present.  ``dtype`` is the factor storage
    dtype; values and the tensor norm stay in
    ``promote_types(dtype, float32)``.  ``init_factors`` (one
    ``(I_k, rank)`` array per mode) replaces the ``cp_init`` draw.

    ``fused=True`` delegates to the fused executor
    (``repro_torch.core.cp_als_fused``): the host reads the fits once
    every ``fit_every`` sweeps, and ``restarts > 1`` runs a batch of
    restarts (seeds ``seed + i``, or, with ``init_factors``, one per-mode
    list per restart) and returns the best-fit one.  The returned
    ``CPState`` is the same type.
    """
    if tensor.nnz == 0:
        raise ValueError(
            "cp_als requires a tensor with at least one nonzero "
            "(an empty tensor has no factorization and an undefined fit)"
        )
    if fused:
        if mttkrp_fn is not None:
            raise ValueError(
                "mttkrp_fn injection is a hook of the eager loop; the fused "
                "executor owns its MTTKRP dispatch (use impl=)"
            )
        from repro_torch.core.cp_als_fused import cp_als_fused  # circular import

        inits = None
        if init_factors is not None:
            inits = [init_factors] if restarts == 1 else list(init_factors)
        return cp_als_fused(
            tensor,
            rank,
            n_iters=n_iters,
            tol=tol,
            seed=seed,
            impl=impl,
            device=device,
            dtype=dtype,
            fit_every=fit_every,
            restarts=restarts,
            init_factors=inits,
            scheme=scheme,
            verbose=verbose,
        ).state
    if restarts != 1:
        raise ValueError("restarts > 1 requires fused=True (batched restarts)")
    if fit_every != 1:
        raise ValueError(
            "fit_every requires fused=True (the eager loop syncs every "
            "iteration by construction)"
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
    reduce_inner = None
    if impl == "sharded":
        from repro_torch.distributed.mttkrp_dist import all_reduce_sum, sharded_fit_operands

        indices, values, tensor_norm2 = sharded_fit_operands(
            tensor, device=dev, dtype=compute_dtype)
        reduce_inner = all_reduce_sum
    else:
        indices, values, tensor_norm2 = tensor_device_operands(
            tensor, device=dev, dtype=compute_dtype
        )
    if mttkrp_fn is None:
        if impl == "ref":
            mttkrp_fn = lambda t, f, m: mttkrp_ref((indices, values, t.shape), f, m)  # noqa: E731
        elif impl == "sharded":
            mttkrp_fn = lambda t, f, m: mttkrp(t, f, m, impl=impl, scheme=scheme)  # noqa: E731
        else:
            mttkrp_fn = lambda t, f, m: mttkrp(t, f, m, impl=impl)  # noqa: E731

    fits: list[float] = []
    fit_prev = -np.inf
    it = 0
    for it in range(1, n_iters + 1):
        for mode in range(tensor.nmodes):
            m = mttkrp_fn(tensor, factors, mode)  # (I_mode, R)
            factors, weights = _mode_update(factors, weights, m, mode)

        fit = float(_fit(tensor_norm2, indices, values, factors, weights,
                         reduce_inner=reduce_inner))
        fits.append(fit)
        if verbose:
            print(f"  ALS iter {it:3d}  fit={fit:.6f}")
        if abs(fit - fit_prev) < tol:
            break
        fit_prev = fit

    return CPState(
        factors=list(factors), weights=weights, fit=fits[-1], fits=fits, iters=it
    )
