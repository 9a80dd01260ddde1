"""Fused, batched, device-resident CP-ALS executor.

The counterpart of ``repro.core.cp_als_fused.FusedCPALS``:

  * **plan residency** — every per-mode ``MTTKRPPlan`` (``impl="kernel"``)
    is built and uploaded once at construction and reused by every sweep
    of every restart;
  * **sync cadence** — a block of ``fit_every`` sweeps runs as a Python
    loop that enqueues device work only; the host reads the block's fits
    once, at its end (the JAX ``lax.scan`` block);
  * **batched restarts** — ``restarts > 1`` stacks the factors as
    ``(B, I_k, R)``; the kernel takes the whole batch in one launch per
    mode per sweep, and the solves and fits are batched too.

The sweep math is the eager driver's (``cp_als._mode_update``,
``cp_als._fit``), so fused and eager trajectories differ only by float
re-association; ``FUSED_FIT_TOL`` is that tolerance, as in the JAX package.
Only the ``"lex"`` plan ordering is ported; the sharded executor and
``MultiTensorCPALS`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cp_als import (
    CPState,
    _fit,
    _mode_update,
    cp_init,
    init_factor_tensors,
)
from repro_torch.core.mttkrp import check_impl, mttkrp_ref
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.mttkrp.ops import (
    get_plan,
    mttkrp_from_plan,
    plan_device_buffers,
    tensor_device_operands,
)

__all__ = ["FUSED_FIT_TOL", "BatchedCPState", "FusedCPALS", "cp_als_fused"]

# Fused-vs-eager (and port-vs-JAX) fit tolerance: same math, float
# summations re-associated.
FUSED_FIT_TOL = 2e-3


@dataclasses.dataclass
class BatchedCPState:
    """Result of a fused (possibly multi-restart) CP-ALS run.

    ``state`` is the best-final-fit restart as a plain ``CPState``;
    ``fits`` keeps every restart's trajectory, ``(restarts, iters)``.
    ``sync_count`` is the number of device-to-host fit reads the run made
    (one per ``fit_every`` sweeps).  ``seeds`` is empty when the run
    started from caller-supplied ``init_factors``.
    """

    state: CPState
    best_restart: int
    seeds: tuple[int, ...]
    fits: np.ndarray  # (restarts, iters)
    sync_count: int

    @property
    def final_fits(self) -> tuple[float, ...]:
        return tuple(float(f) for f in self.fits[:, -1])


class FusedCPALS:
    """Device-resident CP-ALS executor for one (tensor, impl, device).

    Construction does all host-side work (plan builds, uploads); ``run``
    only enqueues sweeps.  Reuse one executor across runs.
    """

    def __init__(
        self,
        tensor: SparseTensor,
        rank: int,
        *,
        impl: str = "ref",
        device: str | torch.device = DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
        tile_nnz: int = 256,
        rows_per_block: int = 256,
    ) -> None:
        if tensor.nnz == 0:
            raise ValueError(
                "cp_als requires a tensor with at least one nonzero "
                "(an empty tensor has no factorization and an undefined fit)"
            )
        check_impl(impl)
        self.tensor = tensor
        self.rank = int(rank)
        self.impl = impl
        self.device = resolve_device(device)
        self.dtype = dtype
        self.nmodes = tensor.nmodes
        compute_dtype = torch.promote_types(dtype, torch.float32)
        # Fit operands: the raw COO stream, as the eager driver reads it.
        self._indices, self._values, self._norm2 = tensor_device_operands(
            tensor, device=self.device, dtype=compute_dtype
        )
        if impl == "kernel":
            self._plans = [
                get_plan(tensor, m, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
                for m in range(self.nmodes)
            ]
            # Upload once; every sweep of every restart reuses the buffers.
            for p in self._plans:
                plan_device_buffers(p, self.device)

    def _mttkrp(self, factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
        if self.impl == "ref":
            return mttkrp_ref((self._indices, self._values, self.tensor.shape), factors, mode)
        return mttkrp_from_plan(self._plans[mode], factors)

    def _sweeps(self, factors, weights, length: int):
        """``length`` sweeps, enqueued without a host sync; fits stay on device."""
        fits = []
        for _ in range(length):
            for mode in range(self.nmodes):
                m = self._mttkrp(factors, mode)
                factors, weights = _mode_update(factors, weights, m, mode)
            fits.append(_fit(self._norm2, self._indices, self._values, factors, weights))
        return factors, weights, torch.stack(fits, dim=-1)

    def run(
        self,
        *,
        n_iters: int = 20,
        tol: float = 1e-5,
        seed: int = 0,
        seeds: Sequence[int] | None = None,
        restarts: int = 1,
        fit_every: int = 1,
        init_factors: Sequence[Sequence] | None = None,
        verbose: bool = False,
    ) -> BatchedCPState:
        """Run CP-ALS; one host sync per ``fit_every`` sweeps.

        The restarts start from ``init_factors`` (one per-mode factor list
        per restart) when given, else from ``cp_init`` with ``seeds`` (or
        ``seed + i`` for ``i < restarts``).  With more than one restart the
        run stops early only when every restart's fit delta falls below
        ``tol``.  On a mid-block stop the fit trace is truncated at the
        converged iteration while the factors are from the end of the
        block.
        """
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        if fit_every < 1:
            raise ValueError(f"fit_every must be >= 1, got {fit_every}")
        if restarts < 1:
            raise ValueError(f"restarts must be >= 1, got {restarts}")
        if init_factors is not None:
            if seeds is not None or restarts not in (1, len(init_factors)):
                raise ValueError("init_factors replaces seeds/restarts; pass one or the other")
            seeds = ()
            inits = [
                init_factor_tensors(
                    init, self.tensor.shape, self.rank, device=self.device, dtype=self.dtype
                )
                for init in init_factors
            ]
        else:
            if seeds is None:
                seeds = tuple(seed + i for i in range(restarts))
            seeds = tuple(int(s) for s in seeds)
            inits = [
                cp_init(self.tensor, self.rank, seed=s, dtype=self.dtype, device=self.device)
                for s in seeds
            ]
        n_restarts = len(inits)
        batched = n_restarts > 1
        if batched:
            factors = tuple(
                torch.stack([init[k] for init in inits]) for k in range(self.nmodes)
            )
            weights = torch.ones((n_restarts, self.rank), dtype=self.dtype, device=self.device)
        else:
            factors = tuple(inits[0])
            weights = torch.ones((self.rank,), dtype=self.dtype, device=self.device)

        fit_cols: list[np.ndarray] = []  # one (restarts,) column per iteration
        fit_prev = np.full((n_restarts,), -np.inf)
        it = 0
        syncs = 0
        converged = False
        while it < n_iters and not converged:
            block = min(fit_every, n_iters - it)
            factors, weights, fits = self._sweeps(factors, weights, block)
            # The ONLY device-to-host sync of the block.
            block_fits = fits.cpu().numpy().astype(np.float64)
            syncs += 1
            cols = block_fits if batched else block_fits[None, :]  # (restarts, block)
            for j in range(cols.shape[1]):
                it += 1
                fit_cols.append(cols[:, j])
                if verbose:
                    shown = ", ".join(f"{f:.6f}" for f in cols[:, j])
                    print(f"  fused ALS iter {it:3d}  fit=[{shown}]")
                if np.all(np.abs(cols[:, j] - fit_prev) < tol):
                    converged = True
                    fit_prev = cols[:, j]
                    break
                fit_prev = cols[:, j]

        fits_mat = np.stack(fit_cols, axis=1)  # (restarts, iters)
        best = int(np.argmax(fits_mat[:, -1]))
        if batched:
            best_factors = [f[best] for f in factors]
            best_weights = weights[best]
        else:
            best_factors = list(factors)
            best_weights = weights
        state = CPState(
            factors=best_factors,
            weights=best_weights,
            fit=float(fits_mat[best, -1]),
            fits=[float(f) for f in fits_mat[best]],
            iters=it,
        )
        return BatchedCPState(
            state=state,
            best_restart=best,
            seeds=seeds,
            fits=fits_mat,
            sync_count=syncs,
        )


def cp_als_fused(
    tensor: SparseTensor,
    rank: int,
    *,
    n_iters: int = 20,
    tol: float = 1e-5,
    seed: int = 0,
    seeds: Sequence[int] | None = None,
    restarts: int = 1,
    fit_every: int = 1,
    impl: str = "ref",
    device: str | torch.device = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
    tile_nnz: int = 256,
    rows_per_block: int = 256,
    init_factors: Sequence[Sequence] | None = None,
    verbose: bool = False,
) -> BatchedCPState:
    """One-shot fused CP-ALS (build the executor, run once)."""
    executor = FusedCPALS(
        tensor,
        rank,
        impl=impl,
        device=device,
        dtype=dtype,
        tile_nnz=tile_nnz,
        rows_per_block=rows_per_block,
    )
    return executor.run(
        n_iters=n_iters,
        tol=tol,
        seed=seed,
        seeds=seeds,
        restarts=restarts,
        fit_every=fit_every,
        init_factors=init_factors,
        verbose=verbose,
    )
