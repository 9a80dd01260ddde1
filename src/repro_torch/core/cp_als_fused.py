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
``MultiTensorCPALS`` runs the same sweep over a batch of distinct tensors
of one padded geometry (the service, ``repro_torch.serve``), every mode's
MTTKRP one launch over the batch's stacked plan.  ``ordering=`` selects
the nonzero execution order (``repro_torch.reorder``) and ``autotune=``
takes the plan geometry from a tuner (``repro_torch.dse.autotune``).
``impl="sharded"`` runs the executor on every rank of a
``torch.distributed`` group: each mode's ``ShardedModeSetup`` (the rank's
shard plan on its device) is built once at construction, each MTTKRP is
the rank's split-kernel launch and a collective in ``scheme``, and the fit
sums the ranks' inner products; factors, Grams and solves are replicated.
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
from repro_torch.kernels.mttkrp.kernel import mttkrp_cuda
from repro_torch.kernels.mttkrp.ops import (
    PlanBuffers,
    get_plan,
    mttkrp_from_plan,
    plan_device_buffers,
    tensor_device_operands,
)
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
from repro_torch.reorder.strategies import nonzero_order_tensor

__all__ = [
    "FUSED_FIT_TOL",
    "BatchedCPState",
    "FusedCPALS",
    "MultiTensorCPALS",
    "cp_als_fused",
]

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
        ordering: str | None = None,
        scheme: str = "mode_ordered",
        autotune=None,
    ) -> None:
        # ``autotune`` is duck-typed (``config_for(tensor, rank) -> cfg``
        # with tile_nnz/rows_per_block/ordering fields, in practice
        # ``repro_torch.dse.autotune.Autotuner``) so core never imports the
        # DSE package.  The tuned band winner overrides the plan geometry;
        # an explicitly passed ``ordering`` still wins over the tuned one.
        if autotune is not None:
            cfg = autotune.config_for(tensor, rank)
            tile_nnz = int(cfg.tile_nnz)
            rows_per_block = int(cfg.rows_per_block)
            if ordering is None and cfg.ordering != "lex":
                ordering = cfg.ordering
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
        self.ordering = ordering
        self.scheme = scheme
        self._reduce_inner = None
        if impl == "sharded":
            from repro_torch.distributed import mttkrp_dist  # circular import

            # Fit operands: this rank's block of the raw COO stream.
            self._indices, self._values, self._norm2 = mttkrp_dist.sharded_fit_operands(
                tensor, device=self.device, dtype=compute_dtype)
            self._reduce_inner = mttkrp_dist.all_reduce_sum
            self._setups = [
                mttkrp_dist.sharded_setup(
                    tensor, m, scheme=scheme, ordering=ordering, rows_per_block=rows_per_block,
                    tile_nnz=tile_nnz, device=self.device)
                for m in range(self.nmodes)
            ]
        else:
            # Fit operands: the raw COO stream, as the eager loop reads it.
            self._indices, self._values, self._norm2 = tensor_device_operands(
                tensor, device=self.device, dtype=compute_dtype
            )
        if impl == "ref":
            # Per-mode ordered COO streams when a strategy is asked for; the
            # fit's stream for every mode otherwise.
            shared = (self._indices, self._values)
            self._ref_streams = [shared] * self.nmodes
            if ordering is not None:
                for m in range(self.nmodes):
                    o = nonzero_order_tensor(self._indices, tensor.shape, m, ordering,
                                             rows_per_block=rows_per_block)
                    self._ref_streams[m] = (self._indices[o], self._values[o])
        elif impl == "kernel":
            self._plans = [
                get_plan(tensor, m, tile_nnz=tile_nnz, rows_per_block=rows_per_block,
                         ordering="lex" if ordering is None else ordering,
                         device=self.device)
                for m in range(self.nmodes)
            ]
            # Upload once; every sweep of every restart reuses the buffers.
            for p in self._plans:
                plan_device_buffers(p, self.device)

    def _mttkrp(self, factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
        if self.impl == "ref":
            indices, values = self._ref_streams[mode]
            return mttkrp_ref((indices, values, self.tensor.shape), factors, mode)
        if self.impl == "sharded":
            from repro_torch.distributed.mttkrp_dist import mttkrp_sharded_apply

            return mttkrp_sharded_apply(self._setups[mode], factors)
        return mttkrp_from_plan(self._plans[mode], factors)

    def _sweeps(self, factors, weights, length: int):
        """``length`` sweeps, enqueued without a host sync; fits stay on device."""
        fits = []
        for _ in range(length):
            for mode in range(self.nmodes):
                m = self._mttkrp(factors, mode)
                factors, weights = _mode_update(factors, weights, m, mode)
            fits.append(_fit(self._norm2, self._indices, self._values, factors, weights,
                             reduce_inner=self._reduce_inner))
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


class MultiTensorCPALS:
    """Fused CP-ALS over a batch of DISTINCT tensors with one geometry.

    The counterpart of ``repro.core.cp_als_fused.MultiTensorCPALS``, the
    executor of the multi-tenant service.  All tensors of a batch are
    padded to the same ``(shape, nnz_pad)`` and their factors to the same
    rank; zero-value nonzeros, zero factor rows and zero rank columns leave
    each tensor's result unchanged.

    Where the JAX executor runs ``mttkrp_ref`` vmapped over the batch, this
    one takes the batch as one block-diagonal tensor: ``run_batch`` gets,
    besides the JAX arguments, the batch's stacked plan for every mode
    (``kernels.mttkrp.ops.stacked_plan_buffers``), and each mode's MTTKRP is
    one launch of the split kernel over factors viewed as ``(B * I_k, R)``.
    On CPU tensors the plain version runs on the same stacked buffers.
    """

    def __init__(self, shape: Sequence[int], *, nnz_pad: int, rank: int) -> None:
        if nnz_pad < 1:
            raise ValueError(f"nnz_pad must be >= 1, got {nnz_pad}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.shape = tuple(int(s) for s in shape)
        self.nmodes = len(self.shape)
        self.nnz_pad = int(nnz_pad)
        self.rank = int(rank)

    def _mttkrp(self, plan: PlanBuffers, factors: Sequence[torch.Tensor], mode: int):
        batch = int(factors[0].shape[0])
        flat = [f.view(-1, self.rank) for f in factors]  # (B * I_k, R)
        i_out = batch * self.shape[mode]
        if flat[0].device.type == "cuda":
            out = mttkrp_cuda(plan, flat, mode, i_out)
        else:
            out = mttkrp_plan_ref(plan, flat, mode, i_out)
        return out.view(batch, self.shape[mode], self.rank).to(factors[mode].dtype)

    def run_batch(
        self,
        indices: torch.Tensor,  # (B, nnz_pad, nmodes) int32
        values: torch.Tensor,  # (B, nnz_pad)
        norm2: torch.Tensor,  # (B,)
        factors: Sequence[torch.Tensor],  # per mode: (B, I_k_pad, rank)
        *,
        n_iters: int,
        plans: Sequence[PlanBuffers],
    ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
        """Run ``n_iters`` fused sweeps on every tensor in the batch.

        ``plans`` (one per mode, the batch's stacked plan in the order of the
        batch) is the port's argument; the rest are the JAX executor's.
        Returns ``(factors, weights, fits)`` with ``fits`` of shape
        ``(B, n_iters)``, all left on the device.  On CUDA tensors nothing
        here waits for the device: the caller decides when to read.
        """
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        if tuple(indices.shape[1:]) != (self.nnz_pad, self.nmodes):
            raise ValueError(
                f"indices shape {tuple(indices.shape)} does not match geometry "
                f"(B, {self.nnz_pad}, {self.nmodes})"
            )
        batch = int(indices.shape[0])
        for k, f in enumerate(factors):
            if tuple(f.shape[1:]) != (self.shape[k], self.rank):
                raise ValueError(
                    f"factor {k} shape {tuple(f.shape)} does not match geometry "
                    f"(B, {self.shape[k]}, {self.rank})"
                )
            if f.shape[0] != batch or not f.is_contiguous():
                raise ValueError(f"factor {k} must be a contiguous batch of {batch}")
        if len(plans) != self.nmodes:
            raise ValueError(f"{len(plans)} stacked plans for {self.nmodes} modes")
        factors = tuple(factors)
        weights = torch.ones((batch, self.rank), dtype=factors[0].dtype, device=factors[0].device)
        fits = []
        for _ in range(n_iters):
            for mode in range(self.nmodes):
                m = self._mttkrp(plans[mode], factors, mode)
                factors, weights = _mode_update(factors, weights, m, mode)
            fits.append(_fit(norm2, indices, values, factors, weights))
        return factors, weights, torch.stack(fits, dim=-1)


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
    ordering: str | None = None,
    init_factors: Sequence[Sequence] | None = None,
    verbose: bool = False,
    autotune=None,
    scheme: str = "mode_ordered",
) -> BatchedCPState:
    """One-shot fused CP-ALS (build the executor, run once).

    ``cp_als(..., fused=True)`` wraps this and returns ``.state``;
    ``scheme`` is the ``impl="sharded"`` executor's.
    """
    executor = FusedCPALS(
        tensor,
        rank,
        impl=impl,
        device=device,
        dtype=dtype,
        tile_nnz=tile_nnz,
        rows_per_block=rows_per_block,
        ordering=ordering,
        scheme=scheme,
        autotune=autotune,
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
