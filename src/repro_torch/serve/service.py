"""Decomposition-as-a-service: multi-tenant batched CP-ALS.

The counterpart of ``repro.serve.service``.  Heterogeneous CP-ALS requests
(tensor, rank, iters, seed) are admitted into a bounded queue, bucketed by
a padded **geometry signature** ``(shape bands, nnz band, rank band,
iters)``, padded to the bucket geometry, and run a batch at a time by
``repro_torch.core.cp_als_fused.MultiTensorCPALS``.  Dispatch is
asynchronous, with a fixed set of in-flight batch slots.

On the card a batch's work is enqueued without waiting for the device,
so one batch's host work overlaps another's device work: the batch's
tensors and initial factors go up from pinned memory, its stacked plans
are built on the device (a sort and scatters, no host count), and the
executor's sweeps never read a result on the host.  Nothing is memoized
per request: a request's operands and plans live as long as its batch.  The batch's
fits come back by an asynchronous copy into pinned memory, and a slot is
ready when a ``torch.cuda.Event`` recorded after that copy has completed;
``_complete`` then reads them once.  All batches run on the current
stream, in launch order.  On the CPU the work is synchronous and a slot is
ready as soon as it is launched.

Padding leaves each result unchanged (value-0 nonzeros, zero factor rows,
zero rank columns), so every response matches a standalone
``cp_als_fused(tensor, rank, tol=0.0)`` run on the same seed within
``FUSED_FIT_TOL``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cp_als import CPState, cp_init
from repro_torch.core.cp_als_fused import MultiTensorCPALS
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.mttkrp.ops import stacked_operands, stacked_plan_buffers
from repro_torch.runtime.metrics import MetricsLogger

__all__ = [
    "DecompRequest",
    "DecompResponse",
    "BucketSignature",
    "bucket_signature",
    "geometry_signature",
    "DecompositionService",
]


# -- requests / responses ---------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class DecompRequest:
    """One tenant's decomposition job.

    ``n_iters`` is a fixed sweep budget (the service runs exactly that
    many ALS sweeps, ``tol=0.0`` semantics): batched early stopping
    would couple one tenant's convergence to its batch peers'.
    """

    request_id: str
    tensor: SparseTensor
    rank: int
    n_iters: int = 10
    seed: int = 0

    def validate(self) -> None:
        if self.tensor.nnz == 0:
            raise ValueError(
                f"request {self.request_id!r}: cp_als requires a tensor with "
                "at least one nonzero"
            )
        if self.rank < 1:
            raise ValueError(f"request {self.request_id!r}: rank must be >= 1")
        if self.n_iters < 1:
            raise ValueError(f"request {self.request_id!r}: n_iters must be >= 1")


@dataclasses.dataclass
class DecompResponse:
    """Served result: a standalone run's ``CPState`` (factors
    trimmed back to the request's true dims/rank, on the service's device)
    plus serving metadata."""

    request_id: str
    signature: "BucketSignature"
    state: CPState
    batch_size: int  # real requests in the dispatched batch (pad slots excluded)
    arrival_t: float
    dispatch_t: float
    complete_t: float

    @property
    def latency_s(self) -> float:
        return self.complete_t - self.arrival_t

    @property
    def queue_wait_s(self) -> float:
        return self.dispatch_t - self.arrival_t

    @property
    def service_s(self) -> float:
        return self.complete_t - self.dispatch_t


# -- bucketing signature ----------------------------------------------------


def _next_pow2(n: int, floor: int) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True, order=True)
class BucketSignature:
    """Padded geometry key: requests with equal signatures share one
    batch.  ``n_iters`` is part of the key because a batch runs one sweep
    budget for all its tensors."""

    dims: tuple[int, ...]  # padded per-mode sizes (power-of-two bands)
    nnz_pad: int  # padded nonzero count (power-of-two band)
    rank_pad: int  # padded rank (power-of-two band)
    n_iters: int

    @property
    def nmodes(self) -> int:
        return len(self.dims)


def geometry_signature(
    shape: Sequence[int],
    nnz: int,
    rank: int,
    n_iters: int = 0,
    *,
    dim_floor: int = 8,
    nnz_floor: int = 64,
    rank_floor: int = 4,
    tile_align: int | None = None,
) -> BucketSignature:
    """Quantize raw tensor geometry onto a padded-geometry band.

    Power-of-two banding bounds the padding waste (< 2x per axis) and the
    number of distinct buckets (log in each axis); the floors keep tiny
    requests from fragmenting into single-request buckets.
    ``tile_align`` additionally rounds ``nnz_pad`` up to a multiple of the
    given kernel tile.
    """
    nnz_pad = _next_pow2(nnz, nnz_floor)
    if tile_align is not None:
        if tile_align < 1:
            raise ValueError(f"tile_align must be >= 1, got {tile_align}")
        nnz_pad = -(-nnz_pad // tile_align) * tile_align
    return BucketSignature(
        dims=tuple(_next_pow2(d, dim_floor) for d in shape),
        nnz_pad=nnz_pad,
        rank_pad=_next_pow2(rank, rank_floor),
        n_iters=int(n_iters),
    )


def bucket_signature(
    req: DecompRequest,
    *,
    dim_floor: int = 8,
    nnz_floor: int = 64,
    rank_floor: int = 4,
    tile_align: int | None = None,
) -> BucketSignature:
    """Quantize a request onto its bucket's padded geometry
    (:func:`geometry_signature` over the request's tensor/rank/iters)."""
    return geometry_signature(
        req.tensor.shape,
        req.tensor.nnz,
        req.rank,
        req.n_iters,
        dim_floor=dim_floor,
        nnz_floor=nnz_floor,
        rank_floor=rank_floor,
        tile_align=tile_align,
    )


# -- per-bucket padded execution -------------------------------------------


def _pad_factor(f: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(f, (0, cols - f.shape[1], 0, rows - f.shape[0]))


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to the card from pinned memory, a copy
    that does not wait for the work already queued."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BucketExecutor:
    """Pads and runs one signature's batches.  Each batch uploads its
    tensors and builds its stacked plans on the device
    (``kernels.mttkrp.ops.stacked_operands`` / ``stacked_plan_buffers``);
    the service keeps nothing of a request once it is answered."""

    def __init__(
        self,
        signature: BucketSignature,
        *,
        device: torch.device,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.signature = signature
        self.device = device
        self.dtype = dtype
        self.core = MultiTensorCPALS(
            signature.dims, nnz_pad=signature.nnz_pad, rank=signature.rank_pad
        )

    def launch(self, requests: Sequence[DecompRequest], *, pad_to: int):
        """Dispatch one padded batch; returns ``run_batch``'s device tensors.

        Short batches are filled to ``pad_to`` with **pad slots** replaying
        request 0, whose results are dropped at completion (the JAX
        service's fixed batch axis; on the card a pad slot is real work).
        """
        *operands, plans = self.stage(requests, pad_to=pad_to)
        return self.core.run_batch(*operands, n_iters=self.signature.n_iters, plans=plans)

    def stage(self, requests: Sequence[DecompRequest], *, pad_to: int):
        """One padded batch's ``run_batch`` arguments on the device:
        ``(indices, values, norm2, factors, plans)``.  The operands are
        uploaded and the plans built for this batch alone; nothing outlives
        the batch's launch."""
        sig = self.signature
        if not 0 < len(requests) <= pad_to:
            raise ValueError(f"batch size {len(requests)} not in (0, {pad_to}]")
        requests = list(requests) + [requests[0]] * (pad_to - len(requests))
        compute_dtype = torch.promote_types(self.dtype, torch.float32)
        tensors = [r.tensor for r in requests]
        indices, values, norm2 = stacked_operands(
            tensors, sig.dims, sig.nnz_pad, device=self.device, dtype=compute_dtype)
        nnz = [t.nnz for t in tensors]
        plans = [stacked_plan_buffers(indices, values, nnz, sig.dims, mode)
                 for mode in range(sig.nmodes)]
        # Drawn on the host (cp_init's generator), padded, stacked, then sent
        # up in one copy per mode that does not wait for the device.
        inits = [
            [
                _pad_factor(f, sig.dims[k], sig.rank_pad)
                for k, f in enumerate(
                    cp_init(r.tensor, r.rank, seed=r.seed, dtype=self.dtype, device="cpu")
                )
            ]
            for r in requests
        ]
        factors = tuple(
            _to_device(torch.stack([init[k] for init in inits]), self.device)
            for k in range(sig.nmodes)
        )
        return indices, values, norm2, factors, plans


# -- the service ------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    request: DecompRequest
    signature: BucketSignature
    arrival_t: float


@dataclasses.dataclass
class _InFlight:
    seq: int
    signature: BucketSignature
    pending: list[_Pending]
    factors: tuple[torch.Tensor, ...]
    weights: torch.Tensor
    fits: torch.Tensor  # (B, n_iters) on the host: pinned, filled by an async copy
    dispatch_t: float
    done: torch.cuda.Event | None  # recorded after that copy; None on the CPU

    def ready(self) -> bool:
        return self.done is None or self.done.query()

    def host_fits(self) -> np.ndarray:
        """The batch's fits; waits for this batch only, not for later ones."""
        if self.done is not None:
            self.done.synchronize()
        return self.fits.numpy().astype(np.float64)


class DecompositionService:
    """Bounded-queue, bounded-in-flight batched CP-ALS server.

    ``tick()`` first retires finished in-flight batches (freeing their
    slots), then forms batches FIFO-by-signature from the queue and
    launches them into free slots.  ``max_inflight`` bounds
    dispatched-but-unread batches, ``max_queue`` bounds
    admitted-but-undispatched requests (backpressure: ``submit`` returns
    False instead of growing without bound).  ``device`` defaults to
    ``"cuda"`` and raises when no GPU is present.
    """

    def __init__(
        self,
        *,
        max_batch: int = 8,
        max_inflight: int = 2,
        max_queue: int = 256,
        device: str | torch.device = DEFAULT_DEVICE,
        dtype: torch.dtype = torch.float32,
        signature_fn: Callable[[DecompRequest], BucketSignature] | None = None,
        autotuner=None,
        metrics: MetricsLogger | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self.dtype = dtype
        # ``autotuner`` is duck-typed: anything with
        # ``config_for(tensor, rank) -> cfg`` where ``cfg.tile_nnz`` is an
        # int.  Buckets then align their padded nonzero stream to the tuned
        # tile; the serve layer imports no tuner.
        self.autotuner = autotuner
        self.signature_fn = signature_fn or self._default_signature
        self.metrics = metrics or MetricsLogger("serve", capacity=4096, quiet=True)
        self.clock = clock

        self._queue: deque[_Pending] = deque()
        self._buckets: dict[BucketSignature, BucketExecutor] = {}
        self._slots: list[_InFlight | None] = [None] * max_inflight
        self._seq = 0
        self.completed: dict[str, DecompResponse] = {}
        self.admitted = 0
        self.rejected = 0

    # -- request admission --------------------------------------------------

    def _default_signature(self, req: DecompRequest) -> BucketSignature:
        tile_align = None
        if self.autotuner is not None:
            cfg = self.autotuner.config_for(req.tensor, req.rank)
            tile_align = int(cfg.tile_nnz)
        return bucket_signature(req, tile_align=tile_align)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return sum(s is not None for s in self._slots)

    def submit(self, request: DecompRequest, *, arrival_t: float | None = None) -> bool:
        """Admit a request; returns False (backpressure) on a full queue.

        A request id already admitted or answered is a caller bug and
        raises — silently shadowing it would make "answered exactly
        once" unverifiable.
        """
        request.validate()
        rid = request.request_id
        if rid in self.completed or any(
            p.request.request_id == rid for p in self._queue
        ) or any(
            s is not None and any(p.request.request_id == rid for p in s.pending)
            for s in self._slots
        ):
            raise ValueError(f"duplicate request_id {rid!r}")
        if len(self._queue) >= self.max_queue:
            self.rejected += 1
            return False
        self._queue.append(
            _Pending(
                request=request,
                signature=self.signature_fn(request),
                arrival_t=self.clock() if arrival_t is None else arrival_t,
            )
        )
        self.admitted += 1
        return True

    # -- scheduler ----------------------------------------------------------

    def tick(self) -> bool:
        """One scheduler iteration; returns True while work remains."""
        retired = self._retire(block=False)
        launched = 0
        while self._queue and self._free_slot() is not None:
            self._launch(*self._next_batch())
            launched += 1
        if not retired and not launched and self.in_flight:
            # All slots busy and nothing finished on its own: block on the
            # oldest batch so the loop always makes progress.
            self._retire(block=True, limit=1)
        return bool(self._queue or self.in_flight)

    def run_until_drained(self, max_ticks: int = 100_000) -> dict[str, DecompResponse]:
        ticks = 0
        while self.tick() and ticks < max_ticks:
            ticks += 1
        return dict(self.completed)

    # -- internals ----------------------------------------------------------

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _next_batch(self) -> tuple[list[_Pending], BucketSignature]:
        """FIFO batch formation: the head of the queue fixes the bucket;
        up to ``max_batch`` same-signature requests join it (others keep
        their queue positions)."""
        sig = self._queue[0].signature
        batch: list[_Pending] = []
        keep: deque[_Pending] = deque()
        while self._queue:
            p = self._queue.popleft()
            if p.signature == sig and len(batch) < self.max_batch:
                batch.append(p)
            else:
                keep.append(p)
        self._queue = keep
        return batch, sig

    def _launch(self, batch: list[_Pending], sig: BucketSignature) -> None:
        slot = self._free_slot()
        assert slot is not None, "caller must hold a free slot"
        executor = self._buckets.get(sig)
        if executor is None:
            executor = self._buckets[sig] = BucketExecutor(
                sig, device=self.device, dtype=self.dtype
            )
        factors, weights, fits = executor.launch(
            [p.request for p in batch], pad_to=self.max_batch
        )
        done = None
        if self.device.type == "cuda":
            host = torch.empty(fits.shape, dtype=fits.dtype, pin_memory=True)
            fits = host.copy_(fits, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        self._seq += 1
        self._slots[slot] = _InFlight(
            seq=self._seq,
            signature=sig,
            pending=batch,
            factors=factors,
            weights=weights,
            fits=fits,
            dispatch_t=self.clock(),
            done=done,
        )

    def _retire(self, *, block: bool, limit: int | None = None) -> int:
        """Slot recycling: harvest finished batches oldest-first.

        ``block=False`` retires only batches whose device work has
        completed; ``block=True`` waits for them (bounded by ``limit``).
        """
        occupied = sorted(
            (i for i, s in enumerate(self._slots) if s is not None),
            key=lambda i: self._slots[i].seq,
        )
        retired = 0
        for i in occupied:
            if limit is not None and retired >= limit:
                break
            inflight = self._slots[i]
            if not block and not inflight.ready():
                continue
            self._complete(inflight)
            self._slots[i] = None
            retired += 1
        return retired

    def _complete(self, inflight: _InFlight) -> None:
        sig = inflight.signature
        fits = inflight.host_fits()  # the batch's one device-to-host read
        now = self.clock()
        for i, p in enumerate(inflight.pending):  # pad slots: i >= len(pending)
            req = p.request
            state = CPState(
                factors=[
                    inflight.factors[k][i, : req.tensor.shape[k], : req.rank]
                    for k in range(sig.nmodes)
                ],
                weights=inflight.weights[i, : req.rank],
                fit=float(fits[i, -1]),
                fits=[float(f) for f in fits[i]],
                iters=sig.n_iters,
            )
            resp = DecompResponse(
                request_id=req.request_id,
                signature=sig,
                state=state,
                batch_size=len(inflight.pending),
                arrival_t=p.arrival_t,
                dispatch_t=inflight.dispatch_t,
                complete_t=now,
            )
            assert req.request_id not in self.completed, "answered twice"
            self.completed[req.request_id] = resp
            self.metrics.log(
                len(self.completed),
                latency_s=resp.latency_s,
                queue_wait_s=resp.queue_wait_s,
                service_s=resp.service_s,
                batch=resp.batch_size,
                queue_depth=self.queue_depth,
                rank=req.rank,
                nnz=req.tensor.nnz,
            )
