"""RNG-pinned open-loop synthetic traffic for the decomposition service.

The counterpart of ``repro.serve.traffic``, draw for draw: ``synthetic_trace``
draws a Poisson arrival process over heterogeneous ``random_sparse_tensor``
configs (jittered dims, nnz, rank, seed per request) from one
``np.random.default_rng(seed)`` stream, so the same seed yields the same
requests, array for array, at the same arrival offsets as the JAX package.

``replay_trace`` drives a service open-loop: arrivals are released at their
trace offsets regardless of service backlog (queueing shows up as latency,
not as a slowed generator).  ``time_scale=0`` collapses all arrivals to
t=0, turning the replay into a closed-loop drain.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.serve.service import DecompositionService, DecompRequest, DecompResponse

__all__ = ["TrafficConfig", "synthetic_trace", "replay_trace"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Shape of the synthetic tenant population.

    ``base_dims`` seeds the dim draw; per-request jitter (``dim_jitter``
    fractional) keeps tensors *distinct* while power-of-two banding maps
    them onto a handful of buckets.  ``mean_interarrival_s`` sets the
    open-loop Poisson rate.
    """

    n_requests: int = 32
    mean_interarrival_s: float = 0.002
    base_dims: tuple[int, ...] = (48, 40, 36)
    dim_jitter: float = 0.25
    nnz_range: tuple[int, int] = (600, 1000)
    ranks: tuple[int, ...] = (5, 8)
    n_iters: int = 3
    zipf_a: float | None = 1.1
    seed: int = 0


def synthetic_trace(cfg: TrafficConfig) -> list[tuple[float, DecompRequest]]:
    """Deterministic (arrival_offset_s, request) pairs, arrival-sorted."""
    if cfg.n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {cfg.n_requests}")
    rng = np.random.default_rng(cfg.seed)
    arrivals = np.cumsum(rng.exponential(cfg.mean_interarrival_s, cfg.n_requests))
    trace: list[tuple[float, DecompRequest]] = []
    for i in range(cfg.n_requests):
        dims = tuple(
            max(4, int(round(d * (1.0 + rng.uniform(-cfg.dim_jitter, cfg.dim_jitter)))))
            for d in cfg.base_dims
        )
        nnz = int(rng.integers(cfg.nnz_range[0], cfg.nnz_range[1] + 1))
        tensor = random_sparse_tensor(
            dims, nnz, seed=int(rng.integers(2**31)), zipf_a=cfg.zipf_a
        )
        req = DecompRequest(
            request_id=f"req-{cfg.seed}-{i:04d}",
            tensor=tensor,
            rank=int(rng.choice(cfg.ranks)),
            n_iters=cfg.n_iters,
            seed=int(rng.integers(2**31)),
        )
        trace.append((float(arrivals[i]), req))
    return trace


def replay_trace(
    service: DecompositionService,
    trace: list[tuple[float, DecompRequest]],
    *,
    time_scale: float = 1.0,
    max_ticks: int = 100_000,
) -> dict[str, DecompResponse]:
    """Open-loop replay: release each request at its arrival offset.

    Between arrivals the service keeps ticking (retiring / dispatching);
    when it is idle ahead of the next arrival the replay sleeps the
    remaining gap rather than spinning.  Returns the completed-response
    map after a full drain.  Rejected submissions (backpressure) are NOT
    retried — an open-loop generator does not slow down for the server;
    the caller reads ``service.rejected``.
    """
    events = sorted(trace, key=lambda e: e[0])
    t0 = time.perf_counter()
    i = 0
    while i < len(events):
        due_at = events[i][0] * time_scale
        now = time.perf_counter() - t0
        if now >= due_at:
            service.submit(events[i][1])
            i += 1
            continue
        if service.tick():
            continue  # busy: keep serving until the next arrival is due
        time.sleep(min(due_at - now, 0.01))
    service.run_until_drained(max_ticks=max_ticks)
    return dict(service.completed)
