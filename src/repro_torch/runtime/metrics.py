"""Step metrics logging: stdout + bounded in-memory ring with percentiles.

A numpy copy of ``repro.runtime.metrics`` (the port imports nothing of the
JAX package): the metrics backend of the decomposition service
(``repro_torch.serve``), which needs two things a training loop never
asked for:

  * **bounded capacity** — a long-lived server logs one row per response
    forever; the ring keeps only the newest ``capacity`` rows so memory
    is O(capacity), not O(lifetime);
  * **percentile summaries** — serving SLOs are quantiles (p50/p99
    latency), not means; ``percentile``/``summary`` compute them over
    whatever window the ring currently holds.

``capacity=None`` keeps every row; ``quiet=True`` suppresses the per-row
stdout line for hot serving loops.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(
        self,
        prefix: str = "train",
        *,
        capacity: int | None = None,
        quiet: bool = False,
    ):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.prefix = prefix
        self.capacity = capacity
        self.quiet = quiet
        self.rows: deque[dict] = deque(maxlen=capacity)
        self.total_logged = 0  # lifetime count, survives ring eviction
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        row = {"step": step, "t": time.time() - self._t0, **metrics}
        self.rows.append(row)
        self.total_logged += 1
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(f"[{self.prefix}] step={step} {parts}", flush=True)

    # -- ring queries --------------------------------------------------------

    def values(self, key: str) -> list[float]:
        """All retained values of ``key``, oldest first (rows without the
        key are skipped — heterogeneous rows are legal)."""
        return [float(r[key]) for r in self.rows if key in r]

    def percentile(self, key: str, q: float) -> float:
        """q-th percentile (0..100) of the retained ``key`` values.

        Raises ``ValueError`` on an empty window: a missing quantile must
        fail loudly, never read as "zero latency".
        """
        vals = self.values(key)
        if not vals:
            raise ValueError(f"no values logged for {key!r}")
        return float(np.percentile(np.asarray(vals, dtype=np.float64), q))

    #: The statistics every ``summary`` dict carries besides ``count``.
    SUMMARY_STATS = ("mean", "min", "max", "p50", "p99")

    def summary(self, key: str) -> dict:
        """Count/mean/min/max/p50/p99 of the retained ``key`` values.

        The shape is total: every ``SUMMARY_STATS`` key is always
        present.  An empty window answers ``count=0`` with ``None`` for
        each statistic — callers indexing ``summary(k)["p99"]`` get an
        unmistakable ``None`` (which comparisons reject loudly) instead
        of a ``KeyError`` three frames later.  Point queries that cannot
        answer (``percentile``) still raise ``ValueError``.
        """
        vals = np.asarray(self.values(key), dtype=np.float64)
        if vals.size == 0:
            return {"count": 0, **{stat: None for stat in self.SUMMARY_STATS}}
        return {
            "count": int(vals.size),
            "mean": float(vals.mean()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "p50": float(np.percentile(vals, 50)),
            "p99": float(np.percentile(vals, 99)),
        }
