"""Copy of ``repro.core.cache_sim`` for the PyTorch port (numpy only, held
equal to the original by ``tests/test_torch_perf_model.py``).

Trace-driven set-associative LRU cache simulator (paper Figs. 5 & 6).

Models the paper's cache subsystem: per-PE caches holding factor-matrix
rows, 4-way set-associative, 4096 lines x 64 B, LRU replacement, with the
dual PE/MEM pipeline abstracted to hit/miss accounting (timing effects of
misses are applied by the accelerator model, not here).

Three entry points:
  * ``simulate_trace``  — exact simulation over an index trace (executable
    small/scaled tensors);
  * ``simulate_traces`` — the same simulation over several independent
    cache units (per-PE caches / per-shard traces), aggregated — the
    trace-capture hook the experiment engine (repro.experiments) feeds
    with EXECUTED nonzero orders (DESIGN.md §7);
  * ``che_hit_rate``    — Che's approximation for LRU under an IRM with a
    Zipf popularity law (used for the full-size FROSTT tensors whose raw
    data is unavailable offline; DESIGN.md §7).

``CacheStats`` additionally tracks compulsory (first-touch) misses so a
finite measured trace can be reconciled with Che's steady-state
prediction: ``warm_hit_rate`` excludes the cold start, which is what the
measured-vs-modeled residual report compares against (DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "CacheConfig",
    "CacheStats",
    "TraceFlags",
    "simulate_trace",
    "simulate_trace_flags",
    "simulate_traces",
    "che_hit_rate",
]


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Paper Table I cache-subsystem defaults."""

    num_lines: int = 4096
    line_bytes: int = 64
    associativity: int = 4

    @property
    def num_sets(self) -> int:
        return self.num_lines // self.associativity

    @property
    def capacity_bytes(self) -> int:
        return self.num_lines * self.line_bytes


@dataclasses.dataclass
class CacheStats:
    accesses: int
    hits: int
    cold_misses: int = 0  # compulsory (first-touch) misses within the trace

    @property
    def misses(self) -> int:
        return self.accesses - self.hits

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def warm_hit_rate(self) -> float:
        """Hit rate with the cold start excluded: hits over the accesses
        that COULD have hit (everything but first touches).  This is the
        steady-state quantity comparable to ``che_hit_rate`` (which models
        an infinite trace and so never sees compulsory misses).

        Empty or all-cold-miss traces report 0.0: with zero warm accesses
        there is no evidence of reuse, and the historical 1.0 silently
        inflated the measured side of the reconciliation whenever a shard
        or mode slice owned zero nonzeros (DESIGN.md §7)."""
        warm = self.accesses - self.cold_misses
        return self.hits / warm if warm > 0 else 0.0

    def merge(self, other: "CacheStats") -> "CacheStats":
        """Aggregate counts across independent cache units (per-PE / shard)."""
        return CacheStats(
            accesses=self.accesses + other.accesses,
            hits=self.hits + other.hits,
            cold_misses=self.cold_misses + other.cold_misses,
        )


def simulate_trace(
    trace: np.ndarray, cfg: CacheConfig = CacheConfig(), *, row_bytes: int = 64
) -> CacheStats:
    """Simulate LRU set-associative cache over a row-index trace.

    ``trace`` holds factor-matrix ROW indices; a row occupies
    ``ceil(row_bytes / line_bytes)`` consecutive lines (R=16 fp32 rows are
    exactly one 64 B line, the paper's configuration).

    When a row is exactly one line the fast path applies: the set index
    stream is precomputed with NumPy and each set's subsequence is
    simulated with an O(1)-per-access LRU (dict ordering), avoiding the
    per-access ``np.nonzero`` of the generic path.  Hit/miss counts are
    order-independent across sets, so grouping by set is exact; both
    paths model the same LRU policy (invalid ways fill first) and agree
    access-for-access (tests/test_hierarchy.py).
    """
    lines_per_row = max(1, -(-row_bytes // cfg.line_bytes))
    n_sets = cfg.num_sets
    assoc = cfg.associativity

    if lines_per_row == 1:
        return _simulate_single_line_rows(
            np.asarray(trace, dtype=np.int64), n_sets, assoc
        )

    tags = np.full((n_sets, assoc), -1, dtype=np.int64)
    stamp = np.zeros((n_sets, assoc), dtype=np.int64)
    accesses = 0
    hits = 0
    t = 0
    seen: set[int] = set()
    for row in trace:
        base = int(row) * lines_per_row
        for off in range(lines_per_row):
            line = base + off
            s = line % n_sets
            accesses += 1
            t += 1
            if line not in seen:
                seen.add(line)
            way = np.nonzero(tags[s] == line)[0]
            if way.size:
                hits += 1
                stamp[s, way[0]] = t
            else:
                victim = int(np.argmin(stamp[s]))
                tags[s, victim] = line
                stamp[s, victim] = t
    return CacheStats(accesses=accesses, hits=hits, cold_misses=len(seen))


def _simulate_single_line_rows(rows: np.ndarray, n_sets: int, assoc: int) -> CacheStats:
    """Fast exact LRU for the one-line-per-row case (paper's R=16 fp32).

    Vectorized preprocessing: the row→set mapping and the stable grouping
    of accesses by set happen in NumPy; LRU order within a set is then a
    dict (insertion-ordered), giving O(1) lookup / move-to-end / evict per
    access.  Per-set simulation is exact because a set-associative cache's
    sets are independent and hit counting is order-insensitive across sets.
    """
    if rows.size == 0:
        return CacheStats(accesses=0, hits=0)
    sets = rows % n_sets
    order = np.argsort(sets, kind="stable")  # per-set subsequences, in time order
    grouped = rows[order]
    boundaries = np.flatnonzero(np.diff(sets[order])) + 1
    hits = 0
    cold = 0
    for seg in np.split(grouped, boundaries):
        lru: dict[int, None] = {}
        seen: set[int] = set()
        for line in seg.tolist():
            if line not in seen:
                seen.add(line)
                cold += 1
            if line in lru:
                hits += 1
                del lru[line]  # re-insertion moves it to MRU position
            elif len(lru) >= assoc:
                del lru[next(iter(lru))]  # evict true LRU (oldest key)
            lru[line] = None
    return CacheStats(accesses=int(rows.size), hits=hits, cold_misses=cold)


@dataclasses.dataclass(frozen=True)
class TraceFlags:
    """Per-access outcome of ``simulate_trace_flags``.

    ``hits[i]`` is the LRU hit/miss of access ``i`` of the trace;
    ``prefetch_fills[i]`` counts the lines the prefetcher inserted on
    behalf of access ``i`` (0 unless the access missed and
    ``prefetch_depth > 0``).  Aggregates match ``simulate_trace`` exactly
    when prefetching is off (tests/test_controller.py).
    """

    hits: np.ndarray  # bool[N]
    prefetch_fills: np.ndarray  # int32[N]
    trace: np.ndarray  # int64[N] — the replayed row stream

    @property
    def stats(self) -> CacheStats:
        # Compulsory misses: first-ever touches that missed (with
        # prefetching, a first touch can hit — the fill already paid).
        _, first = np.unique(self.trace, return_index=True)
        return CacheStats(
            accesses=int(self.hits.size),
            hits=int(self.hits.sum()),
            cold_misses=int(np.count_nonzero(~self.hits[first])),
        )


def simulate_trace_flags(
    trace: np.ndarray,
    cfg: CacheConfig = CacheConfig(),
    *,
    row_bytes: int = 64,
    prefetch_depth: int = 0,
    catalog_rows: int | None = None,
) -> TraceFlags:
    """Per-access hit flags of the LRU simulation, with optional next-line
    prefetch — the trace-consumer the cycle-level controller model
    (repro.model.controller, DESIGN.md §14) replays through banked queues.

    Same replacement policy as ``simulate_trace``; with
    ``prefetch_depth=0`` the two agree access-for-access, which is what
    pins the controller's degenerate configuration to the analytic
    hierarchy.  Rows must fit one line (``row_bytes <= line_bytes``, the
    paper's R=16 fp32 rows in 64 B lines): the controller issues requests
    at row granularity and a multi-line row would split one request
    across banks.

    ``prefetch_depth=D`` models a sequential next-line prefetcher: a miss
    on row ``r`` additionally fills rows ``r+1 .. r+D`` (bounded by
    ``catalog_rows``) into their sets as MRU, evicting LRU lines.  Fills
    of already-resident lines are free.  Prefetch traffic is charged by
    the caller from ``prefetch_fills`` (fills move DRAM bytes); future
    accesses to prefetched lines hit.  The prefetching path is inherently
    sequential (a fill in one set is triggered by a miss in another, so
    sets cannot be simulated independently); the ``prefetch_depth=0``
    path reuses the vectorized per-set grouping of ``simulate_trace``.
    """
    rows = np.asarray(trace, dtype=np.int64)
    n_sets = cfg.num_sets
    assoc = cfg.associativity
    lines_per_row = max(1, -(-row_bytes // cfg.line_bytes))
    if lines_per_row != 1:
        raise ValueError(
            f"simulate_trace_flags needs single-line rows: row_bytes="
            f"{row_bytes} spans {lines_per_row} lines of {cfg.line_bytes} B"
        )
    if prefetch_depth < 0:
        raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
    flags = np.zeros(rows.size, dtype=bool)
    fills = np.zeros(rows.size, dtype=np.int32)
    if rows.size == 0:
        return TraceFlags(hits=flags, prefetch_fills=fills, trace=rows)

    if prefetch_depth == 0:
        # Vectorized per-set grouping, as in _simulate_single_line_rows.
        sets = rows % n_sets
        order = np.argsort(sets, kind="stable")
        grouped = rows[order]
        boundaries = np.flatnonzero(np.diff(sets[order])) + 1
        pos = 0
        for seg in np.split(grouped, boundaries):
            lru: dict[int, None] = {}
            for j, line in enumerate(seg.tolist()):
                if line in lru:
                    flags[order[pos + j]] = True
                    del lru[line]  # re-insertion moves it to MRU position
                elif len(lru) >= assoc:
                    del lru[next(iter(lru))]  # evict true LRU
                lru[line] = None
            pos += len(seg)
        return TraceFlags(hits=flags, prefetch_fills=fills, trace=rows)

    limit = int(catalog_rows) if catalog_rows is not None else None
    sets_lru: list[dict[int, None]] = [dict() for _ in range(n_sets)]
    for i, line in enumerate(rows.tolist()):
        lru = sets_lru[line % n_sets]
        if line in lru:
            flags[i] = True
            del lru[line]
            lru[line] = None
            continue
        if len(lru) >= assoc:
            del lru[next(iter(lru))]
        lru[line] = None
        n_fills = 0
        for d in range(1, prefetch_depth + 1):
            nxt = line + d
            if limit is not None and nxt >= limit:
                break
            plru = sets_lru[nxt % n_sets]
            if nxt in plru:
                continue  # already resident: no fill, LRU order untouched
            if len(plru) >= assoc:
                del plru[next(iter(plru))]
            plru[nxt] = None
            n_fills += 1
        fills[i] = n_fills
    return TraceFlags(hits=flags, prefetch_fills=fills, trace=rows)


def simulate_traces(
    traces: Sequence[np.ndarray],
    cfg: CacheConfig = CacheConfig(),
    *,
    row_bytes: int = 64,
) -> CacheStats:
    """Simulate several independent cache units and aggregate their counts.

    Each trace is one unit's row-index access stream — a per-PE cache in
    the paper's accelerator, or a per-shard stream of the distributed
    path.  Units do not share state (the paper's caches are private per
    PE), so hits/misses simply sum.  This is the entry point the
    experiment engine uses on EXECUTED nonzero orders captured from the
    MTTKRP execution plan (``MTTKRPPlan.executed_row_trace``) or the
    shard partitioning (DESIGN.md §7).
    """
    total = CacheStats(accesses=0, hits=0)
    for trace in traces:
        total = total.merge(simulate_trace(np.asarray(trace), cfg, row_bytes=row_bytes))
    return total


def che_hit_rate(
    num_rows: int,
    cache_rows: int,
    *,
    zipf_alpha: float = 0.7,
    samples: int = 200_000,
    trace_length: float | None = None,
) -> float:
    """Che's approximation: LRU hit rate for Zipf(alpha) popularity.

    Solves sum_i (1 - exp(-p_i * T)) = C for the characteristic time T,
    then hit = sum_i p_i (1 - exp(-p_i * T)).  For num_rows <= cache_rows
    this returns ~1 (compulsory misses are handled by the caller).

    ``trace_length`` extends the approximation to a FINITE trace of L
    accesses (the transient/cold-start regime a measured executed trace
    lives in, DESIGN.md §7): the hit probability of the access at
    position t is ``1 − exp(−p_i · min(T, t))`` — the reuse window cannot
    reach back before the trace starts — averaged in closed form over
    t ∈ [0, L].  It interpolates between ``1 − E[distinct]/L`` in the
    never-evict regime (L ≤ T, e.g. a cache larger than the catalog) and
    the steady-state Che value as L → ∞, which is what makes a finite
    measured run comparable to the model at all.

    ``num_rows`` may also be given as a popularity/row vector (only its
    length is used, the catalog size); a LENGTH-1 array is treated as an
    unsqueezed scalar (a dims slice), not as a one-row catalog.  An
    EMPTY catalog — a shard or mode slice that owns zero nonzeros —
    returns 0.0: nothing can ever hit.  (Historically an empty vector
    crashed the solve with ``TypeError: only length-1 arrays ...`` and a
    zero count reported a fictitious 1.0.)
    """
    if np.ndim(num_rows) > 0:
        arr = np.asarray(num_rows)
        num_rows = int(arr.reshape(-1)[0]) if arr.size == 1 else int(arr.shape[0])
    num_rows = int(num_rows)
    if num_rows <= 0:
        return 0.0
    if trace_length is None and num_rows <= cache_rows:
        return 1.0
    n = min(num_rows, samples)
    # Subsample ranks geometrically for very large catalogs to keep it fast.
    if num_rows > samples:
        ranks = np.unique(
            np.geomspace(1, num_rows, samples).astype(np.int64)
        ).astype(np.float64)
        edges = np.concatenate([[0.5], (ranks[:-1] + ranks[1:]) / 2.0, [num_rows + 0.5]])
        weights = edges[1:] - edges[:-1]  # how many ranks each sample represents
    else:
        ranks = np.arange(1, n + 1, dtype=np.float64)
        weights = np.ones_like(ranks)
    p = ranks ** (-zipf_alpha)
    z = float((p * weights).sum())
    p /= z

    if num_rows <= cache_rows:
        t_char = np.inf  # nothing is ever evicted
    else:
        lo, hi = 1.0, 1e16
        for _ in range(200):
            mid = np.sqrt(lo * hi)
            filled = float(((1.0 - np.exp(-p * mid)) * weights).sum())
            if filled > cache_rows:
                hi = mid
            else:
                lo = mid
            if hi / lo < 1 + 1e-9:
                break
        t_char = np.sqrt(lo * hi)

    if trace_length is None:
        hit = float((p * (1.0 - np.exp(-p * t_char)) * weights).sum())
        return min(max(hit, 0.0), 1.0)

    L = float(trace_length)
    if L <= 0:
        return 1.0
    if L <= t_char:
        # reuse window never saturates: average of 1 − exp(−p·t) over [0, L]
        term = 1.0 - (1.0 - np.exp(-p * L)) / (p * L)
    else:
        # saturated tail at min(T, t) = T plus the transient head [0, T]
        term = 1.0 - (
            (1.0 - np.exp(-p * t_char)) / p + (L - t_char) * np.exp(-p * t_char)
        ) / L
    hit = float((p * term * weights).sum())
    return min(max(hit, 0.0), 1.0)
