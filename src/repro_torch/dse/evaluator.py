"""Vectorized sweep evaluation with memoized cache-hit-rate results.

Copy of ``repro.dse.evaluator`` for the PyTorch port (numpy, held equal to
the original by ``tests/test_torch_dse.py``).  The one addition is
``device=`` wherever a trace is linearized: an ordering other than
``"lex"`` is sorted there (``repro_torch.reorder``, default ``"cuda"``).

Every ``SweepPoint`` resolves to a ``repro_torch.core.hierarchy.MemoryHierarchy``
and is priced by the same multi-level engine — the FPGA technologies, the
TPU-v5e roofline, and the photonic-IMC stack take one code path
(DESIGN.md §9); there is no per-technology dispatch here.

Pricing is cheap arithmetic EXCEPT for the cache hit rates, which need
either a Che fixed-point solve or an exact LRU trace simulation
(``repro_torch.core.cache_sim``, DESIGN.md §7).  Hit rates depend only on a
level's ``CacheGeometry``, the tensor, the mode and the rank — never on
the memory technology — so a ``HitRateCache`` keyed by
``CacheGeometry.key()`` (the single declared geometry tuple) turns an
A×B×…-point sweep into one hit-rate solve per (geometry, tensor, mode)
plus batched NumPy arithmetic over all points sharing a hierarchy shape
(DESIGN.md §8).

Hit-rate methods, chosen per tensor:
  * ``"che"``   — Che's LRU approximation on the full-size Table II
    characteristics (the analytical path; what the paper tables use);
  * ``"trace"`` — exact set-associative LRU simulation over an executable
    tensor's mode-ordered index trace (small / synthetic tensors);
  * ``"auto"``  — ``"trace"`` when the tensor's nonzero count is within
    ``trace_nnz_limit`` (simulation cost is O(nnz·modes)), else ``"che"``.
Fully-associative levels (``associativity=None``, e.g. TPU VMEM) are
Che-only: simulating millions of ways per access is pointless when Che is
exact in the fully-associative IRM limit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import torch

from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.cache_sim import CacheConfig, simulate_trace
from repro_torch.core.hierarchy import (
    CacheGeometry,
    ModeTime,
    TpuModeTime,
    hierarchy_energy_batch,
    hierarchy_mode_times_batch,
    scratchpad_hit_rates,
    split_capacity_hit_rates,
)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data.frostt import FROSTT_TENSORS, FrosttTensor
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.dse.sweep import SweepPoint

__all__ = [
    "HitRateCache",
    "PointTensorResult",
    "SweepResult",
    "exact_hit_rates",
    "evaluate_sweep",
    "geometry_sim_config",
]

# Above this nonzero count the exact LRU simulation is slower than the Che
# solve by orders of magnitude; "auto" falls back to the approximation
# (DESIGN.md §7).
TRACE_NNZ_LIMIT = 200_000


def _geometry_of(accel: AcceleratorConfig) -> CacheGeometry:
    """The combined cache-subsystem geometry of a Table-I accelerator."""
    return CacheGeometry(
        capacity_bytes=accel.n_caches * accel.cache.capacity_bytes,
        line_bytes=accel.cache.line_bytes,
        associativity=accel.cache.associativity,
    )


def geometry_sim_config(
    geometry: CacheGeometry, rank: int, *, n_inputs: int
) -> tuple[CacheConfig, int]:
    """One input factor's share of a level as a simulatable ``CacheConfig``.

    Mirrors the capacity split of ``split_capacity_hit_rates``: the
    level's capacity is divided evenly across the ``n_inputs`` input
    factor matrices.  Returns ``(config, row_bytes)`` ready for
    ``cache_sim.simulate_trace(s)``.  The single definition shared by the
    DSE trace method and the experiment engine's executed-trace
    measurement (repro_torch.experiments), so the two cannot drift.
    """
    row_bytes = rank * 4
    line_bytes = geometry.line_bytes if geometry.line_bytes is not None else row_bytes
    lines_per_row = max(1, -(-row_bytes // line_bytes))
    total_rows = geometry.capacity_bytes // row_bytes
    rows_per_input = max(1, total_rows // max(1, n_inputs))

    # associativity=None means fully associative: one set holding the
    # whole share.  (HitRateCache routes such levels to Che for speed, but
    # the simulation stays well-defined for direct callers and tests.)
    max_ways = rows_per_input * lines_per_row
    assoc_limit = geometry.associativity if geometry.associativity is not None else max_ways
    assoc = min(assoc_limit, max_ways)
    num_lines = rows_per_input * lines_per_row
    num_lines = max(assoc, -(-num_lines // assoc) * assoc)  # multiple of assoc
    cfg = CacheConfig(num_lines=num_lines, line_bytes=line_bytes, associativity=assoc)
    return cfg, row_bytes


def exact_hit_rates_for_geometry(
    tensor: SparseTensor,
    mode: int,
    geometry: CacheGeometry,
    rank: int,
    *,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> tuple[float, ...]:
    """Exact LRU hit rate per input factor over the strategy-ordered trace.

    Each input's row-index column of the executed nonzero stream —
    ``ordering``-linearized via ``repro_torch.reorder.trace_view`` (for
    ``"degree"`` this includes the hot-row relabeling, whose whole point
    is the changed line/set mapping; DESIGN.md §10) — is simulated
    against its capacity share (``geometry_sim_config``).
    """
    n_inputs = max(1, tensor.nmodes - 1)
    cfg, row_bytes = geometry_sim_config(geometry, rank, n_inputs=n_inputs)

    if ordering == "lex":
        ordered = tensor.mode_sorted(mode)
    else:
        from repro_torch.reorder import trace_view

        ordered = trace_view(tensor, mode, ordering, device=device)
    hits = []
    for k in range(tensor.nmodes):
        if k == mode:
            continue
        stats = simulate_trace(ordered.indices[:, k], cfg, row_bytes=row_bytes)
        hits.append(stats.hit_rate)
    return tuple(hits)


def exact_hit_rates(
    tensor: SparseTensor,
    mode: int,
    accel: AcceleratorConfig,
    rank: int,
) -> tuple[float, ...]:
    """Historical entry point: exact hit rates for a Table-I accelerator."""
    return exact_hit_rates_for_geometry(tensor, mode, _geometry_of(accel), rank)


class HitRateCache:
    """Memo for per-(CacheGeometry, tensor, mode, rank, method, ordering)
    hit rates.  The ordering strategy (repro_torch.reorder, DESIGN.md §10) only
    distinguishes entries for the trace method — Che is order-blind, so
    che entries normalize it away and one solve serves every strategy.

    The key is derived from ``CacheGeometry.key()`` — the single declared
    tuple of geometry fields; ``repro_torch.core.hierarchy`` asserts at import
    time that every geometry field is in it, so a new hierarchy-level
    field cannot silently alias memo entries (DESIGN.md §8 step 3).

    ``hits``/``misses`` count lookups so tests (and the benchmark's
    trajectory artifact) can verify the memoization is actually working.
    """

    def __init__(self) -> None:
        self._store: dict[tuple, tuple[float, ...]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def get(
        self,
        tensor: FrosttTensor,
        mode: int,
        geometry: CacheGeometry,
        rank: int,
        *,
        method: str = "che",
        trace: SparseTensor | None = None,
        trace_nnz_limit: int = TRACE_NNZ_LIMIT,
        ordering: str = "lex",
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> tuple[float, ...]:
        if method not in ("che", "trace", "auto"):
            raise ValueError(f"unknown hit-rate method {method!r}")
        if geometry.associativity is None:
            method = "che"  # fully-associative Che-only level (module doc)
        if method == "auto":
            executable = trace if trace is not None else _executable_for(tensor)
            if executable is not None and executable.nnz <= trace_nnz_limit:
                method, trace = "trace", executable
            else:
                method = "che"
        if method == "che":
            # Che's IRM is order-blind: every ordering strategy shares one
            # solve (DESIGN.md §10), so normalize the memo key.
            ordering = "lex"
        # For the trace method the tensor NAME is not enough: a shared
        # cache may see different trace tensors under the same name, so
        # fingerprint the trace object itself.
        trace_key = (
            (id(trace), trace.nnz, trace.shape)
            if (method == "trace" and trace is not None)
            else None
        )
        key = (tensor.name, mode, rank, method, trace_key, ordering) + geometry.key()
        if key in self._store:
            self.hits += 1
            return self._store[key]
        self.misses += 1
        if method == "che":
            rates = split_capacity_hit_rates(
                tensor, mode, capacity_bytes=geometry.capacity_bytes, rank=rank
            )
        else:
            if trace is None:
                trace = _executable_for(tensor)
            if trace is None:
                raise ValueError(
                    f"no executable trace available for {tensor.name!r}; "
                    "pass trace_tensors= or use method='che'"
                )
            rates = exact_hit_rates_for_geometry(
                trace, mode, geometry, rank, ordering=ordering, device=device
            )
        self._store[key] = rates
        return rates


@functools.lru_cache(maxsize=None)
def _executable_for_name(name: str) -> SparseTensor | None:
    """Scaled executable stand-in for a Table II tensor (DESIGN.md §7)."""
    if name not in FROSTT_TENSORS:
        return None
    from repro_torch.data.synthetic_tensors import make_frostt_like

    return make_frostt_like(name, scale=1e-3, seed=0)


def _executable_for(tensor: FrosttTensor) -> SparseTensor | None:
    return _executable_for_name(tensor.name)


@dataclasses.dataclass(frozen=True)
class PointTensorResult:
    """One (configuration, tensor) cell of a sweep."""

    label: str
    tensor: str
    mode_times: tuple[ModeTime | TpuModeTime, ...]
    energy_j: float | None  # None when the stack has no Eq-2 constants
    energy_breakdown: dict | None

    @property
    def seconds(self) -> float:
        return sum(mt.seconds for mt in self.mode_times)

    @property
    def mode_seconds(self) -> tuple[float, ...]:
        return tuple(mt.seconds for mt in self.mode_times)

    @property
    def bottlenecks(self) -> tuple[str, ...]:
        return tuple(mt.bottleneck for mt in self.mode_times)


@dataclasses.dataclass
class SweepResult:
    """All (point, tensor) cells of a sweep + the shared hit-rate memo."""

    results: list[PointTensorResult]
    cache: HitRateCache

    def cell(self, label: str, tensor: str) -> PointTensorResult:
        for r in self.results:
            if r.label == label and r.tensor == tensor:
                return r
        raise KeyError((label, tensor))

    def labels(self) -> list[str]:
        out: list[str] = []
        for r in self.results:
            if r.label not in out:
                out.append(r.label)
        return out

    def aggregate(self) -> dict[str, tuple[float, float | None]]:
        """Per-configuration (total seconds, total joules) across tensors.

        Energy is ``None`` if any cell has no energy model (TPU points).
        """
        agg: dict[str, tuple[float, float | None]] = {}
        for r in self.results:
            t, e = agg.get(r.label, (0.0, 0.0))
            e = None if (e is None or r.energy_j is None) else e + r.energy_j
            agg[r.label] = (t + r.seconds, e)
        return agg

    def rows(self, *, baseline: str | None = None) -> list[dict]:
        """Flat dict rows for ``repro_torch.perf.report.sweep_table_md``."""
        base: dict[str, PointTensorResult] = {}
        if baseline is not None:
            base = {r.tensor: r for r in self.results if r.label == baseline}
        rows = []
        for r in self.results:
            row: dict = {
                "config": r.label,
                "tensor": r.tensor,
                "time_s": r.seconds,
                "energy_j": r.energy_j,
                "bottlenecks": "/".join(r.bottlenecks),
            }
            b = base.get(r.tensor)
            if b is not None:
                row["speedup_vs_" + baseline] = b.seconds / r.seconds
                if b.energy_j is not None and r.energy_j is not None:
                    row["energy_savings_vs_" + baseline] = b.energy_j / r.energy_j
            rows.append(row)
        return rows


def _level_hits_for_point(
    hier,
    tensor: FrosttTensor,
    mode: int,
    rank: int,
    cache: HitRateCache,
    *,
    method: str,
    trace: SparseTensor | None,
    trace_nnz_limit: int,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> tuple[tuple[float, ...], ...]:
    """Per caching level, the memoized per-input hit rates."""
    out = []
    for lvl, geom in zip(hier.caching_levels(), hier.hit_geometries()):
        if lvl.hit_model == "scratchpad":
            out.append(scratchpad_hit_rates(tensor))
        else:
            out.append(
                cache.get(
                    tensor,
                    mode,
                    geom,
                    rank,
                    method=method,
                    trace=trace,
                    trace_nnz_limit=trace_nnz_limit,
                    ordering=ordering,
                    device=device,
                )
            )
    return tuple(out)


def evaluate_sweep(
    points: Sequence[SweepPoint],
    tensors: Mapping[str, FrosttTensor] | None = None,
    *,
    hit_rate_method: str = "che",
    trace_tensors: Mapping[str, SparseTensor] | None = None,
    trace_nnz_limit: int = TRACE_NNZ_LIMIT,
    cache: HitRateCache | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SweepResult:
    """Price every (point, tensor, mode) cell of a sweep.

    Points are resolved to hierarchies up front, grouped by structural
    signature (``MemoryHierarchy.batch_signature()``: timing family,
    energy model, per-level sub-model presence), and each group's
    post-hit-rate arithmetic runs as one batched NumPy evaluation across
    all its points (``repro_torch.core.hierarchy.hierarchy_mode_times_batch``).
    The hit-rate memo is shared across all points, so techs/frequencies/
    wavelength counts that share a cache geometry reuse the same solve.
    ``device`` is where the traces of orderings other than ``"lex"`` are
    sorted; lex traces and the pricing stay on the host.
    """
    tensors = tensors or FROSTT_TENSORS
    trace_tensors = trace_tensors or {}
    # NB: an empty HitRateCache is falsy (__len__), so test identity.
    cache = cache if cache is not None else HitRateCache()
    points = list(points)
    # Che's IRM is order-blind: an ordering-axis sweep under the pure che
    # method would report byte-identical cells per strategy — a table that
    # reads as "reordering makes no difference".  Refuse it outright
    # (auto keeps the documented per-tensor normalization: big tensors
    # fall back to che and honestly show no delta there, DESIGN.md §10).
    if hit_rate_method == "che" and len({p.ordering for p in points}) > 1:
        raise ValueError(
            "the ordering axis is invisible to the che hit-rate model; "
            "sweep it with hit_rate_method='trace' or 'auto' (DESIGN.md §10)"
        )
    hiers = [p.hierarchy() for p in points]

    # Controller points (DESIGN.md §14) are priced by the cycle-level
    # event loop, not the closed-form batch engine: they replay the exact
    # per-nonzero request stream, so they need an executable tensor for
    # every workload (there is no Che fallback — banking and prefetch are
    # meaningless against a steady-state hit probability).
    ctrl_idx = [i for i, p in enumerate(points) if p.controller is not None]
    if ctrl_idx:
        missing = [n for n in tensors if n not in trace_tensors]
        if missing:
            raise ValueError(
                f"controller-axis sweep points need executable trace "
                f"tensors for every workload; missing: {missing} "
                f"(pass trace_tensors=..., DESIGN.md §14)"
            )

    groups: dict[tuple, list[int]] = {}
    for i, h in enumerate(hiers):
        if i in set(ctrl_idx):
            continue
        groups.setdefault(h.batch_signature(), []).append(i)

    cells: dict[tuple[int, str], PointTensorResult] = {}
    for name, tensor in tensors.items():
        for idxs in groups.values():
            ghiers = [hiers[i] for i in idxs]
            granks = [points[i].rank for i in idxs]
            mode_times: list[list] = [[] for _ in idxs]
            for m in range(tensor.nmodes):
                all_hits = [
                    _level_hits_for_point(
                        ghiers[j],
                        tensor,
                        m,
                        granks[j],
                        cache,
                        method=hit_rate_method,
                        trace=trace_tensors.get(name),
                        trace_nnz_limit=trace_nnz_limit,
                        ordering=points[idxs[j]].ordering,
                        device=device,
                    )
                    for j in range(len(idxs))
                ]
                mts = hierarchy_mode_times_batch(ghiers, tensor, m, granks, all_hits)
                for j, mt in enumerate(mts):
                    mode_times[j].append(mt)
            energies = hierarchy_energy_batch(ghiers, tensor, mode_times)
            for j, i in enumerate(idxs):
                energy, breakdown = energies[j]
                cells[(i, name)] = PointTensorResult(
                    label=points[i].label,
                    tensor=name,
                    mode_times=tuple(mode_times[j]),
                    energy_j=energy,
                    energy_breakdown=breakdown,
                )
    for i in ctrl_idx:
        from repro_torch.model.controller import simulate_controller

        p = points[i]
        for name, tensor in tensors.items():
            run = simulate_controller(
                trace_tensors[name],
                hiers[i],
                config=p.controller,
                rank=p.rank,
                chars=tensor,
                ordering=p.ordering,
                device=device,
            )
            cells[(i, name)] = PointTensorResult(
                label=p.label,
                tensor=name,
                mode_times=tuple(r.as_mode_time() for r in run.mode_results),
                energy_j=run.energy_j,
                energy_breakdown=run.energy_breakdown,
            )
    results = [cells[(i, name)] for i in range(len(points)) for name in tensors]
    return SweepResult(results=results, cache=cache)
