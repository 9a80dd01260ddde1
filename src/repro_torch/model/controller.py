"""Event-driven, cycle-level memory-controller simulator (DESIGN.md §14).

Copy of ``repro.model.controller`` for the PyTorch port: numpy, held equal
to the original by ``tests/test_torch_controller.py``.  The one addition
is ``device=`` on every function that linearizes a stream: an ordering
other than ``"lex"`` is sorted there (``repro_torch.reorder``, default
``"cuda"``); ``"lex"`` stays a host sort and never touches a device.

The paper's Eq-1 model prices the cache subsystem with a closed-form
request-occupancy rate: ``n_units`` interchangeable service units, an
average occupancy from steady-state hit rates, perfect load balance, and
infinite buffering.  The PMC companion paper (arXiv 2207.08298) shows the
knobs that actually decide spMTTKRP memory performance — banking, the
bank-conflict policy, prefetch, reorder-buffer depth — are invisible to
any closed form.  This module makes them visible: it replays the exact
per-nonzero access traces the execution plans already expose (the same
streams ``repro_torch.dse.evaluator.exact_hit_rates_for_geometry`` and the
experiment engine's ``ExecutedTraceHitRates`` consume) through banked
request queues with finite in-flight capacity, and emits per-mode cycles
and energy through the same ``ModeTime`` / ``hierarchy_energy`` plumbing
as the analytic engine.

Event loop.  The interleaved request stream (nonzero-major: for each
nonzero, one factor-row request per input mode, ascending) is admitted in
windows of ``reorder_buffer_depth x n_banks`` requests — the in-flight
set a controller with per-bank queues of that depth can hold.  A window
must drain before the next is admitted; its drain time is the maximum of
the resources it occupies (issue slots, bank service, DRAM transfer,
compute), all evaluated with vectorized NumPy over per-request arrays.
Total mode cycles are the sum of window times, so the model is exactly
the analytic max-of-bounds when one window covers the stream and the
workload is stationary, and strictly slower (sum-of-maxes >= max-of-sums)
when the stream has phases — cold-start misses, hot-row bursts — that a
closed form averages away.

Bank-conflict policies (``bank_conflict_policy``):

  * ``"fifo"``  — in-order, work-conserving: all banks pull from one
    shared queue and any bank can serve any request.  Bank time is
    ``sum(occupancy) / (n_banks * concurrency)`` — Eq-1's uniform-service
    assumption, which is what makes this policy the calibration point
    against the analytic hierarchy (single-bank fifo with one window
    reproduces a 1-unit analytic stack's cycles exactly;
    tests/test_controller.py).
  * ``"stall"`` — banked by address with in-order issue: requests issue
    in groups of ``n_banks`` and the next group waits for the group's
    slowest bank (head-of-line blocking on conflicts).
  * ``"queue"`` — banked by address with per-bank queues that drain
    independently; window bank time is the hottest bank's occupancy sum.
    Duplicate same-line requests in flight coalesce (the reorder buffer
    merges them): a hit whose line already appeared earlier in the window
    costs no bank occupancy.

Requests map to banks by address interleave at row granularity:
``bank = (row + input_ordinal) % n_banks`` (each factor matrix starts at
its own base offset, so row 0 of different inputs lands on different
banks).  Hit/miss per access comes from the exact per-input LRU
simulation on the input's capacity share
(``repro_torch.core.cache_sim.simulate_trace_flags``), optionally with
next-line prefetch: a miss on row ``r`` fills ``r+1 .. r+prefetch_depth``
(DRAM-side fills — they cost ``line_bytes`` of DRAM traffic each and
convert future misses into hits, but do not occupy request ports).

The model covers the paper's 2-level fpga-family stacks (one caching
level with a port model over a backing store); deeper stacks and
roofline-family hierarchies are out of scope and rejected loudly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import PAPER_ACCEL, AcceleratorConfig
from repro_torch.core.cache_sim import simulate_trace_flags
from repro_torch.core.hierarchy import (
    PSUM_ACCESSES_PER_NNZ,
    MemoryHierarchy,
    MemoryLevel,
    ModeTime,
    hierarchy_energy,
)
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.data.frostt import FrosttTensor
from repro_torch.device import DEFAULT_DEVICE

__all__ = [
    "POLICIES",
    "BankConflictCounts",
    "ControllerConfig",
    "ControllerModeResult",
    "ControllerRunResult",
    "bank_conflict_counts",
    "calibration_controller",
    "paper_controller",
    "request_stream_lengths",
    "request_streams",
    "simulate_controller",
    "simulate_controller_mode",
]

#: Known bank-conflict policies, weakest to strongest service discipline.
#: Structural ordering: fifo <= queue <= stall cycles on any trace
#: (work-conserving shared queue / hottest-bank drain / head-of-line
#: blocking), which tests pin as a property.
POLICIES = ("fifo", "stall", "queue")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Parameters of the programmable memory controller (PMC, arXiv
    2207.08298): the knobs the closed-form Eq-1 model cannot see."""

    n_banks: int = 12
    bank_conflict_policy: str = "fifo"
    prefetch_depth: int = 0
    reorder_buffer_depth: int = 32
    line_bytes: int = 64

    def __post_init__(self):
        if self.n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {self.n_banks}")
        if self.bank_conflict_policy not in POLICIES:
            raise ValueError(
                f"unknown bank_conflict_policy {self.bank_conflict_policy!r}; "
                f"known: {list(POLICIES)}"
            )
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}"
            )
        if self.reorder_buffer_depth < 1:
            raise ValueError(
                f"reorder_buffer_depth must be >= 1, got "
                f"{self.reorder_buffer_depth}"
            )
        if self.line_bytes < 4:
            raise ValueError(f"line_bytes must be >= 4, got {self.line_bytes}")

    @property
    def label(self) -> str:
        return (
            f"(banks={self.n_banks},{self.bank_conflict_policy},"
            f"pf={self.prefetch_depth},rob={self.reorder_buffer_depth})"
        )

    @property
    def window_requests(self) -> int:
        """In-flight capacity: one window of the event loop."""
        return self.reorder_buffer_depth * self.n_banks


def paper_controller(accel: AcceleratorConfig = PAPER_ACCEL) -> ControllerConfig:
    """The Table-I accelerator's controller: one bank per cache unit
    (``n_pe x n_caches``), fifo service, no prefetch."""
    return ControllerConfig(n_banks=accel.n_pe * accel.n_caches)


def calibration_controller(
    accel: AcceleratorConfig = PAPER_ACCEL,
) -> ControllerConfig:
    """The Eq-1-consistent configuration the reconciliation gate runs:
    work-conserving fifo over ``n_units`` banks, no prefetch.  Deviation
    from the analytic hierarchy under this config isolates what the event
    loop adds — finite windows over a phased stream — from what the
    banked policies add (conflicts, imbalance, coalescing)."""
    return ControllerConfig(
        n_banks=accel.n_pe * accel.n_caches,
        bank_conflict_policy="fifo",
        prefetch_depth=0,
    )


@dataclasses.dataclass(frozen=True)
class ControllerModeResult:
    """Cycle-level outcome of one MTTKRP mode under one configuration."""

    mode: int
    config: ControllerConfig
    cycles: float
    seconds: float
    # Per-resource total cycles (each resource alone, summed over
    # windows); `cycles` is the sum of per-window maxima, so it is >= each.
    compute_cycles: float
    issue_cycles: float
    bank_cycles: float
    dram_cycles: float
    n_requests: int
    n_hits: int
    n_coalesced: int
    n_prefetch_fills: int
    n_conflicts: int
    n_windows: int
    hit_rates: tuple[float, ...]
    dram_bytes: float
    onchip_bytes_touched: float
    bank_imbalance: float  # max/mean bank occupancy over the whole mode

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_cycles,
            "issue": self.issue_cycles,
            "bank": self.bank_cycles,
            "dram": self.dram_cycles,
        }
        return max(terms, key=terms.get)

    def as_mode_time(self) -> ModeTime:
        """The analytic engine's currency: rates in nonzeros per cycle,
        so ``hierarchy_energy`` and the DSE comparison layer consume
        cycle-model results exactly like closed-form ones."""
        nnz = max(1, self.n_requests // max(1, len(self.hit_rates)))
        onchip = max(self.issue_cycles, self.bank_cycles)
        return ModeTime(
            mode=self.mode,
            rate_compute=nnz / self.compute_cycles if self.compute_cycles else float("inf"),
            rate_cache=nnz / onchip if onchip else float("inf"),
            rate_dram=nnz / self.dram_cycles if self.dram_cycles else float("inf"),
            hit_rates=self.hit_rates,
            dram_bytes=self.dram_bytes,
            onchip_bytes_touched=self.onchip_bytes_touched,
            seconds=self.seconds,
        )


@dataclasses.dataclass(frozen=True)
class ControllerRunResult:
    """All modes of one tensor under one (hierarchy, controller) pair."""

    tensor: str
    hierarchy: str
    config: ControllerConfig
    mode_results: tuple[ControllerModeResult, ...]
    energy_j: float | None
    energy_breakdown: dict | None

    @property
    def seconds(self) -> float:
        return sum(r.seconds for r in self.mode_results)

    @property
    def cycles(self) -> float:
        return sum(r.cycles for r in self.mode_results)


def request_streams(
    tensor: SparseTensor,
    mode: int,
    *,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> list[tuple[int, np.ndarray]]:
    """Per input mode, the executed factor-row request stream of one
    MTTKRP mode: ``ordering``-linearized exactly like the trace hit-rate
    method (``exact_hit_rates_for_geometry``), so the controller and the
    analytic reconciliation consume byte-identical traces."""
    if ordering == "lex":
        ordered = tensor.mode_sorted(mode)
    else:
        from repro_torch.reorder import trace_view

        ordered = trace_view(tensor, mode, ordering, device=device)
    return [
        (k, np.asarray(ordered.indices[:, k], dtype=np.int64))
        for k in range(tensor.nmodes)
        if k != mode
    ]


def request_stream_lengths(
    tensor: SparseTensor,
    mode: int,
    *,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict[int, int]:
    """Input mode -> executed request-stream length for one MTTKRP mode.

    Every ordering is a permutation of the nonzeros, so each input's
    stream carries exactly one factor-row request per nonzero — the
    ``factor_rows_per_nnz`` coefficient of
    ``repro_torch.core.hierarchy.analytic_traffic_census``.  Stated as its own
    function (rather than an invariant buried in the simulator) so the
    static ``traffic-model-drift`` gate can replay it against the
    symbolic census extracted from the kernel ASTs.
    """
    return {
        k: int(stream.shape[0])
        for k, stream in request_streams(tensor, mode, ordering=ordering, device=device)
    }


def _controller_level(hier: MemoryHierarchy) -> MemoryLevel:
    """The one caching level the controller models, validated loudly."""
    if hier.family != "fpga":
        raise ValueError(
            f"the controller model covers fpga-family stacks; "
            f"{hier.name!r} is {hier.family!r}"
        )
    caching = hier.caching_levels()
    if len(caching) != 1:
        raise ValueError(
            f"the controller model covers 2-level stacks (one caching "
            f"level over a backing store); {hier.name!r} has {len(caching)}"
        )
    lvl = caching[0]
    if lvl.port_model is None:
        raise ValueError(
            f"level {lvl.name!r} has no port model: nothing to bank"
        )
    return lvl


def _interleave(per_k: Sequence[np.ndarray]) -> np.ndarray:
    """Nonzero-major request interleave: [nnz, n_inputs] -> flat stream."""
    return np.stack(per_k, axis=1).reshape(-1)


def _coalesced_mask(
    win: np.ndarray, line_keys: np.ndarray, hits: np.ndarray
) -> np.ndarray:
    """Requests whose (window, line) already appeared earlier in the same
    window AND that hit in the cache: the reorder buffer merges them.
    (Misses never coalesce, so DRAM traffic is never undercounted.)"""
    order = np.lexsort((line_keys, win))
    w_s, l_s = win[order], line_keys[order]
    dup_sorted = np.zeros(win.size, dtype=bool)
    if win.size > 1:
        dup_sorted[1:] = (w_s[1:] == w_s[:-1]) & (l_s[1:] == l_s[:-1])
    dup = np.zeros(win.size, dtype=bool)
    dup[order] = dup_sorted
    return dup & hits


def simulate_controller_mode(
    tensor: SparseTensor,
    mode: int,
    hier: MemoryHierarchy,
    *,
    config: ControllerConfig,
    rank: int,
    chars: FrosttTensor | None = None,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> ControllerModeResult:
    """Replay one mode's request stream through the banked controller.

    ``chars`` optionally carries the characteristics record the analytic
    side prices (output-factor traffic needs ``dims[mode]``); by default
    the executable tensor describes itself.
    """
    from repro_torch.dse.evaluator import geometry_sim_config

    lvl = _controller_level(hier)
    pm = lvl.port_model
    f = hier.compute.f_clock
    n = tensor.nmodes
    nnz = tensor.nnz
    n_inputs = max(1, n - 1)
    dims = chars.dims if chars is not None else tensor.shape
    # The output-factor DRAM term is the §IV-A per-nonzero ratio
    # dims[mode]/nnz of the characteristics record (matches
    # `_traffic_terms`), so scaled executable traces priced against
    # full-size characteristics stay consistent with the analytic side.
    out_ratio = dims[mode] / (chars.nnz if chars is not None else nnz)

    geometry = hier.hit_geometries()[0]
    cfg_sim, row_bytes = geometry_sim_config(geometry, rank, n_inputs=n_inputs)
    if rank * hier.value_bytes > config.line_bytes:
        raise ValueError(
            f"controller line_bytes={config.line_bytes} cannot hold a "
            f"rank-{rank} factor row ({rank * hier.value_bytes} B): requests "
            f"are row-granular (DESIGN.md §14)"
        )

    streams = request_streams(tensor, mode, ordering=ordering, device=device)
    per_k_rows = [rows for _, rows in streams]
    per_k_flags = [
        simulate_trace_flags(
            rows,
            cfg_sim,
            row_bytes=row_bytes,
            prefetch_depth=config.prefetch_depth,
            catalog_rows=int(dims[k]),
        )
        for (k, _), rows in zip(streams, per_k_rows)
    ]
    hit_rates = tuple(
        float(fl.hits.sum() / fl.hits.size) if fl.hits.size else 0.0
        for fl in per_k_flags
    )

    rows_i = _interleave(per_k_rows)
    hits_i = _interleave([fl.hits for fl in per_k_flags])
    pf_i = _interleave([fl.prefetch_fills for fl in per_k_flags]).astype(np.float64)
    ordinal = np.arange(len(streams), dtype=np.int64)
    banks_i = (rows_i + np.tile(ordinal, nnz)) % config.n_banks
    # Distinct line namespace per input factor (separate matrices).
    lines_i = rows_i + np.tile(ordinal << 40, nnz)
    nreq = rows_i.size

    occ = np.where(hits_i, pm.base_occupancy, pm.base_occupancy + pm.miss_occupancy)

    W = config.window_requests
    n_windows = max(1, -(-nreq // W))
    win_i = np.arange(nreq) // W

    coalesced = np.zeros(nreq, dtype=bool)
    if config.bank_conflict_policy == "queue":
        coalesced = _coalesced_mask(win_i, lines_i, hits_i)
    occ_served = np.where(coalesced, 0.0, occ)

    # --- per-window resource terms (cycles) -------------------------------
    req_w = np.bincount(win_i, minlength=n_windows).astype(np.float64)
    issue_w = req_w / pm.issue_limit
    nnz_w = req_w / n_inputs  # fractional at window edges, by construction
    compute_w = nnz_w * n * rank / hier.compute.lanes

    if config.bank_conflict_policy == "fifo":
        bank_w = (
            np.bincount(win_i, weights=occ_served, minlength=n_windows)
            / (config.n_banks * pm.concurrency)
        )
    elif config.bank_conflict_policy == "queue":
        flat = win_i * config.n_banks + banks_i
        sums = np.bincount(
            flat, weights=occ_served, minlength=n_windows * config.n_banks
        ).reshape(n_windows, config.n_banks)
        bank_w = sums.max(axis=1) / pm.concurrency
    else:  # stall: issue groups of n_banks, each waits for its slowest bank
        grp = np.arange(nreq) // config.n_banks
        flat = grp * config.n_banks + banks_i
        n_groups = int(grp[-1]) + 1
        gsums = np.bincount(
            flat, weights=occ_served, minlength=n_groups * config.n_banks
        ).reshape(n_groups, config.n_banks)
        gmax = gsums.max(axis=1)
        gwin = (np.arange(n_groups) * config.n_banks) // W
        bank_w = np.bincount(gwin, weights=gmax, minlength=n_windows) / pm.concurrency

    # DRAM: the §IV-A traffic terms at event granularity — the nonzero
    # stream and the amortized output factor scale with the window's
    # nonzeros; fills (demand misses + prefetches) are counted, not
    # modeled as a steady-state residual rate.
    stream_bytes = hier.value_bytes + n * hier.index_bytes
    out_per_nnz = out_ratio * rank * hier.value_bytes
    fills_w = np.bincount(
        win_i, weights=(~hits_i).astype(np.float64) + pf_i, minlength=n_windows
    )
    dram_bytes_w = nnz_w * (stream_bytes + out_per_nnz) + fills_w * config.line_bytes
    dram_w = dram_bytes_w * f / hier.backing.bandwidth_bytes_per_s

    t_w = np.maximum(np.maximum(compute_w, issue_w), np.maximum(bank_w, dram_w))
    cycles = float(t_w.sum())

    # --- structural conflict count (policy-independent diagnostic) --------
    n_conflicts = _conflict_count(banks_i, lines_i, config.n_banks)

    bank_tot = np.bincount(banks_i, weights=occ_served, minlength=config.n_banks)
    imbalance = (
        float(bank_tot.max() / bank_tot.mean()) if bank_tot.mean() > 0 else 1.0
    )

    # --- Eq-3 switched bits from the actual per-access outcomes -----------
    onchip_bytes = _switched_bytes(hier, lvl, rank, nnz, stream_bytes, hits_i)

    return ControllerModeResult(
        mode=mode,
        config=config,
        cycles=cycles,
        seconds=cycles / f,
        compute_cycles=float(compute_w.sum()),
        issue_cycles=float(issue_w.sum()),
        bank_cycles=float(bank_w.sum()),
        dram_cycles=float(dram_w.sum()),
        n_requests=nreq,
        n_hits=int(hits_i.sum()),
        n_coalesced=int(coalesced.sum()),
        n_prefetch_fills=int(pf_i.sum()),
        n_conflicts=n_conflicts,
        n_windows=n_windows,
        hit_rates=hit_rates,
        dram_bytes=float(dram_bytes_w.sum()),
        onchip_bytes_touched=onchip_bytes,
        bank_imbalance=imbalance,
    )


def _conflict_count(banks: np.ndarray, lines: np.ndarray, n_banks: int) -> int:
    """Structural bank conflicts: within each issue group of ``n_banks``
    consecutive requests, every DISTINCT extra line targeting an
    already-claimed bank is one conflict (same-line requests coalesce in
    any reasonable controller, so they never conflict).  Equals
    ``sum over (group, bank) of (distinct_lines - 1)``, computed with one
    vectorized unique over (group, bank, line) triples."""
    nreq = banks.size
    if nreq == 0 or n_banks < 2:
        return 0
    grp = np.arange(nreq) // n_banks
    triples = np.stack([grp, banks, lines], axis=1)
    uniq = np.unique(triples, axis=0)
    pairs = np.unique(uniq[:, :2], axis=0)
    return int(uniq.shape[0] - pairs.shape[0])


def _switched_bytes(
    hier: MemoryHierarchy,
    lvl: MemoryLevel,
    rank: int,
    nnz: int,
    stream_bytes: int,
    hits: np.ndarray,
) -> float:
    """Eq-3 switched bits over the mode, from per-access hit outcomes —
    the same accounting as ``_fpga_mode_times_batch`` with the steady-state
    ``(1-h)`` replaced by the actual miss count."""
    sm = lvl.switching_model
    n_hits = float(hits.sum())
    n_miss = float(hits.size - n_hits)
    switched_bits = 0.0
    if sm is not None:
        gran = hier.fill_granularity(lvl, rank)
        line_bits = gran * 8
        if sm.phased:
            switched_bits = (sm.tag_bits + line_bits) * hits.size + line_bits * n_miss
        else:
            switched_bits = (
                sm.associativity * (line_bits + sm.tag_bits) + sm.lru_bits
            ) * hits.size + 2 * line_bits * n_miss
    psum_bits = PSUM_ACCESSES_PER_NNZ * rank * 32 * nnz
    stream_bits = stream_bytes * 8 * nnz
    return float((switched_bits + psum_bits + stream_bits) / 8.0)


def simulate_controller(
    tensor: SparseTensor,
    hier: MemoryHierarchy,
    *,
    config: ControllerConfig,
    rank: int,
    chars: FrosttTensor | None = None,
    ordering: str = "lex",
    name: str | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ControllerRunResult:
    """All modes of one tensor under one (hierarchy, controller) pair,
    with Eq-2 energy priced through ``hierarchy_energy`` on the cycle
    model's own seconds/traffic — the controller-side analogue of one
    ``evaluate_sweep`` cell."""
    results = tuple(
        simulate_controller_mode(
            tensor,
            m,
            hier,
            config=config,
            rank=rank,
            chars=chars,
            ordering=ordering,
            device=device,
        )
        for m in range(tensor.nmodes)
    )
    record = chars if chars is not None else _adhoc_chars(tensor, name or "adhoc")
    energy_j, breakdown = hierarchy_energy(
        hier, record, [r.as_mode_time() for r in results]
    )
    return ControllerRunResult(
        tensor=record.name,
        hierarchy=hier.name,
        config=config,
        mode_results=results,
        energy_j=energy_j,
        energy_breakdown=breakdown,
    )


def _adhoc_chars(tensor: SparseTensor, name: str) -> FrosttTensor:
    import math

    volume = math.prod(int(d) for d in tensor.shape)
    return FrosttTensor(
        name=name,
        dims=tuple(int(d) for d in tensor.shape),
        nnz=int(tensor.nnz),
        density=float(tensor.nnz / max(1, volume)),
        zipf_alpha=0.0,
    )


@dataclasses.dataclass(frozen=True)
class BankConflictCounts:
    """Structural conflict diagnostic of one (tensor, mode, ordering)."""

    ordering: str
    n_requests: int
    n_conflicts: int

    @property
    def conflict_rate(self) -> float:
        return self.n_conflicts / self.n_requests if self.n_requests else 0.0


def bank_conflict_counts(
    tensor: SparseTensor,
    mode: int,
    *,
    config: ControllerConfig,
    ordering: str = "lex",
    device: str | torch.device = DEFAULT_DEVICE,
) -> BankConflictCounts:
    """Count structural bank conflicts of one mode's request stream under
    ``ordering`` — the quantity nonzero reordering (repro_torch.reorder,
    DESIGN.md §10) can reduce: orderings that keep consecutive nonzeros on
    the same factor rows turn would-be conflicts into same-line merges."""
    streams = request_streams(tensor, mode, ordering=ordering, device=device)
    per_k_rows = [rows for _, rows in streams]
    rows_i = _interleave(per_k_rows)
    ordinal = np.arange(len(streams), dtype=np.int64)
    banks_i = (rows_i + np.tile(ordinal, tensor.nnz)) % config.n_banks
    lines_i = rows_i + np.tile(ordinal << 40, tensor.nnz)
    return BankConflictCounts(
        ordering=ordering,
        n_requests=int(rows_i.size),
        n_conflicts=_conflict_count(banks_i, lines_i, config.n_banks),
    )
