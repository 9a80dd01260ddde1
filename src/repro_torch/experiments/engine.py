"""End-to-end experiment engine: measured CP-ALS reconciled with the model.

The port of ``repro.experiments.engine``.  The analytic side prices
full-size FROSTT tensors it can never run, while the executable side runs
scaled tensors it never prices; this engine does both on the SAME workload
and reconciles them (DESIGN.md §7):

  1. materialize every requested FROSTT spec at a configurable scale
     (``repro_torch.data.synthetic_tensors``);
  2. execute full CP-ALS sweeps through each impl (``ref`` and
     ``kernel`` in this process, on ``device``; on the card every
     ``kernel`` call is one launch of the split MTTKRP kernel; ``sharded``
     in a worker process, ``repro_torch.experiments.worker``, that starts
     ``n_shards`` ranks, each shard through the split kernel), collecting
     per-mode times, the closed-form cost and exact LRU hit rates over the
     impl's executed nonzero order (``repro_torch.experiments.measure``);
  3. price the same runs on all four memory stacks — E-SRAM, O-SRAM,
     TPU-v5e, photonic IMC — twice through the DSE evaluator: once with
     the measured executed-order hit rates (``ExecutedTraceHitRates``)
     and once with the Che model, yielding speedup/energy tables plus
     per-mode measured-vs-modeled share residuals and a trace-vs-Che
     hit-rate reconciliation at the documented 0.10 tolerance.

The trace simulation and the pricing are numpy on the host; each run
records their host seconds (``RunResult.host_s``).  With
``ExperimentSpec(autotune=True)`` each tensor's plan geometry is tuned
first (``repro_torch.dse.autotune``, on ``device``) and its ``kernel``
cells are measured and traced at the winner's ``(tile_nnz,
rows_per_block)``.  ``python -m repro_torch.experiments`` drives this.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

from repro_torch.core.hierarchy import PHOTONIC_IMC, split_capacity_hit_rates
from repro_torch.core.memory_tech import E_SRAM, O_SRAM, TPU_V5E
from repro_torch.core.mttkrp import check_impl
from repro_torch.data.frostt import PAPER_RANK, FrosttTensor
from repro_torch.data.synthetic_tensors import (
    EXPERIMENT_SCALES,
    make_frostt_like,
    scaled_characteristics,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.mttkrp_dist import SCHEMES, residual_shares
from repro_torch.dse import Autotuner, evaluate_sweep, tech_comparison
from repro_torch.experiments.measure import (
    ExecutedTraceHitRates,
    MeasuredRun,
    measure_cp_als,
)
from repro_torch.reorder import prepare_execution

__all__ = [
    "ALL_TECHS",
    "CHE_VS_TRACE_TOL",
    "ExperimentSpec",
    "TechReconciliation",
    "HitRateReconciliation",
    "RunResult",
    "ExperimentResult",
    "run_experiments",
]

# The four memory stacks of DESIGN.md §9, priced through the one engine.
ALL_TECHS = (E_SRAM, O_SRAM, TPU_V5E, PHOTONIC_IMC)

# The documented Che-vs-exact-LRU tolerance (DESIGN.md §7), the JAX
# package's value.
CHE_VS_TRACE_TOL = 0.10


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment-engine invocation (tensors × impls × technologies)."""

    tensors: tuple[tuple[str, float], ...] = tuple(EXPERIMENT_SCALES.items())
    # "ref" (mttkrp_ref), "kernel" (the split CUDA kernel on the card, the
    # counterpart of JAX's "pallas") and "sharded" (n_shards ranks in a
    # worker process, each shard through the split kernel).
    impls: tuple[str, ...] = ("ref", "kernel", "sharded")
    rank: int = PAPER_RANK
    n_iters: int = 3
    seed: int = 0
    n_shards: int = 8
    scheme: str = "mode_ordered"  # sharded partitioning scheme
    # Nonzero execution-order strategies to measure + price per run
    # (repro_torch.reorder, DESIGN.md §10).  ``None`` is the impl-native
    # order (raw COO for ref, lex plan for kernel).  The degree strategy
    # relabels the executed tensor engine-side (factors are re-initialized
    # to the relabeled shapes; the fit metric is label-invariant).
    orderings: tuple[str | None, ...] = (None,)
    # Record the closed-form flops and bytes of each mode
    # (measure.mode_cost_analysis).
    cost_analysis: bool = True
    # Also time the fused executor (repro_torch.core.cp_als_fused,
    # DESIGN.md §11) on every (tensor, impl, ordering) cell, attaching the
    # ``fused_*`` wall-time fields to each MeasuredRun and the
    # fused-vs-eager table to the artifact.
    fused: bool = True
    fit_every: int = 1
    # Where the runs execute; "cuda" raises without a GPU.
    device: str = DEFAULT_DEVICE
    # Tune (tile_nnz, rows_per_block) per tensor through the closed-loop
    # DSE autotuner, on ``device``, before measuring the kernel cells
    # (DESIGN.md §13).
    autotune: bool = False

    def __post_init__(self):
        for impl in self.impls:
            check_impl(impl)
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; expected one of {SCHEMES}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if "sharded" in self.impls and self.scheme == "allreduce" and None in self.orderings:
            # The trace of that pair is each shard's block in raw COO order,
            # but a plan runs its nonzeros grouped by output block, so the
            # block runs lex-sorted: the engine would price hit rates that
            # no run produced.
            raise ValueError(
                "impl 'sharded' with scheme='allreduce' needs an explicit ordering: the "
                "native (None) order's trace is the raw COO block, which the split "
                "kernel's plan cannot run in that order; pass orderings=('lex',) or "
                "another strategy"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TechReconciliation:
    """Measured vs modeled, one (tensor, impl, technology) cell.

    ``priced_mode_s`` injects the measured executed-order hit rates into
    the technology's hierarchy; ``modeled_mode_s`` uses the Che model.
    Residuals compare per-mode SHARES (fraction of the sweep spent in a
    mode): the measured calls and an FPGA model live on different absolute
    scales, but the model's claim about WHERE the time goes is testable
    against the measured run.
    """

    tech: str
    measured_mode_s: tuple[float, ...]
    priced_mode_s: tuple[float, ...]
    modeled_mode_s: tuple[float, ...]
    priced_energy_j: float | None
    modeled_energy_j: float | None
    share_residuals: tuple[float, ...]  # measured share − priced share
    max_share_residual: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class HitRateReconciliation:
    """Exact executed-trace vs Che, one (geometry, mode) scenario.

    The measured side is the RAW exact-LRU hit rate over the executed
    nonzero order; the modeled side is the Che approximation solved in
    its finite-trace form at the per-cache-unit trace length
    (``che_hit_rate(trace_length=...)``) — a measured run is a transient,
    and comparing it against steady-state Che would conflate the model
    error with the cold start.  ``within_tol`` applies the documented
    0.10 tolerance to |trace − che_transient| per input factor; the
    steady-state Che values (what the full-size analytic tables use) and
    the warm rates are kept for reference.
    """

    capacity_bytes: int
    line_bytes: int | None
    associativity: int | None
    mode: int
    trace_length: float  # accesses per cache unit
    trace: tuple[float, ...]
    trace_warm: tuple[float, ...]
    che_transient: tuple[float, ...]
    che_steady: tuple[float, ...]
    max_abs_err: float
    within_tol: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RunResult:
    """Everything measured + reconciled for one (tensor, impl)."""

    frostt: str
    scale: float
    tensor: str  # scaled-characteristics name, e.g. "NELL-2@0.0002"
    dims: tuple[int, ...]
    nnz: int
    impl: str
    measured: MeasuredRun
    techs: tuple[TechReconciliation, ...]
    hit_rates: tuple[HitRateReconciliation, ...]
    # Execution-order strategy of this run (repro_torch.reorder, DESIGN.md §10);
    # None = the impl-native order (the historical behavior).
    ordering: str | None = None
    # Host seconds by step: "measure" (the CP-ALS runs, device waits
    # included), "capture" (linearizing the executed traces), "simulate"
    # (their exact LRU simulation), "price" (the rest of the trace-priced
    # sweep) and "reconcile" (the Che comparison).
    host_s: dict = dataclasses.field(default_factory=dict)
    # ``sharded`` under ``mode_ordered``: per mode, per shard, the share of
    # the shard's priced trace that its plan does not run (its leftovers,
    # which the residual pass runs on every rank); None otherwise.
    residual_share: tuple[tuple[float, ...], ...] | None = None

    @property
    def key(self) -> str:
        base = f"{self.tensor}/{self.impl}"
        return base if self.ordering is None else f"{base}/{self.ordering}"

    @property
    def all_within_tol(self) -> bool:
        return all(h.within_tol for h in self.hit_rates)

    def tech(self, name: str) -> TechReconciliation:
        for t in self.techs:
            if t.tech == name:
                return t
        raise KeyError(name)

    def to_dict(self) -> dict:
        return {
            "frostt": self.frostt,
            "scale": self.scale,
            "tensor": self.tensor,
            "dims": list(self.dims),
            "nnz": self.nnz,
            "impl": self.impl,
            "ordering": self.ordering,
            "measured": self.measured.to_dict(),
            "technologies": [t.to_dict() for t in self.techs],
            "hit_rates": [h.to_dict() for h in self.hit_rates],
            "all_within_tol": self.all_within_tol,
            "host_s": dict(self.host_s),
            **({} if self.residual_share is None
               else {"residual_share": [list(s) for s in self.residual_share]}),
        }


@dataclasses.dataclass
class ExperimentResult:
    spec: ExperimentSpec
    runs: list[RunResult]

    @property
    def all_within_tol(self) -> bool:
        return all(r.all_within_tol for r in self.runs)

    def speedup_table(self) -> dict[str, dict[str, float]]:
        """Per run (tensor/impl[/ordering]): E-SRAM→O-SRAM speedup, trace-
        and Che-priced."""
        out: dict[str, dict[str, float]] = {}
        for r in self.runs:
            e, o = r.tech("E-SRAM"), r.tech("O-SRAM")
            out[r.key] = {
                "priced": sum(e.priced_mode_s) / sum(o.priced_mode_s),
                "modeled": sum(e.modeled_mode_s) / sum(o.modeled_mode_s),
            }
        return out

    def energy_table(self) -> dict[str, dict[str, float]]:
        """Per run (tensor/impl[/ordering]): E-SRAM→O-SRAM energy savings,
        both pricings."""
        out: dict[str, dict[str, float]] = {}
        for r in self.runs:
            e, o = r.tech("E-SRAM"), r.tech("O-SRAM")
            out[r.key] = {
                "priced": e.priced_energy_j / o.priced_energy_j,
                "modeled": e.modeled_energy_j / o.modeled_energy_j,
            }
        return out

    def fused_table(self) -> dict[str, dict[str, float]]:
        """Per run (tensor/impl[/ordering]): eager vs fused executor wall
        time (DESIGN.md §11).  Empty when the spec ran without ``fused``.

        Like-for-like only: ``speedup_cold`` compares two cold runs (the
        eager wall includes each mode's first call, the fused wall its
        executor construction); ``speedup_warm_est`` compares the warm
        fused run against ``MeasuredRun.eager_warm_est_s`` (the eager wall
        with the measured per-mode first-call surplus removed)."""
        out: dict[str, dict[str, float]] = {}
        for r in self.runs:
            m = r.measured
            if m.fused_warm_wall_s is None:
                continue
            out[r.key] = {
                "eager_wall_s": m.wall_s,
                "eager_warm_est_s": m.eager_warm_est_s,
                "fused_wall_s": m.fused_wall_s,
                "fused_warm_wall_s": m.fused_warm_wall_s,
                "speedup_cold": m.wall_s / m.fused_wall_s,
                "speedup_warm_est": m.eager_warm_est_s / m.fused_warm_wall_s,
                "max_fit_delta": m.fused_max_fit_delta,
            }
        return out

    def to_json_dict(self) -> dict:
        return {
            "benchmark": "experiments",
            "spec": self.spec.to_dict(),
            "technologies": [t.name for t in ALL_TECHS],
            "che_tolerance": CHE_VS_TRACE_TOL,
            "all_within_tol": self.all_within_tol,
            "speedup_table": self.speedup_table(),
            "energy_table": self.energy_table(),
            "fused_table": self.fused_table(),
            "runs": [r.to_dict() for r in self.runs],
            # The JAX payload lists cells its emulator-only guard skipped;
            # the port runs every cell it is asked for.
            "skipped": [],
        }


def _shares(values: Sequence[float]) -> tuple[float, ...]:
    total = sum(values)
    if total <= 0:
        return tuple(0.0 for _ in values)
    return tuple(v / total for v in values)


def _measure_sharded_subprocess(
    spec: ExperimentSpec, name: str, scale: float, tensor_name: str, ordering: str | None
) -> MeasuredRun:
    """The sharded measurement, in a worker process that starts the ranks.

    The worker re-materializes the tensor from (name, scale, seed),
    re-applying the ordering's relabeling, and reports rank 0's measured
    run as JSON; a failed worker raises with its stderr.
    """
    src_dir = Path(__file__).resolve().parents[2]
    payload = json.dumps({
        "name": name,
        "scale": scale,
        "tensor_name": tensor_name,
        "rank": spec.rank,
        "n_iters": spec.n_iters,
        "seed": spec.seed,
        "scheme": spec.scheme,
        "ordering": ordering,
        "devices": spec.n_shards,
        "device": spec.device,
        "cost_analysis": spec.cost_analysis,
        "fused": spec.fused,
        "fit_every": spec.fit_every,
    })
    env = dict(os.environ)
    env["PYTHONPATH"] = str(src_dir) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.worker"],
        input=payload, capture_output=True, text=True, env=env, timeout=1800,
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"sharded worker failed ({res.returncode}) for {tensor_name}:\n{res.stderr[-4000:]}")
    last = [ln for ln in res.stdout.splitlines() if ln.strip()][-1]
    return MeasuredRun.from_dict(json.loads(last))


def _reconcile_hit_rates(
    trace_cache: ExecutedTraceHitRates, ft: FrosttTensor, rank: int
) -> tuple[HitRateReconciliation, ...]:
    n_units = trace_cache.n_shards if trace_cache.impl == "sharded" else 1
    out = []
    for key, stats in sorted(trace_cache.stats.items()):
        geometry, mode = trace_cache.geometries[key]
        # Every input factor sees the same access count (one gather per
        # real nonzero), so one per-unit trace length covers the scenario.
        trace_length = stats[0].accesses / n_units
        che_transient = split_capacity_hit_rates(
            ft,
            mode,
            capacity_bytes=geometry.capacity_bytes,
            rank=rank,
            trace_length=trace_length,
        )
        che_steady = split_capacity_hit_rates(
            ft, mode, capacity_bytes=geometry.capacity_bytes, rank=rank
        )
        warm = tuple(s.warm_hit_rate for s in stats)
        raw = tuple(s.hit_rate for s in stats)
        max_err = max(abs(r - c) for r, c in zip(raw, che_transient))
        out.append(
            HitRateReconciliation(
                capacity_bytes=geometry.capacity_bytes,
                line_bytes=geometry.line_bytes,
                associativity=geometry.associativity,
                mode=mode,
                trace_length=trace_length,
                trace=raw,
                trace_warm=warm,
                che_transient=che_transient,
                che_steady=che_steady,
                max_abs_err=max_err,
                within_tol=max_err <= CHE_VS_TRACE_TOL,
            )
        )
    return tuple(out)


def run_experiments(
    spec: ExperimentSpec = ExperimentSpec(),
    *,
    first_call_hook: Callable | None = None,
) -> ExperimentResult:
    """Execute the full measured↔modeled reconciliation (module docstring).

    ``first_call_hook(tensor, impl, mode, factors, out)``, when given, sees
    each run's first MTTKRP call per mode (``measure_cp_als``); the card
    check holds the kernel against its plain version there.  Its seconds
    are left out of the measured walls and of ``host_s["measure"]``.  The
    ``sharded`` runs happen in the worker's ranks, out of the hook's reach.
    """
    device = resolve_device(spec.device)
    runs: list[RunResult] = []
    points = tech_comparison(list(ALL_TECHS), rank=spec.rank)
    tuner = Autotuner(device=device) if spec.autotune else None
    for name, scale in spec.tensors:
        tensor = make_frostt_like(name, scale=scale, seed=spec.seed)
        ft = scaled_characteristics(name, tensor, scale=scale)
        tensors = {ft.name: ft}
        modeled = evaluate_sweep(points, tensors, hit_rate_method="che")
        for impl in spec.impls:
            tile_nnz = rows_per_block = 256
            if tuner is not None and impl == "kernel":
                cfg = tuner.tune(tensor, spec.rank).best
                tile_nnz, rows_per_block = cfg.tile_nnz, cfg.rows_per_block
            for ordering in spec.orderings:
                # The degree strategy relabels the executed tensor once,
                # globally (DESIGN.md §10).  The dims/nnz characteristics
                # — everything the analytic model reads — are
                # label-invariant.
                exec_tensor, _perms = prepare_execution(tensor, ordering)
                hook = None
                hook_s = [0.0]  # the hook's seconds, kept out of host_s["measure"]
                if first_call_hook is not None:

                    def hook(m, f, out, _t=exec_tensor, _impl=impl, _s=hook_s):
                        h0 = time.perf_counter()
                        first_call_hook(_t, _impl, m, f, out)
                        if device.type == "cuda":
                            torch.cuda.synchronize()
                        _s[0] += time.perf_counter() - h0

                t0 = time.perf_counter()
                if impl == "sharded":
                    measured = _measure_sharded_subprocess(spec, name, scale, ft.name, ordering)
                else:
                    measured = measure_cp_als(
                        exec_tensor,
                        name=ft.name,
                        rank=spec.rank,
                        n_iters=spec.n_iters,
                        impl=impl,
                        seed=spec.seed,
                        tile_nnz=tile_nnz,
                        rows_per_block=rows_per_block,
                        ordering=ordering,
                        cost_analysis=spec.cost_analysis,
                        fused=spec.fused,
                        fit_every=spec.fit_every,
                        device=device,
                        first_call_hook=hook,
                    )
                measure_s = time.perf_counter() - t0 - hook_s[0]
                trace_cache = ExecutedTraceHitRates(
                    exec_tensor,
                    impl,
                    scheme=spec.scheme,
                    n_shards=spec.n_shards,
                    tile_nnz=tile_nnz,
                    rows_per_block=rows_per_block,
                    ordering=ordering,
                    device=device,
                )
                t0 = time.perf_counter()
                priced = evaluate_sweep(points, tensors, cache=trace_cache, device=device)
                priced_s = time.perf_counter() - t0
                techs = []
                for tech in ALL_TECHS:
                    p_cell = priced.cell(tech.name, ft.name)
                    m_cell = modeled.cell(tech.name, ft.name)
                    meas_share = _shares(measured.steady_mode_s)
                    priced_share = _shares(p_cell.mode_seconds)
                    residuals = tuple(
                        ms - ps for ms, ps in zip(meas_share, priced_share)
                    )
                    techs.append(
                        TechReconciliation(
                            tech=tech.name,
                            measured_mode_s=measured.steady_mode_s,
                            priced_mode_s=p_cell.mode_seconds,
                            modeled_mode_s=m_cell.mode_seconds,
                            priced_energy_j=p_cell.energy_j,
                            modeled_energy_j=m_cell.energy_j,
                            share_residuals=residuals,
                            max_share_residual=max(abs(r) for r in residuals),
                        )
                    )
                t0 = time.perf_counter()
                hit_rates = _reconcile_hit_rates(trace_cache, ft, spec.rank)
                reconcile_s = time.perf_counter() - t0
                traced_s = trace_cache.capture_s + trace_cache.simulate_s
                residual = None
                if impl == "sharded" and spec.scheme == "mode_ordered":
                    residual = tuple(
                        tuple(float(x) for x in residual_shares(exec_tensor, m, spec.n_shards))
                        for m in range(exec_tensor.nmodes)
                    )
                runs.append(
                    RunResult(
                        frostt=name,
                        scale=scale,
                        tensor=ft.name,
                        dims=tensor.shape,
                        nnz=tensor.nnz,
                        impl=impl,
                        measured=measured,
                        techs=tuple(techs),
                        hit_rates=hit_rates,
                        ordering=ordering,
                        host_s={
                            "measure": measure_s,
                            "capture": trace_cache.capture_s,
                            "simulate": trace_cache.simulate_s,
                            "price": priced_s - traced_s,
                            "reconcile": reconcile_s,
                        },
                        residual_share=residual,
                    )
                )
    return ExperimentResult(spec=spec, runs=runs)
