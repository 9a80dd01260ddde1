"""Cycle-model vs analytic-hierarchy reconciliation (DESIGN.md §14).

Copy of ``repro.experiments.reconcile`` for the PyTorch port (numpy, held
equal to the original by ``tests/test_torch_controller.py``).

The experiment engine gates Che's approximation against exact executed
traces (``CHE_VS_TRACE_TOL = 0.10``); this module is the same discipline
one layer down: the event-driven controller simulator
(``repro_torch.model.controller``) replayed under its Eq-1-consistent
calibration configuration (work-conserving fifo over ``n_units`` banks,
no prefetch) must land within ``CONTROLLER_RECON_TOL`` relative on total
modeled seconds against the closed-form hierarchy engine, per (workload,
technology), on every ``EXPERIMENT_SCALES`` tensor.

The residual the gate tolerates is structural and one-sided: the event
loop sums per-window maxima where the closed form takes the maximum of
per-mode sums, so phased streams (cold-start misses, hot-row bursts) can
only make the cycle model slower, never faster.  A reconciliation outside
the gate means the two engines disagree about the *steady state* — a bug,
not a modeling nuance — which is exactly what the gate is for.

In the JAX package ``scripts/run_controller.py`` drives this and gates
it.  The port's copy of that script's other two gates is
``controller_gates``: the abstract's E-SRAM/O-SRAM bands under the paper
controller, and fewer bank conflicts under the degree and blocked
orderings than under lex on a correlated tensor.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.accelerator import PAPER_ACCEL, AcceleratorConfig
from repro_torch.core.hierarchy import fpga_hierarchy, hierarchy_mode_time
from repro_torch.core.memory_tech import E_SRAM, O_SRAM, PAPER_SYSTEM, MemoryTechSpec
from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.data.frostt import PAPER_RANK
from repro_torch.data.synthetic_tensors import (
    EXPERIMENT_SCALES,
    make_frostt_like,
    scaled_characteristics,
)
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.dse.evaluator import exact_hit_rates_for_geometry
from repro_torch.model.controller import (
    BankConflictCounts,
    ControllerConfig,
    ControllerRunResult,
    bank_conflict_counts,
    calibration_controller,
    paper_controller,
    simulate_controller,
)

__all__ = [
    "BAND_SCALES",
    "CONFLICT_NNZ",
    "CONTROLLER_RECON_TOL",
    "ControllerGates",
    "ControllerReconciliation",
    "ENERGY_BAND",
    "SPEEDUP_BAND",
    "conflict_tensor",
    "controller_gates",
    "in_paper_bands",
    "ordering_conflicts",
    "paper_bands",
    "reconcile_controller",
]

# Mirrors CHE_VS_TRACE_TOL (0.10) one layer down; slightly wider because
# the event loop's sum-of-window-maxima legitimately exceeds the closed
# form on phased streams.  Measured residuals on the EXPERIMENT_SCALES
# workloads are <= +0.002 (tests/test_controller.py pins one).
CONTROLLER_RECON_TOL = 0.15

# scripts/run_controller.py's gates (its values; tests/test_torch_controller.py
# holds them equal).  The abstract's bands for E-SRAM -> O-SRAM speedup and
# energy savings, on its band workloads (NELL-2 at 1e-4, not its
# EXPERIMENT_SCALES 2e-4, where the cycle model's speedup passes 2.9).
SPEEDUP_BAND = (1.1, 2.9)
ENERGY_BAND = (2.8, 8.1)
BAND_SCALES = {"NELL-2": 1e-4, "LBNL": 2e-2, "PATENTS": 2e-5}
# The correlated tensor of the ordering gate (hot rows, clustered modes).
CONFLICT_NNZ = 160_000
_CONFLICT_DRAW = dict(seed=7, zipf_a=1.1, correlation=0.9, n_clusters=64, shuffle=True)
_CONFLICT_SHAPE = (2048, 32768, 32768)
_GATE_ORDERINGS = ("lex", "degree", "blocked")


@dataclasses.dataclass(frozen=True)
class ControllerReconciliation:
    """Cycle model vs closed form for one (workload, technology)."""

    workload: str
    tech: str
    analytic_seconds: float
    controller_seconds: float
    mode_analytic_seconds: tuple[float, ...]
    mode_controller_seconds: tuple[float, ...]
    config: ControllerConfig
    tol: float = CONTROLLER_RECON_TOL

    @property
    def rel_err(self) -> float:
        return self.controller_seconds / self.analytic_seconds - 1.0

    @property
    def ok(self) -> bool:
        return abs(self.rel_err) <= self.tol

    def as_dict(self) -> dict:
        return {
            "workload": self.workload,
            "tech": self.tech,
            "analytic_seconds": self.analytic_seconds,
            "controller_seconds": self.controller_seconds,
            "rel_err": self.rel_err,
            "tol": self.tol,
            "ok": self.ok,
            "config": self.config.label,
            "mode_analytic_seconds": list(self.mode_analytic_seconds),
            "mode_controller_seconds": list(self.mode_controller_seconds),
        }


def reconcile_controller(
    *,
    scales: dict[str, float] | None = None,
    techs: tuple[MemoryTechSpec, ...] = (E_SRAM, O_SRAM),
    accel: AcceleratorConfig = PAPER_ACCEL,
    rank: int = PAPER_RANK,
    config: ControllerConfig | None = None,
    seed: int = 0,
    tol: float = CONTROLLER_RECON_TOL,
) -> tuple[list[ControllerReconciliation], dict[str, ControllerRunResult]]:
    """Replay every (workload, tech) cell through both engines.

    Both sides consume the SAME exact per-input hit information — the
    analytic side via ``exact_hit_rates_for_geometry`` injected into
    ``hierarchy_mode_time``, the controller via its internal
    ``simulate_trace_flags`` replay of the identical streams — so the
    residual isolates the event loop itself, not hit-rate modeling.

    Returns the per-cell reconciliations plus the raw controller runs
    keyed ``"{workload}/{tech}"`` (for downstream band/energy checks).
    """
    scales = dict(EXPERIMENT_SCALES) if scales is None else scales
    cfg = config if config is not None else calibration_controller(accel)
    cells: list[ControllerReconciliation] = []
    runs: dict[str, ControllerRunResult] = {}
    for name, scale in scales.items():
        tensor = make_frostt_like(name, scale=scale, seed=seed)
        chars = scaled_characteristics(name, tensor, scale=scale)
        for tech in techs:
            hier = fpga_hierarchy(tech, accel=accel, system=PAPER_SYSTEM)
            geometry = hier.hit_geometries()[0]
            mode_a = []
            for mode in range(tensor.nmodes):
                hr = exact_hit_rates_for_geometry(tensor, mode, geometry, rank)
                mode_a.append(
                    hierarchy_mode_time(
                        hier, chars, mode, rank=rank, hit_rates=hr
                    ).seconds
                )
            run = simulate_controller(
                tensor, hier, config=cfg, rank=rank, chars=chars
            )
            runs[f"{name}/{tech.name}"] = run
            cells.append(
                ControllerReconciliation(
                    workload=name,
                    tech=tech.name,
                    analytic_seconds=float(sum(mode_a)),
                    controller_seconds=run.seconds,
                    mode_analytic_seconds=tuple(mode_a),
                    mode_controller_seconds=tuple(
                        r.seconds for r in run.mode_results
                    ),
                    config=cfg,
                    tol=tol,
                )
            )
    return cells, runs


@dataclasses.dataclass(frozen=True)
class ControllerGates:
    """The band and ordering gates of one run (``controller_gates``)."""

    bands: dict[str, tuple[float, float]]  # workload -> (speedup, energy savings)
    conflicts: dict[str, BankConflictCounts]  # ordering -> mode 0's counts

    @property
    def bands_ok(self) -> bool:
        return all(in_paper_bands(sp, en) for sp, en in self.bands.values())

    @property
    def conflicts_ok(self) -> bool:
        lex = self.conflicts["lex"].conflict_rate
        return all(c.conflict_rate < lex for o, c in self.conflicts.items() if o != "lex")

    @property
    def ok(self) -> bool:
        return self.bands_ok and self.conflicts_ok


def in_paper_bands(speedup: float, savings: float) -> bool:
    return (SPEEDUP_BAND[0] <= speedup <= SPEEDUP_BAND[1]
            and ENERGY_BAND[0] <= savings <= ENERGY_BAND[1])


def paper_bands(
    scales: dict[str, float] = BAND_SCALES, *, rank: int = PAPER_RANK, seed: int = 0
) -> dict[str, tuple[float, float]]:
    """Per workload, the paper controller's E-SRAM/O-SRAM (speedup, energy
    savings) on the scaled FROSTT stand-in."""
    cfg = paper_controller()
    out = {}
    for name, scale in scales.items():
        tensor = make_frostt_like(name, scale=scale, seed=seed)
        chars = scaled_characteristics(name, tensor, scale=scale)
        runs = {
            tech.name: simulate_controller(
                tensor,
                fpga_hierarchy(tech, accel=PAPER_ACCEL, system=PAPER_SYSTEM),
                config=cfg,
                rank=rank,
                chars=chars,
            )
            for tech in (E_SRAM, O_SRAM)
        }
        out[name] = (
            runs["E-SRAM"].seconds / runs["O-SRAM"].seconds,
            runs["E-SRAM"].energy_j / runs["O-SRAM"].energy_j,
        )
    return out


def conflict_tensor(nnz: int = CONFLICT_NNZ) -> SparseTensor:
    """The ordering gate's correlated tensor (scripts/run_controller.py
    draws ``nnz`` 160,000, or 40,000 with ``--quick``)."""
    return random_sparse_tensor(_CONFLICT_SHAPE, nnz, **_CONFLICT_DRAW)


def ordering_conflicts(
    tensor: SparseTensor, *, device: str = DEFAULT_DEVICE
) -> dict[str, BankConflictCounts]:
    """Mode 0's bank conflicts under the paper controller, per ordering of
    the gate (lex, degree, blocked); ``device`` sorts the orderings."""
    cfg = paper_controller()
    return {
        o: bank_conflict_counts(tensor, 0, config=cfg, ordering=o, device=device)
        for o in _GATE_ORDERINGS
    }


def controller_gates(
    *,
    band_scales: dict[str, float] = BAND_SCALES,
    conflict_nnz: int = CONFLICT_NNZ,
    rank: int = PAPER_RANK,
    seed: int = 0,
    device: str = DEFAULT_DEVICE,
) -> ControllerGates:
    """scripts/run_controller.py's band and ordering gates on the port."""
    return ControllerGates(
        bands=paper_bands(band_scales, rank=rank, seed=seed),
        conflicts=ordering_conflicts(conflict_tensor(conflict_nnz), device=device),
    )
