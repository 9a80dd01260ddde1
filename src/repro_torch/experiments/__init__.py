"""End-to-end experiment engine (DESIGN.md §7), the port of ``repro.experiments``.

Executes real CP-ALS sweeps on scaled FROSTT tensors through each MTTKRP
impl (``ref``; ``kernel``: the split CUDA kernel on the card; ``sharded``:
one rank per shard, each shard through the split kernel),
captures per-mode times, the closed-form cost and executed-order exact
cache traces, prices the same runs on all four memory stacks via the DSE
evaluator, and reconciles measured against modeled:

  * ``repro_torch.experiments.measure`` — instrumented runs + trace capture;
  * ``repro_torch.experiments.engine``  — orchestration, pricing, residuals,
    the ``BENCH_experiments.json``-shaped payload;
  * ``repro_torch.experiments.reconcile`` — the cycle-level controller
    simulator (``repro_torch.model.controller``, DESIGN.md §14) gated
    against the closed-form hierarchy under its calibration configuration
    (``CONTROLLER_RECON_TOL``), the Che-vs-trace gate one layer down, and
    ``controller_gates``, the paper bands and the ordering gate;

  * ``repro_torch.experiments.worker`` — the sharded measurement's worker
    process, which starts one rank per shard.

Driven by ``python -m repro_torch.experiments`` on the CPU and by
``chip_smoke.py`` phases 11 and 14 on the card.
"""

from repro_torch.experiments.engine import (
    ALL_TECHS,
    CHE_VS_TRACE_TOL,
    ExperimentResult,
    ExperimentSpec,
    HitRateReconciliation,
    RunResult,
    TechReconciliation,
    run_experiments,
)
from repro_torch.experiments.reconcile import (
    CONTROLLER_RECON_TOL,
    ControllerGates,
    ControllerReconciliation,
    controller_gates,
    reconcile_controller,
)
from repro_torch.experiments.measure import (
    ExecutedTraceHitRates,
    MeasuredMode,
    MeasuredRun,
    executed_input_traces,
    executed_trace_stats,
    executed_traces,
    measure_cp_als,
    mode_cost_analysis,
)

__all__ = [
    "ALL_TECHS",
    "CHE_VS_TRACE_TOL",
    "ExperimentResult",
    "ExperimentSpec",
    "HitRateReconciliation",
    "RunResult",
    "TechReconciliation",
    "run_experiments",
    "CONTROLLER_RECON_TOL",
    "ControllerGates",
    "ControllerReconciliation",
    "controller_gates",
    "reconcile_controller",
    "ExecutedTraceHitRates",
    "MeasuredMode",
    "MeasuredRun",
    "executed_input_traces",
    "executed_trace_stats",
    "executed_traces",
    "measure_cp_als",
    "mode_cost_analysis",
]
