"""Cycle-level architectural models layered over the analytic hierarchy.

Copy of ``repro.model`` for the PyTorch port (numpy; orderings other than
``"lex"`` sort on ``device=``).

``repro_torch.model.controller`` (DESIGN.md §14) is an event-driven, cycle-level
memory-controller simulator in the spirit of the PMC paper (arXiv
2207.08298, "Towards Programmable Memory Controller for Tensor
Decomposition"): banking, bank-conflict policy, prefetch depth, and
reorder-buffer depth are parameters the closed-form Eq-1 model cannot
see.  It replays the exact per-nonzero access traces the execution plans
already expose and emits cycles/energy per mode through the same
``ModeTime``/``hierarchy_energy`` plumbing as the analytic engine, so
E-SRAM vs O-SRAM stays an apples-to-apples comparison at cycle
granularity.
"""

from repro_torch.model.controller import (
    POLICIES,
    BankConflictCounts,
    ControllerConfig,
    ControllerModeResult,
    ControllerRunResult,
    bank_conflict_counts,
    calibration_controller,
    paper_controller,
    request_streams,
    simulate_controller,
    simulate_controller_mode,
)

__all__ = [
    "POLICIES",
    "BankConflictCounts",
    "ControllerConfig",
    "ControllerModeResult",
    "ControllerRunResult",
    "bank_conflict_counts",
    "calibration_controller",
    "paper_controller",
    "request_streams",
    "simulate_controller",
    "simulate_controller_mode",
]
