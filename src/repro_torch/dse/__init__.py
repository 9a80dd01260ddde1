"""Design-space exploration over the paper's memory-technology model.

Copy of ``repro.dse`` for the PyTorch port, without the autotuner.

The paper's headline numbers (Fig 7 speedup, Fig 8 energy) are two points
in a larger design space — frequency, WDM wavelength count, port width,
cache geometry, PE count, DRAM channels, rank.  This package makes those
axes sweepable (DESIGN.md §8):

  * ``repro_torch.dse.sweep``     — ``SweepSpec``/``SweepPoint``: grids of
    parameter overrides over the base ``MemoryTechSpec``/``TpuSpec`` /
    ``AcceleratorConfig`` / ``SystemConstants``, plus hierarchy-level
    axes (``level_axis_points``, ``add_level_point``,
    ``drop_level_point`` — DESIGN.md §9); the paper's E-SRAM vs O-SRAM
    comparison is the trivial 2-point sweep (``paper_pair``); the
    memory-controller knobs (``n_banks``, ``bank_policy``,
    ``prefetch_depth``, ``reorder_buffer``) are axes too, pricing
    points through the cycle-level simulator of
    ``repro_torch.model.controller`` (DESIGN.md §14) — such points need
    ``trace_tensors=`` in the evaluator;
  * ``repro_torch.dse.evaluator`` — resolves every point to its
    ``repro_torch.core.hierarchy.MemoryHierarchy`` and prices all cells through
    the one batched engine, with hit rates memoized per ``CacheGeometry``
    (they never depend on the memory technology), choosing exact LRU
    trace simulation or the Che approximation per tensor;
  * ``repro_torch.dse.pareto``    — the time-vs-energy comparison layer:
    Pareto frontier, ranking, and baseline-relative speedup/savings;
  * ``repro.dse.autotune`` — the measured side of the loop — is not
    ported yet (ROADMAP.md Queue 1 item 6): its names raise an
    ``ImportError`` that says so.

The TPU-v5e and photonic-IMC stacks participate as plain hierarchy
instances — no per-technology dispatch; sweep tables render through
``repro_torch.perf.report``.
"""

from repro_torch.dse.evaluator import (
    HitRateCache,
    PointTensorResult,
    SweepResult,
    evaluate_sweep,
    exact_hit_rates,
    geometry_sim_config,
)
from repro_torch.dse.pareto import (
    ParetoPoint,
    compare_techs,
    paper_pair_result,
    pareto_frontier,
    rank_configurations,
)
from repro_torch.dse.sweep import (
    DEFAULT_AXIS_VALUES,
    SWEEP_AXES,
    SweepPoint,
    SweepSpec,
    add_level_point,
    drop_level_point,
    level_axis_points,
    paper_pair,
    tech_comparison,
)

__all__ = [
    "DEFAULT_AXIS_VALUES",
    "SWEEP_AXES",
    "SweepPoint",
    "SweepSpec",
    "add_level_point",
    "drop_level_point",
    "level_axis_points",
    "paper_pair",
    "tech_comparison",
    "HitRateCache",
    "PointTensorResult",
    "SweepResult",
    "evaluate_sweep",
    "exact_hit_rates",
    "geometry_sim_config",
    "ParetoPoint",
    "pareto_frontier",
    "rank_configurations",
    "compare_techs",
    "paper_pair_result",
]

# The names of ``repro.dse.autotune``, which the port does not have yet.
_AUTOTUNE_NAMES = frozenset({
    "DEFAULT_TILE_CONFIG",
    "Autotuner",
    "TileConfig",
    "TuneResult",
    "TuneSpace",
    "WallTimeMemo",
    "measure_config",
    "measured_vs_modeled",
})


def __getattr__(name: str):
    if name in _AUTOTUNE_NAMES:
        raise ImportError(
            f"repro_torch.dse.{name} is not ported yet: the autotuner is "
            "ROADMAP.md Queue 1 item 6 (dse/autotune.py)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
