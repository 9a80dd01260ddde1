"""Pareto-frontier / comparison layer over sweep results (DESIGN.md §8).

Copy of ``repro.dse.pareto`` for the PyTorch port (held equal to the
original by ``tests/test_torch_dse.py``).

Configurations are ranked on the two objectives the paper trades off —
per-tensor-suite execution time (Fig 7) and energy (Fig 8) — and the
non-dominated set is extracted.  ``compare_techs`` reproduces the paper's
headline comparison as the trivial two-point sweep: the E-SRAM point is
the baseline, the O-SRAM point's speedup and energy-savings ratios are
exactly ``speedup_table()`` / ``energy_table()``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.data.frostt import FrosttTensor
from repro_torch.dse.evaluator import HitRateCache, SweepResult, evaluate_sweep
from repro_torch.dse.sweep import paper_pair

__all__ = [
    "ParetoPoint",
    "pareto_frontier",
    "rank_configurations",
    "compare_techs",
    "paper_pair_result",
]


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One configuration projected onto the (time, energy) objective plane."""

    label: str
    time_s: float
    energy_j: float | None

    def dominates(self, other: "ParetoPoint") -> bool:
        """True if no worse on both objectives and better on at least one.

        Points without an energy model (TPU roofline) can only be compared
        on time; they never dominate (and are never dominated by) a point
        that does carry energy.
        """
        if (self.energy_j is None) != (other.energy_j is None):
            return False
        if self.energy_j is None:
            return self.time_s < other.time_s
        return (
            self.time_s <= other.time_s
            and self.energy_j <= other.energy_j
            and (self.time_s < other.time_s or self.energy_j < other.energy_j)
        )


def pareto_frontier(points: Sequence[ParetoPoint]) -> list[ParetoPoint]:
    """Non-dominated subset (minimize time and energy), sorted by time.

    Exact objective ties are collapsed to the first point carrying them —
    a saturated sweep (e.g. frequency beyond the DRAM roof) otherwise
    floods the frontier with equivalent configurations.
    """
    frontier = [
        p
        for p in points
        if not any(q.dominates(p) for q in points if q is not p)
    ]
    seen: set[tuple] = set()
    unique = []
    for p in sorted(frontier, key=lambda p: (p.time_s, p.energy_j or 0.0)):
        obj = (p.time_s, p.energy_j)
        if obj not in seen:
            seen.add(obj)
            unique.append(p)
    return unique


def rank_configurations(result: SweepResult) -> list[ParetoPoint]:
    """Project a sweep onto the objective plane, fastest-first."""
    pts = [
        ParetoPoint(label=label, time_s=t, energy_j=e)
        for label, (t, e) in result.aggregate().items()
    ]
    return sorted(pts, key=lambda p: p.time_s)


def compare_techs(
    result: SweepResult, *, baseline: str
) -> list[dict]:
    """Per-configuration speedup/energy-savings ratios vs a baseline label."""
    agg = result.aggregate()
    if baseline not in agg:
        raise KeyError(f"baseline {baseline!r} not in sweep: {sorted(agg)}")
    t0, e0 = agg[baseline]
    rows = []
    for label, (t, e) in agg.items():
        rows.append(
            {
                "config": label,
                "time_s": t,
                "energy_j": e,
                "speedup": t0 / t,
                "energy_savings": (e0 / e) if (e0 is not None and e is not None) else None,
                "pareto": False,  # filled by caller via pareto_frontier if wanted
            }
        )
    front = {p.label for p in pareto_frontier(rank_configurations(result))}
    for row in rows:
        row["pareto"] = row["config"] in front
    return sorted(rows, key=lambda r: r["time_s"])


def paper_pair_result(
    tensors: Mapping[str, FrosttTensor] | None = None,
    *,
    cache: HitRateCache | None = None,
) -> SweepResult:
    """Evaluate the paper's E-SRAM/O-SRAM pair as a 2-point sweep.

    Per-mode times and per-tensor energies are bit-identical to
    ``repro_torch.core.perf_model.speedup_table()`` / ``energy_table()`` —
    asserted by tests/test_dse.py and benchmarks/dse_sweep.py.
    """
    return evaluate_sweep(paper_pair(), tensors, hit_rate_method="che", cache=cache)
