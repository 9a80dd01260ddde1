"""Collective traffic of a step (port of ``repro.perf.hlo_stats``).

JAX's module parses the collectives out of XLA's compiled HLO text.  The
port has no HLO: its collectives are the calls its sharded step makes
itself (a rank's run on ``meta`` records them, ``launch.dryrun.rank_collectives``;
``perf.coll_breakdown`` reads them from a ``torch.profiler`` trace).
Either way they arrive as records ``{"kind", "result_bytes", "group"}``,
one per collective call, with JAX's kind names (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``collective-permute``)
and ``result_bytes`` the bytes of the call's result (for ``all-gather`` the
gathered output, for ``reduce-scatter`` the scattered one).  This module
sums them as JAX's ``collective_stats`` does, with its ring-schedule
factors for the bytes each rank moves.
"""

from __future__ import annotations

import dataclasses

__all__ = ["KINDS", "CollectiveStats", "collective_stats", "ring_bytes"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict  # summed result bytes per kind
    ici_bytes_per_chip: float  # ring-schedule bytes a rank moves (JAX's name)
    total_result_bytes: float

    def summary(self) -> str:
        parts = [
            f"{k}: n={self.counts[k]}, result={self.result_bytes[k]/1e6:.1f}MB"
            for k in sorted(self.counts)
        ]
        return "; ".join(parts) or "no collectives"


def ring_bytes(kind: str, result_bytes: float, group: int) -> float:
    """The bytes one rank moves for one call under a ring schedule (JAX's
    factors, ``hlo_stats.py:98-108``); 0 for a group of one."""
    n = max(int(group), 1)
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes  # the gathered (output) size
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes  # the scattered (output) size
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"collective kind {kind!r}: use one of {KINDS}")


def collective_stats(records) -> CollectiveStats:
    """Counts, result bytes per kind and ring bytes a rank over ``records``."""
    counts: dict = {}
    rbytes: dict = {}
    ici = 0.0
    for r in records:
        k, b, n = r["kind"], float(r["result_bytes"]), r["group"]
        counts[k] = counts.get(k, 0) + 1
        rbytes[k] = rbytes.get(k, 0.0) + b
        ici += ring_bytes(k, b, n)
    return CollectiveStats(
        counts=counts,
        result_bytes=rbytes,
        ici_bytes_per_chip=ici,
        total_result_bytes=float(sum(rbytes.values())),
    )
