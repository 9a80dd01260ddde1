"""Ordering sweep: price every strategy's executed trace on every stack.

Copy of ``repro.reorder.bench`` for the PyTorch port (numpy pricing, held
equal to the original by ``tests/test_torch_report.py``); the orderings
sort on ``device=`` (default ``"cuda"``).

The measurement half of the ordering subsystem (DESIGN.md §10): for each
tensor × strategy, capture the strategy's executed nonzero order (the
degree strategy first relabels the tensor — its whole point), simulate
the exact LRU hit rates of that order on every caching level of all four
memory stacks, and price time + energy through the DSE evaluator with
those measured rates injected (``ExecutedTraceHitRates``, exactly the
experiment engine's pricing path).  The payload behind
``BENCH_reorder.json`` (``make reorder`` / ``scripts/run_reorder.py``)
reports hit-rate and energy deltas per (tensor, mode, strategy, stack).

The default workload is two cross-mode-correlated synthetic tensors
(``repro_torch.core.sparse_tensor.random_sparse_tensor`` hot-row coupling knob)
chosen so the strategies' distinct levers are visible against the paper's
Table-I cache geometry:

  * ``corr-hotrow``  — mid-size output mode, large input catalogs,
    strong coupling: the degree relabeling concentrates each hot cluster
    into a contiguous label band (working set « cache share);
  * ``corr-longrow`` — a PATENTS-like 46-row output mode whose rows are
    far longer than the cache: ``blocked`` tiling and ``secondary-sort``
    within-row grouping collapse the long reuse distances.

The acceptance gate: on the correlated workload, at least one
non-lex strategy must show a strictly higher exact-LRU hit rate AND a
strictly lower priced energy than lex on both the E-SRAM and the O-SRAM
stack.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.hierarchy import PHOTONIC_IMC
from repro_torch.core.memory_tech import E_SRAM, O_SRAM, TPU_V5E
from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.data.frostt import PAPER_RANK, FrosttTensor
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.dse import evaluate_sweep, tech_comparison
from repro_torch.experiments.measure import ExecutedTraceHitRates
from repro_torch.model import bank_conflict_counts, paper_controller
from repro_torch.reorder.strategies import ORDERINGS, prepare_execution

__all__ = [
    "REORDER_STACKS",
    "ACCEPTANCE_STACKS",
    "default_tensors",
    "run_reorder_sweep",
]

# The four memory stacks of DESIGN.md §9, priced through the one engine.
REORDER_STACKS = (E_SRAM, O_SRAM, TPU_V5E, PHOTONIC_IMC)

# The stacks the acceptance gate checks (the paper pair: both share the
# Table-I cache geometry, so they see identical hit rates but different
# timing/energy constants).
ACCEPTANCE_STACKS = ("E-SRAM", "O-SRAM")


def default_tensors(*, quick: bool = False, seed: int = 7) -> dict[str, SparseTensor]:
    """The two correlated workloads of the module docstring.

    ``quick`` shrinks the nonzero counts ~4x for the CI smoke run; the
    locality structure (and hence the acceptance deltas) survives because
    the shapes keep input catalogs well above the cache share.
    """
    scale = 4 if quick else 1
    return {
        "corr-hotrow": random_sparse_tensor(
            (2048, 32768, 32768),
            160_000 // scale,
            seed=seed,
            zipf_a=0.7,
            correlation=0.9,
            n_clusters=64,
            shuffle=True,
        ),
        "corr-longrow": random_sparse_tensor(
            (46, 49152, 49152),
            400_000 // scale,
            seed=seed + 4,
            zipf_a=0.8,
            correlation=0.6,
            n_clusters=64,
            shuffle=True,
        ),
    }


def _characteristics(name: str, t: SparseTensor, zipf_alpha: float = 0.8) -> FrosttTensor:
    """A Table-II-style record describing a materialized tensor (the
    analytic engine's input contract; zipf_alpha is only read by the Che
    path, which this sweep never takes — pricing injects measured rates)."""
    return FrosttTensor(
        name=name,
        dims=t.shape,
        nnz=t.nnz,
        density=t.density,
        zipf_alpha=zipf_alpha,
    )


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def run_reorder_sweep(
    tensors: Mapping[str, SparseTensor] | None = None,
    *,
    strategies: Sequence[str] = ORDERINGS,
    rank: int = PAPER_RANK,
    quick: bool = False,
    seed: int = 7,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict:
    """Price every (tensor, strategy, stack) cell; return the artifact
    payload.  The strategies' orders are sorted on ``device``."""
    if tensors is None:
        tensors = default_tensors(quick=quick, seed=seed)
    points = tech_comparison(list(REORDER_STACKS), rank=rank)

    mode_cells: list[dict] = []
    run_cells: list[dict] = []
    for name, tensor in tensors.items():
        ft = _characteristics(name, tensor)
        per_strategy: dict[str, dict[str, dict]] = {}
        for strategy in strategies:
            # The degree strategy's relabeling half is applied globally
            # (factors would be row-permuted the same way — label-invariant
            # for everything the pricing reads); the execution-order half
            # rides through ExecutedTraceHitRates.
            exec_t, _ = prepare_execution(tensor, strategy)
            cache = ExecutedTraceHitRates(exec_t, "ref", ordering=strategy, device=device)
            res = evaluate_sweep(points, {ft.name: ft}, cache=cache, device=device)
            # Structural bank conflicts of the strategy's mode-0 request
            # stream under the paper controller (repro_torch.model.controller,
            # DESIGN.md §14) — a stack-independent diagnostic column, not
            # part of the acceptance gate (the controller bench gates it
            # on its own correlated workloads).
            conflicts = bank_conflict_counts(
                tensor, 0, config=paper_controller(), ordering=strategy, device=device
            )
            per_strategy[strategy] = {}
            for tech in REORDER_STACKS:
                cell = res.cell(tech.name, ft.name)
                hit_by_mode = [list(mt.hit_rates) for mt in cell.mode_times]
                rec = {
                    "tensor": name,
                    "strategy": strategy,
                    "stack": tech.name,
                    "seconds": cell.seconds,
                    "energy_j": cell.energy_j,
                    "mean_hit_rate": _mean([h for hs in hit_by_mode for h in hs]),
                    "bank_conflict_rate": conflicts.conflict_rate,
                }
                per_strategy[strategy][tech.name] = rec
                for m, mt in enumerate(cell.mode_times):
                    mode_cells.append(
                        {
                            "tensor": name,
                            "mode": m,
                            "strategy": strategy,
                            "stack": tech.name,
                            "hit_rates": list(mt.hit_rates),
                            "mean_hit_rate": _mean(list(mt.hit_rates)),
                            "seconds": mt.seconds,
                            "bottleneck": mt.bottleneck,
                        }
                    )
        lex = per_strategy.get("lex", {})
        for strategy in strategies:
            for tech in REORDER_STACKS:
                rec = dict(per_strategy[strategy][tech.name])
                base = lex.get(tech.name)
                if base is not None:
                    rec["d_hit_vs_lex"] = rec["mean_hit_rate"] - base["mean_hit_rate"]
                    rec["d_conflicts_vs_lex"] = (
                        rec["bank_conflict_rate"] - base["bank_conflict_rate"]
                    )
                    rec["speedup_vs_lex"] = (
                        base["seconds"] / rec["seconds"] if rec["seconds"] else None
                    )
                    rec["d_energy_vs_lex"] = (
                        rec["energy_j"] - base["energy_j"]
                        if (rec["energy_j"] is not None and base["energy_j"] is not None)
                        else None
                    )
                run_cells.append(rec)

    acceptance = _acceptance(run_cells, strategies)
    return {
        "benchmark": "reorder",
        "rank": rank,
        "quick": quick,
        "strategies": list(strategies),
        "stacks": [t.name for t in REORDER_STACKS],
        "tensors": {
            name: {"dims": list(t.shape), "nnz": t.nnz} for name, t in tensors.items()
        },
        "runs": run_cells,
        "mode_cells": mode_cells,
        "acceptance": acceptance,
    }


def _acceptance(run_cells: list[dict], strategies: Sequence[str]) -> dict:
    """The acceptance gate: per tensor, a non-lex strategy strictly better than
    lex in hit rate AND energy on BOTH acceptance stacks."""
    by = {(r["tensor"], r["strategy"], r["stack"]): r for r in run_cells}
    tensors = sorted({r["tensor"] for r in run_cells})
    out: dict = {"stacks": list(ACCEPTANCE_STACKS), "tensors": {}}
    any_ok = False
    for name in tensors:
        winners = []
        for s in strategies:
            if s == "lex":
                continue
            ok = all(
                (key := (name, s, stack)) in by
                and (lex := by.get((name, "lex", stack))) is not None
                and by[key]["mean_hit_rate"] > lex["mean_hit_rate"]
                and by[key]["energy_j"] is not None
                and lex["energy_j"] is not None
                and by[key]["energy_j"] < lex["energy_j"]
                for stack in ACCEPTANCE_STACKS
            )
            if ok:
                winners.append(s)
        out["tensors"][name] = {"winners": winners, "ok": bool(winners)}
        any_ok = any_ok or bool(winners)
    out["ok"] = any_ok and all(v["ok"] for v in out["tensors"].values())
    return out
