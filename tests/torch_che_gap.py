"""Che against the executed trace on PATENTS@5.6e-4: the JAX package and the port.

Runs the experiment engine's ``ref`` impl and its kernel impl (the JAX
package's ``pallas``, the port's ``kernel``, both through their plain paths
on the CPU) on the same ``make_frostt_like("PATENTS", 5.6e-4)`` draw, one
sweep each, and prints, for each (impl, cache geometry, mode), the exact
LRU hit rates of the executed trace beside Che's transient ones and their
largest gap, from both packages, then whether the two packages agree on
every row.  Where both read the same gap past ``CHE_VS_TRACE_TOL``, the gap
is the model's (Che's approximation), not a fault of the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_che_gap.py

About 45 s on the CPU.  Not a test: the suite's time is kept for tests.
"""

from __future__ import annotations

import json
import sys

SPEC = dict(tensors=(("PATENTS", 5.6e-4),), fused=False, cost_analysis=False, n_iters=1)


def rows(result, rename=None) -> list[dict]:
    out = []
    for run in result.runs:
        for h in run.hit_rates:
            out.append(dict(impl=(rename or {}).get(run.impl, run.impl), nnz=run.nnz,
                            capacity=h.capacity_bytes, line=h.line_bytes, assoc=h.associativity,
                            mode=h.mode, trace=list(h.trace), che=list(h.che_transient),
                            max_abs_err=h.max_abs_err))
    return out


def main() -> int:
    from repro.experiments.engine import ExperimentSpec as JaxSpec
    from repro.experiments.engine import run_experiments as jax_run
    from repro_torch.experiments.engine import CHE_VS_TRACE_TOL, ExperimentSpec, run_experiments

    ours = rows(run_experiments(ExperimentSpec(impls=("ref", "kernel"), device="cpu", **SPEC)))
    theirs = rows(jax_run(JaxSpec(impls=("ref", "pallas"), **SPEC)), {"pallas": "kernel"})
    for a in ours:
        print(json.dumps(a))
    worst = max(r["max_abs_err"] for r in ours)
    print(f"nnz {ours[0]['nnz']}; largest |trace - che| {worst:.4f} (tol {CHE_VS_TRACE_TOL}); "
          f"rows past the tolerance: port {sum(r['max_abs_err'] > CHE_VS_TRACE_TOL for r in ours)}, "
          f"JAX {sum(r['max_abs_err'] > CHE_VS_TRACE_TOL for r in theirs)}; "
          f"the two packages agree on every row: {ours == theirs}")
    return 0 if ours == theirs else 1


if __name__ == "__main__":
    sys.exit(main())
