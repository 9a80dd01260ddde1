"""End-to-end experiment driver of the port (repro_torch.experiments, DESIGN.md §7).

Materializes scaled FROSTT tensors, runs measured CP-ALS sweeps through
the requested impls on ``--device``, prices every run on all four memory
technologies, prints the measured-vs-modeled report and writes the
``BENCH_experiments.json``-shaped payload (by default to
``BENCH_experiments_torch.json``, which git ignores).  The arguments are
those of the JAX package's ``scripts/run_experiments.py``, plus
``--device`` and ``--n-shards`` (the ``sharded`` impl's ranks, which run
in a worker process; its scheme is ``ExperimentSpec.scheme``'s default);
``--autotune`` tunes each tensor's plan geometry on ``--device`` before
its kernel cells.

Usage:
    PYTHONPATH=src python -m repro_torch.experiments --device cpu \\
        --tensors NELL-2@1e-4 --impls ref,kernel --iters 2 \\
        --out /tmp/BENCH_experiments_torch.json
    PYTHONPATH=src python -m repro_torch.experiments --device cpu \\
        --tensors NELL-2@1e-4 --impls sharded --n-shards 4 --iters 2 \\
        --out /tmp/BENCH_experiments_torch.json

Exits nonzero if any priced scenario's exact-trace hit rate disagrees
with the Che approximation beyond the documented 0.10 tolerance.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.core.mttkrp import IMPLS
from repro_torch.data.frostt import FROSTT_TENSORS, PAPER_RANK
from repro_torch.data.synthetic_tensors import EXPERIMENT_SCALES
from repro_torch.experiments import ExperimentSpec, run_experiments
from repro_torch.perf.report import experiments_report_md

# Not BENCH_experiments.json: that is the JAX package's committed artifact.
DEFAULT_OUT = "BENCH_experiments_torch.json"


def _parse_tensors(arg: str) -> tuple[tuple[str, float], ...]:
    """``NAME[@SCALE]``, comma-separated; default scales from the catalog."""
    out = []
    for item in arg.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, scale_s = item.partition("@")
        if name not in FROSTT_TENSORS:
            raise SystemExit(
                f"unknown tensor {name!r}; known: {sorted(FROSTT_TENSORS)}"
            )
        if scale_s:
            scale = float(scale_s)
        elif name in EXPERIMENT_SCALES:
            scale = EXPERIMENT_SCALES[name]
        else:
            raise SystemExit(
                f"no default scale for {name!r}; pass {name}@SCALE explicitly"
            )
        out.append((name, scale))
    if not out:
        raise SystemExit("--tensors selected nothing")
    return tuple(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--tensors",
        default=",".join(EXPERIMENT_SCALES),
        help="comma list of NAME[@SCALE] (default: the catalog scales, "
        + ", ".join(f"{n}@{s:g}" for n, s in EXPERIMENT_SCALES.items())
        + ")",
    )
    ap.add_argument(
        "--impls",
        default=",".join(IMPLS),
        help="comma list from {ref,kernel,sharded}",
    )
    ap.add_argument(
        "--n-shards",
        type=int,
        default=8,
        help="ranks of the sharded impl, one process each (on the card they share it)",
    )
    ap.add_argument("--rank", type=int, default=PAPER_RANK)
    ap.add_argument("--iters", type=int, default=3, help="CP-ALS iterations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--no-cost-analysis",
        action="store_true",
        help="skip the closed-form flops and bytes per mode",
    )
    ap.add_argument(
        "--no-fused",
        action="store_true",
        help="skip the fused-executor timing path (DESIGN.md §11)",
    )
    ap.add_argument(
        "--fit-every",
        type=int,
        default=1,
        help="fused executor host-sync cadence in sweeps",
    )
    ap.add_argument(
        "--backend",
        default=None,
        help="the JAX driver's Pallas backend; the port has one route per "
        "device, so any value is refused",
    )
    ap.add_argument(
        "--autotune",
        action="store_true",
        help="tune (tile_nnz, rows_per_block) per tensor through the "
        "closed-loop DSE autotuner before measuring kernel cells",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the CP-ALS runs execute: cuda (default) or cpu",
    )
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.backend is not None:
        raise SystemExit(
            "--backend selects a Pallas backend of the JAX package; the port "
            "runs the CUDA kernel on the card and its plain version on the CPU "
            "(choose with --device)"
        )
    impls = tuple(i.strip() for i in args.impls.split(",") if i.strip())
    unknown = [i for i in impls if i not in IMPLS]
    if unknown:
        raise SystemExit(f"unknown impls {unknown}; known: {list(IMPLS)}")

    spec = ExperimentSpec(
        tensors=_parse_tensors(args.tensors),
        impls=impls,
        rank=args.rank,
        n_iters=args.iters,
        seed=args.seed,
        n_shards=args.n_shards,
        cost_analysis=not args.no_cost_analysis,
        fused=not args.no_fused,
        fit_every=args.fit_every,
        device=args.device,
        autotune=args.autotune,
    )
    t0 = time.perf_counter()
    result = run_experiments(spec)
    wall = time.perf_counter() - t0

    payload = result.to_json_dict()
    payload["driver_wall_s"] = wall
    print(experiments_report_md(payload))
    print(f"\ndriver wall time: {wall:.1f}s for {len(result.runs)} runs")
    Path(args.out).write_text(json.dumps(payload, indent=2))
    print(f"wrote {args.out}")
    if not result.all_within_tol:
        print("FAIL: trace-vs-Che hit-rate reconciliation out of tolerance")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
