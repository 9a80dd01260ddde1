"""Assemble EXPERIMENTS.md §Dry-run / §Roofline tables from results/dryrun.

Copy of ``repro.perf.report`` for the PyTorch port: pure formatting, held
string-equal to the original by ``tests/test_torch_report.py``.

Also renders ``repro_torch.dse`` sweep results (DESIGN.md §8): a generic
markdown-table renderer (``sweep_table_md``) plus a JSON serializer
(``sweep_table_json``) used by ``benchmarks/dse_sweep.py`` to emit the
``BENCH_dse.json`` trajectory artifact; and the experiment engine's
measured-vs-modeled report (``experiments_report_md``, DESIGN.md §7)
rendered from the ``BENCH_experiments.json`` payload.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = [
    "load_cells",
    "roofline_table_md",
    "dryrun_summary_md",
    "sweep_table_md",
    "sweep_table_json",
    "experiments_report_md",
    "reorder_report_md",
    "controller_report_md",
]


def load_cells(results_dir: str | Path) -> list[dict]:
    cells = []
    for p in sorted(Path(results_dir).glob("*.json")):
        cells.append(json.loads(p.read_text()))
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table_md(cells: list[dict], mesh: str = "16x16") -> str:
    rows = [
        "| arch | shape | compute | memory | collective | dominant | useful ratio | roofline-MFU | HBM/chip |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if c.get("status") == "skip":
            rows.append(
                f"| {c['arch']} | {c['shape']} | — | — | — | SKIP | — | — | — |"
            )
            continue
        if c.get("status") != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | | | |")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['mfu_roofline']*100:.2f}% | {r['hbm_gb_per_chip']:.1f}GB |"
        )
    return "\n".join(rows)


def _fmt_cell(x) -> str:
    if x is None:
        return "—"
    if isinstance(x, bool):
        return "yes" if x else "no"
    if isinstance(x, float):
        if x == 0.0:
            return "0"
        if abs(x) >= 1e4 or abs(x) < 1e-3:
            return f"{x:.3e}"
        return f"{x:.4g}"
    return str(x)


def sweep_table_md(rows: list[dict], columns: list[str] | None = None) -> str:
    """Render DSE sweep rows (list of flat dicts) as a markdown table.

    ``columns`` fixes the order; by default the union of keys in
    first-seen order is used so heterogeneous rows (e.g. TPU rows with no
    energy) still render, with missing cells shown as ``—``.
    """
    if not rows:
        return "(empty sweep)"
    if columns is None:
        columns = []
        for r in rows:
            for k in r:
                if k not in columns:
                    columns.append(k)
    out = [
        "| " + " | ".join(columns) + " |",
        "|" + "---|" * len(columns),
    ]
    for r in rows:
        out.append("| " + " | ".join(_fmt_cell(r.get(c)) for c in columns) + " |")
    return "\n".join(out)


def sweep_table_json(rows: list[dict], *, meta: dict | None = None) -> str:
    """Serialize sweep rows (+ optional run metadata) to pretty JSON."""
    return json.dumps({"meta": meta or {}, "rows": rows}, indent=2, sort_keys=False)


def experiments_report_md(payload: dict) -> str:
    """Human-readable report for a ``BENCH_experiments.json`` payload.

    Four sections: the measured CP-ALS runs, the per-technology pricing
    with share residuals, the reproduced speedup/energy tables (measured-
    priced next to Che-modeled), and the trace-vs-Che hit-rate
    reconciliation at the documented tolerance (DESIGN.md §7).
    """
    lines: list[str] = []

    with_ordering = any(r.get("ordering") for r in payload["runs"])
    measured_rows = []
    for r in payload["runs"]:
        m = r["measured"]
        measured_rows.append(
            {
                "tensor": r["tensor"],
                "impl": r["impl"],
                **({"ordering": r.get("ordering") or "native"} if with_ordering else {}),
                "nnz": r["nnz"],
                "iters": m["iters"],
                "fit": m["fit"],
                "mode_ms": "/".join(
                    f"{mm['steady_s']*1e3:.1f}" for mm in m["modes"]
                ),
                "wall_s": m["wall_s"],
                # Warm-vs-warm(est): eager wall minus the measured per-mode
                # compile surplus, against the warm fused run (DESIGN.md §11).
                **(
                    {
                        "fused_warm_s": m["fused_warm_wall_s"],
                        "fused_speedup": (
                            m["wall_s"]
                            - sum(
                                max(mm["first_s"] - mm["steady_s"], 0.0)
                                for mm in m["modes"]
                            )
                        )
                        / m["fused_warm_wall_s"],
                    }
                    if m.get("fused_warm_wall_s")
                    else {}
                ),
            }
        )
    lines.append("## Measured CP-ALS runs (steady-state ms per mode)\n")
    lines.append(sweep_table_md(measured_rows))

    tech_rows = []
    for r in payload["runs"]:
        for t in r["technologies"]:
            tech_rows.append(
                {
                    "tensor": r["tensor"],
                    "impl": r["impl"],
                    **(
                        {"ordering": r.get("ordering") or "native"}
                        if with_ordering
                        else {}
                    ),
                    "tech": t["tech"],
                    "priced_s": sum(t["priced_mode_s"]),
                    "modeled_s": sum(t["modeled_mode_s"]),
                    "energy_j": t["priced_energy_j"],
                    "max_share_residual": t["max_share_residual"],
                }
            )
    lines.append("\n## Hierarchy pricing (measured hit rates vs Che model)\n")
    lines.append(sweep_table_md(tech_rows))

    table_rows = []
    for key, sp in payload["speedup_table"].items():
        ev = payload["energy_table"][key]
        table_rows.append(
            {
                "run": key,
                "speedup_priced": sp["priced"],
                "speedup_modeled": sp["modeled"],
                "energy_savings_priced": ev["priced"],
                "energy_savings_modeled": ev["modeled"],
            }
        )
    lines.append("\n## Reproduced paper pair (E-SRAM → O-SRAM)\n")
    lines.append(sweep_table_md(table_rows))

    tol = payload["che_tolerance"]
    scenarios = [h for r in payload["runs"] for h in r["hit_rates"]]
    worst = max(scenarios, key=lambda h: h["max_abs_err"], default=None)
    lines.append("\n## Hit-rate reconciliation (exact executed trace vs Che)\n")
    lines.append(
        f"- {len(scenarios)} priced scenarios, tolerance {tol:.2f}: "
        + ("ALL WITHIN TOLERANCE" if payload["all_within_tol"] else "VIOLATIONS")
    )
    if worst is not None:
        lines.append(
            f"- worst |trace − che(L)| = {worst['max_abs_err']:.4f} "
            f"(capacity {worst['capacity_bytes']} B, mode {worst['mode']})"
        )
    residual = [r for r in payload["runs"] if r.get("residual_share") is not None]
    if residual:
        # The sharded mode_ordered runs price each shard's whole trace, but
        # its leftovers run in the residual pass on every rank, not in the
        # shard's plan.
        lines.append("\n## Sharded traces the shard plans do not run (leftovers)\n")
        for r in residual:
            per_mode = "; ".join(
                f"mode {m}: max {max(shares):.4f}, mean {sum(shares) / len(shares):.4f}"
                for m, shares in enumerate(r["residual_share"])
            )
            lines.append(f"- {r['tensor']} × {r['impl']}: share of a shard's trace, {per_mode}")
    if payload.get("skipped"):
        lines.append("\n## Skipped cells\n")
        for s in payload["skipped"]:
            lines.append(f"- {s['tensor']} × {s['impl']}: {s['reason']}")
    return "\n".join(lines)


def reorder_report_md(payload: dict) -> str:
    """Human-readable report for a ``BENCH_reorder.json`` payload
    (repro_torch.reorder.bench, DESIGN.md §10): per-(tensor, strategy, stack)
    pricing with hit-rate/energy deltas vs the lex baseline, plus the
    acceptance-gate verdict."""
    lines: list[str] = []
    lines.append("## Ordering sweep (executed-trace pricing per strategy)\n")
    cols = [
        "tensor",
        "strategy",
        "stack",
        "mean_hit_rate",
        "d_hit_vs_lex",
        "bank_conflict_rate",
        "d_conflicts_vs_lex",
        "seconds",
        "speedup_vs_lex",
        "energy_j",
        "d_energy_vs_lex",
    ]
    lines.append(sweep_table_md(payload["runs"], columns=cols))

    acc = payload["acceptance"]
    lines.append(
        f"\n## Acceptance (non-lex beats lex on {' and '.join(acc['stacks'])})\n"
    )
    for name, rec in acc["tensors"].items():
        verdict = ", ".join(rec["winners"]) if rec["winners"] else "NONE"
        lines.append(f"- {name}: winning strategies: {verdict}")
    lines.append(f"- overall: {'OK' if acc['ok'] else 'FAIL'}")
    return "\n".join(lines)


def controller_report_md(payload: dict) -> str:
    """Human-readable report for a ``BENCH_controller.json`` payload
    (scripts/run_controller.py, DESIGN.md §14): the calibration
    reconciliation cells, the paper bands under the cycle model, the
    bank-conflicts-by-ordering table, and the policy x prefetch sweep."""
    cfg = payload["config"]
    lines: list[str] = []
    lines.append(
        f"## Cycle-level controller vs analytic hierarchy "
        f"(tol {cfg['recon_tol']})\n"
    )
    recon_cols = [
        "workload",
        "tech",
        "analytic_seconds",
        "controller_seconds",
        "rel_err",
        "ok",
    ]
    lines.append(sweep_table_md(payload["reconciliation"], columns=recon_cols))

    lines.append(
        f"\n## Paper bands under the paper controller "
        f"{cfg['paper_controller']}\n"
    )
    band_cols = ["workload", "scale", "speedup", "energy_savings", "in_band"]
    lines.append(sweep_table_md(payload["paper_bands"], columns=band_cols))

    lines.append("\n## Structural bank conflicts by nonzero ordering\n")
    conflict_cols = ["ordering", "n_requests", "n_conflicts", "conflict_rate"]
    lines.append(sweep_table_md(payload["bank_conflicts"], columns=conflict_cols))

    lines.append("\n## Controller sweep (policy x prefetch, cycle-priced)\n")
    sweep_cols = ["config", "tensor", "time_s", "energy_j", "bottlenecks"]
    lines.append(sweep_table_md(payload["controller_sweep"], columns=sweep_cols))
    return "\n".join(lines)


def dryrun_summary_md(cells: list[dict]) -> str:
    ok = [c for c in cells if c.get("status") == "ok"]
    skip = [c for c in cells if c.get("status") == "skip"]
    err = [c for c in cells if c.get("status") == "error"]
    lines = [
        f"- cells compiled OK: **{len(ok)}** (both meshes); skipped: {len(skip)} "
        f"(documented long_500k inapplicability); errors: {len(err)}",
    ]
    for mesh in ("16x16", "2x16x16"):
        sub = [c for c in ok if c["mesh"] == mesh]
        if not sub:
            continue
        worst = max(sub, key=lambda c: c["roofline"]["hbm_gb_per_chip"])
        lines.append(
            f"- {mesh}: {len(sub)} cells; max HBM/chip "
            f"{worst['roofline']['hbm_gb_per_chip']:.1f}GB "
            f"({worst['arch']} x {worst['shape']})"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    cells = load_cells(d)
    print(dryrun_summary_md(cells))
    print()
    print("## single-pod (16x16)")
    print(roofline_table_md(cells, "16x16"))
    print()
    print("## multi-pod (2x16x16)")
    print(roofline_table_md(cells, "2x16x16"))
