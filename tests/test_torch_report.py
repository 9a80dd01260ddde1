"""The port's ordering benchmark and report formatting against the JAX package's.

``run_reorder_sweep(quick=True)`` must give the reference's payload on the
same tensors (numpy pricing, equal floats; the orders sort on
``device="cpu"``), with its acceptance holding, and every report renderer
of ``repro_torch.perf.report`` must give the reference's string for the
same payload: the committed ``BENCH_*.json`` artifacts and payloads made
here.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro.perf import report as jreport
from repro.reorder import bench as jbench
from repro_torch.perf import report as treport
from repro_torch.reorder import bench as tbench

REPO = Path(__file__).resolve().parents[1]


def _bench(name):
    return json.loads((REPO / f"BENCH_{name}.json").read_text())


@pytest.fixture(scope="module")
def reorder_pair():
    return tbench.run_reorder_sweep(quick=True, device="cpu"), jbench.run_reorder_sweep(quick=True)


def test_reorder_tensors_and_stacks_match():
    assert [t.name for t in tbench.REORDER_STACKS] == [t.name for t in jbench.REORDER_STACKS]
    assert tbench.ACCEPTANCE_STACKS == jbench.ACCEPTANCE_STACKS
    ours, ref = tbench.default_tensors(quick=True), jbench.default_tensors(quick=True)
    assert list(ours) == list(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name].indices, ref[name].indices)
        np.testing.assert_array_equal(ours[name].values, ref[name].values)


def test_reorder_sweep_payload_matches(reorder_pair):
    got, want = reorder_pair
    assert got == want


def test_reorder_sweep_acceptance_holds(reorder_pair):
    got, _ = reorder_pair
    assert got["acceptance"]["ok"]
    for rec in got["acceptance"]["tensors"].values():
        assert rec["winners"]


def test_reorder_report_matches(reorder_pair):
    got, _ = reorder_pair
    assert treport.reorder_report_md(got) == jreport.reorder_report_md(got)
    bench = _bench("reorder")
    assert treport.reorder_report_md(bench) == jreport.reorder_report_md(bench)


def test_experiments_report_matches():
    bench = _bench("experiments")
    assert treport.experiments_report_md(bench) == jreport.experiments_report_md(bench)
    # An ordering column, a failing verdict, a skipped cell and no fused runs.
    edited = json.loads(json.dumps(bench))
    edited["runs"][0]["ordering"] = "degree"
    edited["all_within_tol"] = False
    edited["skipped"] = [{"tensor": "LBNL@0.02", "impl": "pallas", "reason": "a reason"}]
    for r in edited["runs"]:
        r["measured"]["fused_warm_wall_s"] = None
    assert treport.experiments_report_md(edited) == jreport.experiments_report_md(edited)


def test_controller_report_matches():
    bench = _bench("controller")
    assert treport.controller_report_md(bench) == jreport.controller_report_md(bench)


def test_sweep_tables_match():
    rows = [{"config": "a", "time_s": 1.5e-5, "energy_j": None, "ok": True},
            {"config": "b", "time_s": 0.0, "speedup": 12345.6, "ok": False, "n": 3},
            {"config": "c", "time_s": 0.25, "energy_j": 2e-4}]
    for cols in (None, ["config", "time_s", "ok"]):
        assert treport.sweep_table_md(rows, cols) == jreport.sweep_table_md(rows, cols)
    assert treport.sweep_table_md([]) == jreport.sweep_table_md([])
    meta = {"axes": ["frequency"]}
    assert treport.sweep_table_json(rows, meta=meta) == jreport.sweep_table_json(rows, meta=meta)


def test_dryrun_tables_match(tmp_path):
    roof = {"compute_s": 2.5, "memory_s": 3e-3, "collective_s": 4e-7, "dominant": "compute",
            "useful_ratio": 0.5, "mfu_roofline": 0.4, "hbm_gb_per_chip": 12.3}
    cells = [
        {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok", "roofline": roof},
        {"arch": "b", "shape": "s", "mesh": "16x16", "status": "skip"},
        {"arch": "c", "shape": "s", "mesh": "16x16", "status": "error"},
        {"arch": "d", "shape": "t", "mesh": "2x16x16", "status": "ok",
         "roofline": dict(roof, hbm_gb_per_chip=40.0)},
    ]
    for i, c in enumerate(cells):
        (tmp_path / f"{i}.json").write_text(json.dumps(c))
    loaded = treport.load_cells(tmp_path)
    assert loaded == jreport.load_cells(tmp_path) == cells
    for mesh in ("16x16", "2x16x16"):
        assert treport.roofline_table_md(cells, mesh) == jreport.roofline_table_md(cells, mesh)
    assert treport.dryrun_summary_md(cells) == jreport.dryrun_summary_md(cells)
