"""Tests for repro_torch.analysis, the port's contract gate, on the CPU.

Each port checker gets a violating fixture and a clean twin under
``tests/torch_analysis_fixtures/`` (laid out as a miniature repo, so that
the path-scoped checkers fire; the replay fixtures plant faults in the
split kernel's replay).  The repo's port must be finding-clean, the kernel
contract facts must cover every ordering x N in {3, 4, 5} x B in {1, 4},
and the generic checkers and the traffic census must agree with the JAX
package's on the same inputs.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import run_analysis as jax_run_analysis
from repro.analysis.core import SUPPRESS_RE as JAX_SUPPRESS_RE
from repro.analysis.core import SourceFile as JaxSourceFile
from repro.core.hierarchy import analytic_traffic_census as jax_census
from repro_torch.analysis import __main__ as gate
from repro_torch.analysis import replay
from repro_torch.analysis.census import audit_failures, census_drift, model_census
from repro_torch.analysis.core import (
    DEFAULT_SCAN,
    SCHEMA,
    SUPPRESS_RE,
    Finding,
    SourceFile,
    default_checkers,
    is_fixture_path,
    run_analysis,
)
from repro_torch.core.hierarchy import analytic_traffic_census
from repro_torch.core.sparse_tensor import build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp import partition

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "torch_analysis_fixtures"
JAX_FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
KERNEL_CHECKS = ["kernel-contract", "carry-init", "traffic-model-drift"]


def fixture_report(checks, *relpaths, root=FIXTURES):
    files = [SourceFile(root / p, root) for p in relpaths]
    return run_analysis(root, checks=[checks] if isinstance(checks, str) else checks, files=files)


def messages(report) -> str:
    return "\n".join(f.message for f in report.findings)


@pytest.fixture(scope="module")
def repo_report():
    return run_analysis(REPO)


@pytest.fixture
def small_suite(monkeypatch):
    """The replay suite cut to N = 3, two orderings and one partition edge,
    for the fixture runs (each replays the suite once)."""
    monkeypatch.setattr(replay, "REPLAY_NMODES", (3,))
    monkeypatch.setattr(replay, "ORDERINGS", ("lex", "blocked"))
    edges = replay._edge_tensors

    def one_edge():
        return {"fewer nonzeros than slices": edges()["fewer nonzeros than slices"]}

    monkeypatch.setattr(replay, "_edge_tensors", one_edge)


def replay_report(fixture: str):
    return fixture_report(KERNEL_CHECKS, replay.PARTITION_PATH, root=FIXTURES / fixture)


# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------


def test_registry_has_the_port_checkers():
    assert default_checkers() == [
        "carry-init", "docs-citation", "kernel-contract", "kwarg-threading",
        "memo-key-completeness", "shared-state-safety", "stale-suppression",
        "traffic-model-drift",
    ]


def test_marker_and_schema_are_the_ports_own():
    assert SCHEMA == "repro_torch.analysis/v1"
    port, jax_marker = "# repro_torch: ignore[kwarg-threading]", "# repro: ignore[kwarg-threading]"
    assert SUPPRESS_RE.search(port) and not SUPPRESS_RE.search(jax_marker)
    assert JAX_SUPPRESS_RE.search(jax_marker) and not JAX_SUPPRESS_RE.search(port)


def test_default_scan_is_the_port_and_fixtures_are_waived():
    assert DEFAULT_SCAN == ("src/repro_torch/**/*.py", "tests/test_torch_*.py", "chip_smoke.py")
    assert is_fixture_path("tests/torch_analysis_fixtures/src/repro_torch/fx_kwarg_bad.py")
    assert not is_fixture_path("tests/test_torch_analysis.py")


def test_fingerprint_is_line_independent():
    a, b = Finding("c", "p.py", 10, "msg"), Finding("c", "p.py", 99, "msg")
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != Finding("c", "p.py", 10, "other").fingerprint


def test_unknown_check_id_rejected():
    with pytest.raises(ValueError, match="unknown check ids"):
        run_analysis(FIXTURES, checks=["no-such-check"], files=[])


def test_suppression_waives_but_still_reports():
    report = fixture_report(["kwarg-threading", "stale-suppression"],
                            "src/repro_torch/fx_suppressed.py")
    assert len(report.findings) == 1 and report.findings[0].suppressed
    assert report.active == []


# ---------------------------------------------------------------------------
# a violating fixture and a clean twin per checker
# ---------------------------------------------------------------------------

# check id -> (violating fixture, clean twin, phrases of the findings, finding count)
GENERIC = {
    "memo-key-completeness": ("src/repro_torch/fx_memo_bad.py", "src/repro_torch/fx_memo_good.py",
                              ["KEY_FIELDS omits field 'line_bytes'", "compare=False",
                               "never uses it", "asymmetric keys never hit"], 6),
    "kwarg-threading": ("src/repro_torch/fx_kwarg_bad.py", "src/repro_torch/fx_kwarg_good.py",
                        ["'wrapper' accepts 'device'", "does not forward it"], 1),
    "shared-state-safety": ("src/repro_torch/serve/fx_shared_bad.py",
                            "src/repro_torch/serve/fx_shared_good.py",
                            ["'_RESULTS' mutated at request time (item assignment)",
                             "'_LOG' mutated at request time (.append())"], 2),
    "docs-citation": ("src/repro_torch/fx_docs_bad.py", "src/repro_torch/fx_docs_good.py",
                      ["§42 cited but DESIGN" ".md has no matching heading"], 1),
    "stale-suppression": ("src/repro_torch/fx_stale.py", "src/repro_torch/fx_suppressed.py",
                          ["matched no finding this run"], 1),
}


@pytest.mark.parametrize("check", list(GENERIC))
def test_generic_checker_fixture_pair(check):
    bad, good, phrases, count = GENERIC[check]
    checks = [check] if check != "stale-suppression" else ["kwarg-threading", check]
    report = fixture_report(checks, bad)
    assert len(report.active) == count, messages(report)
    for phrase in phrases:
        assert phrase in messages(report)
    assert fixture_report(checks, good).active == []


def test_kwarg_threading_follows_a_resolved_device():
    report = fixture_report("kwarg-threading", "src/repro_torch/fx_kwarg_good.py")
    # resolve_device, inner, the three wrappers and Holder.__init__
    assert report.facts["kwarg-threading"]["wrappers_audited"] == 6
    assert report.findings == []


def test_shared_state_sanctions_the_ports_owners():
    report = fixture_report("shared-state-safety", "src/repro_torch/serve/fx_shared_good.py")
    containers = report.facts["shared-state-safety"]["containers"]
    assert containers == {"repro_torch.serve.fx_shared_good": ["_AXES", "_CACHE", "_TIMES"]}


def test_clean_replay_fixture_passes_every_kernel_check(small_suite):
    report = replay_report("replay_clean")
    assert report.findings == [], messages(report)
    assert report.facts["carry-init"]["carry_reads_proven"]["rows"] > 0
    assert report.facts["traffic-model-drift"]["census_identities_verified"] > 0


def test_replay_storing_a_row_twice_is_caught(small_suite):
    report = replay_report("replay_stores_twice")
    found = [f for f in report.active if f.check_id == "kernel-contract"]
    assert any("stored 1..2 times, not exactly once" in f.message for f in found), messages(report)
    assert {f.path for f in found} == {replay.PARTITION_PATH}


def test_replay_reading_an_unwritten_carry_is_caught(small_suite):
    report = replay_report("replay_carry_unwritten")
    found = [f.message for f in report.active if f.check_id == "carry-init"]
    assert found and all("launch 1 did not write" in m for m in found), messages(report)
    assert not [f for f in report.active if f.check_id == "traffic-model-drift"]


def test_replay_census_drift_is_caught(small_suite):
    report = replay_report("replay_census_drift")
    found = [f.message for f in report.active if f.check_id == "traffic-model-drift"]
    assert any("values: counted" in m and "requires" in m for m in found), messages(report)


# ---------------------------------------------------------------------------
# parity with the JAX package's gate on the same sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check,relpath", [
    ("memo-key-completeness", "src/repro/fx_memo_bad.py"),
    ("memo-key-completeness", "src/repro/fx_memo_good.py"),
    ("kwarg-threading", "src/repro/fx_kwarg_bad.py"),
    ("kwarg-threading", "src/repro/fx_kwarg_good.py"),
])
def test_generic_checkers_agree_with_jax_on_its_fixtures(check, relpath):
    ours = run_analysis(JAX_FIXTURES, checks=[check],
                        files=[SourceFile(JAX_FIXTURES / relpath, JAX_FIXTURES)])
    theirs = jax_run_analysis(JAX_FIXTURES, checks=[check],
                              files=[JaxSourceFile(JAX_FIXTURES / relpath, JAX_FIXTURES)])
    assert [(f.path, f.line) for f in ours.findings] == [(f.path, f.line) for f in theirs.findings]
    # the same field or knob named in each finding
    for a, b in zip(ours.findings, theirs.findings):
        assert a.message.split(";")[0].split(" — ")[0][:40] == \
            b.message.split(";")[0].split(" — ")[0][:40]


def test_shared_state_agrees_with_jax_on_a_moved_fixture(tmp_path):
    src = JAX_FIXTURES / "src/repro/serve/fx_shared_bad.py"
    moved = tmp_path / "src/repro_torch/serve/fx_shared_bad.py"
    moved.parent.mkdir(parents=True)
    shutil.copy(src, moved)
    ours = run_analysis(tmp_path, checks=["shared-state-safety"],
                        files=[SourceFile(moved, tmp_path)])
    theirs = jax_run_analysis(JAX_FIXTURES, checks=["shared-state-safety"],
                              files=[JaxSourceFile(src, JAX_FIXTURES)])
    assert len(theirs.findings) == 2
    assert [f.line for f in ours.findings] == [f.line for f in theirs.findings]
    assert [f.message.split(";")[0] for f in ours.findings] == \
        [f.message.split(";")[0] for f in theirs.findings]


@pytest.mark.parametrize("nmodes", [3, 4, 5])
def test_analytic_traffic_census_matches_jax(nmodes):
    assert analytic_traffic_census(nmodes) == jax_census(nmodes)
    want = jax_census(nmodes)
    assert model_census(nmodes, 300, 30, 4) == {
        "values": want["values_per_nnz"] * 300, "indices": want["indices_per_nnz"] * 300,
        "factor_rows": want["factor_rows_per_nnz"] * 300,
        "output_stores": want["output_rows_amortized"] * 30 * 4}


# ---------------------------------------------------------------------------
# the port dogfoods its gate
# ---------------------------------------------------------------------------


def test_repo_port_is_finding_clean(repo_report):
    assert repo_report.active == [], "\n".join(
        f"{f.location} [{f.check_id}] {f.message}" for f in repo_report.active)
    assert repo_report.suppressed == []
    assert set(repo_report.facts) == set(default_checkers())


def test_kernel_contract_facts_cover_every_cell(repo_report):
    facts = repo_report.facts["kernel-contract"]
    assert facts["cells"] == sorted(f"{o} N={n} B={b}" for o in partition_orderings()
                                    for n in (3, 4, 5) for b in (1, 4))
    assert set(facts["other_plans"]) == {
        "partition edge: hot row", "partition edge: slice boundaries inside padding",
        "partition edge: empty rows between slices", "partition edge: fewer nonzeros than slices",
        "stacked service plan"}
    assert {1, 3, 37}.issubset(facts["slice_counts"]) and max(facts["slice_counts"]) > 300
    kernels = {k["replay"]: k for k in facts["kernels"]}
    for name in ("emulate_split", "emulate_tiles", "cta_rows"):
        assert kernels[name]["out"]["stores"] == [1, 1], kernels[name]
    assert kernels["emulate_split"]["replays"] > 0 and kernels["emulate_tiles"]["replays"] > 0


def partition_orderings():
    from repro_torch.reorder import ORDERINGS

    return ORDERINGS


def test_repo_carry_and_census_facts(repo_report):
    carry = repo_report.facts["carry-init"]
    assert carry["carry_reads_proven"]["rows"] > 0 and carry["carry_reads_proven"]["tiles"] > 0
    drift = repo_report.facts["traffic-model-drift"]
    assert drift["nmodes_checked"] == [3, 4, 5]
    assert drift["census_identities_verified"] > 300
    assert drift["request_streams_verified"] == drift["executed_traces_verified"] == 4 * 12
    assert drift["psum_accesses_per_nnz"]["rows"] == 0.0


def test_cli_writes_the_report_and_exits_by_findings(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert gate.main(["--root", str(REPO), "--checks", "kwarg-threading,docs-citation",
                      "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["schema"] == SCHEMA and report["totals"]["active"] == 0
    assert set(report["facts"]) == {"kwarg-threading", "docs-citation"}
    assert "facts:" in capsys.readouterr().out
    # the fixture root holds violations: the gate fails
    assert gate.main(["--root", str(FIXTURES), "--checks", "kwarg-threading", "-q"]) == 1


# ---------------------------------------------------------------------------
# the replay's counts and the card's
# ---------------------------------------------------------------------------


def test_stream_entries_read_mirrors_the_kernels_steps():
    # one slice of 100 entries: the row-run mode reads whole steps of 32
    # (B = 1) or 16 (B > 1) entries; the tile mode stages [0, 100)
    assert partition.stream_entries_read(100, 1, "rows", 1) == 128
    assert partition.stream_entries_read(100, 1, "rows", 4) == 112
    assert partition.stream_entries_read(100, 1, "tiles") == 100
    # slices [0, 33) [33, 66) [66, 100): aligned to 4 back and forth, cut at 100
    assert partition.stream_entries_read(100, 3, "tiles") == 36 + 36 + 36
    # more slices than entries: the empty ones stage nothing, the three
    # others each [0, 3), aligned back to 0 and cut at the stream's end
    assert partition.stream_entries_read(3, 8, "tiles") == 3 * 3


def test_replay_census_and_carries_on_a_batched_tile_replay():
    t = random_sparse_tensor((40, 30, 20), 500, seed=3)
    plan = build_mttkrp_plan(t, 0, tile_nnz=16, rows_per_block=8, ordering="blocked",
                             device="cpu")
    bufs = tops.plan_device_buffers(plan, "cpu")
    rng = np.random.default_rng(0)
    facs = [torch.from_numpy(rng.standard_normal((5, s, 3)).astype(np.float32)) for s in t.shape]
    r = partition.emulate_tiles(bufs, facs, 0, 40, 37, 2)  # ragged passes: 2, 2, 1
    assert len(r.census) == 5 and r.uninit_reads == r.unmarked_reads == 0 and r.carry_reads > 0
    for got in r.census:
        assert census_drift(got, 3, t.nnz, 40, 3) == []


def test_audit_failures_read_each_contract():
    nnz, i_out, rank = 10, 4, 2
    good = {"store_min": 1, "store_max": 1, "census": [model_census(3, nnz, i_out, rank)],
            "entries_read": 16, "uninit_reads": 0, "nan_left": 0}
    assert audit_failures(good, 3, nnz, i_out, rank) == []
    bad = dict(good, store_max=2, uninit_reads=3, nan_left=1,
               census=[dict(good["census"][0], factor_rows=19)])
    failures = " | ".join(audit_failures(bad, 3, nnz, i_out, rank))
    for phrase in ("stored 1..2 times", "factor_rows: counted 19", "3 reads of a carry",
                   "1 output elements left NaN"):
        assert phrase in failures
