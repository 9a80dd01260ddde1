"""The port's experiment engine (``repro_torch.experiments``) against the JAX package's.

Traces are held array-equal (``ref`` against JAX's ``ref``, ``kernel``
against JAX's ``pallas``), hit rates and cache statistics equal, and the
engine's pricing, Che modeling and hit-rate reconciliation equal to the
reference's at ``rel 1e-12`` (both are numpy).  Fits start from the JAX
package's ``cp_init`` draws (the port's own draws use a
``torch.Generator``) and run fixed budgets; they must agree within
``FUSED_FIT_TOL``.  Everything runs on ``device="cpu"``.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import sparse_tensor as jst
from repro.core.cp_als import cp_init as j_cp_init
from repro.core.hierarchy import CacheGeometry as JGeometry
from repro.data import synthetic_tensors as jsyn
from repro.experiments import ExperimentSpec as JSpec, run_experiments as j_run
from repro.experiments import measure as jmeas
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import sparse_tensor as tst
from repro_torch.core.hierarchy import CacheGeometry
from repro_torch.data import synthetic_tensors as tsyn
from repro_torch.experiments import (
    CHE_VS_TRACE_TOL,
    ExecutedTraceHitRates,
    ExperimentSpec,
    measure_cp_als,
    run_experiments,
)
from repro_torch.experiments import __main__ as tmain
from repro_torch.experiments import engine as tengine
from repro_torch.experiments import measure as tmeas
from repro_torch.reorder import ORDERINGS

FPGA = dict(capacity_bytes=786432, line_bytes=64, associativity=4)
PSRAM = dict(capacity_bytes=54 * 2**20, line_bytes=64, associativity=8)
VMEM = dict(capacity_bytes=128 * 2**20, line_bytes=None, associativity=None)
GEOMETRIES = {"fpga": FPGA, "psram": PSRAM, "vmem": VMEM}
REL = 1e-12
TINY = (("NELL-2", 1e-4),)


def _jax_draws(tensor, rank, *, seed=0, device="cpu", **_):
    """The JAX package's cp_init draws for the port's tensor, as tensors."""
    jt = jst.SparseTensor(tensor.indices, tensor.values, tensor.shape)
    return [torch.from_numpy(np.array(f)).to(device) for f in j_cp_init(jt, rank, seed=seed)]


def _pair(shape=(60, 45, 30), nnz=900, seed=3, **kw):
    return (tst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
            jst.random_sparse_tensor(shape, nnz, seed=seed, **kw))


def test_experiment_scales_and_scaled_characteristics_match():
    assert tsyn.EXPERIMENT_SCALES == jsyn.EXPERIMENT_SCALES
    for name, scale in tsyn.EXPERIMENT_SCALES.items():
        t = tsyn.make_frostt_like(name, scale=scale / 20, seed=0)
        j = jsyn.make_frostt_like(name, scale=scale / 20, seed=0)
        got = tsyn.scaled_characteristics(name, t, scale=scale / 20)
        want = jsyn.scaled_characteristics(name, j, scale=scale / 20)
        assert (got.name, got.dims, got.nnz, got.density, got.zipf_alpha) == (
            want.name, want.dims, want.nnz, want.density, want.zipf_alpha)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_executed_row_trace_matches(ordering):
    t, j = _pair(zipf_a=0.9)
    for mode in range(t.nmodes):
        plan = tst.build_mttkrp_plan(t, mode, tile_nnz=32, rows_per_block=16,
                                     ordering=ordering, device="cpu")
        jplan = jst.build_mttkrp_plan(j, mode, tile_nnz=32, rows_per_block=16,
                                      ordering=ordering)
        for k in range(t.nmodes):
            for pad in (True, False):
                np.testing.assert_array_equal(
                    plan.executed_row_trace(k, include_padding=pad),
                    jplan.executed_row_trace(k, include_padding=pad))
    with pytest.raises(ValueError, match="out of range"):
        plan.executed_row_trace(3)


@pytest.mark.parametrize("ordering", (None,) + ORDERINGS)
@pytest.mark.parametrize("impl,jimpl", [("ref", "ref"), ("kernel", "pallas")])
def test_executed_input_traces_match(impl, jimpl, ordering):
    t, j = _pair(shape=(70, 300, 200), nnz=2500, seed=4, zipf_a=1.0)
    for mode in range(t.nmodes):
        got = tmeas.executed_input_traces(t, impl, mode, tile_nnz=64, rows_per_block=32,
                                          ordering=ordering, device="cpu")
        want = jmeas.executed_input_traces(j, jimpl, mode, tile_nnz=64, rows_per_block=32,
                                           ordering=ordering)
        assert sorted(got) == sorted(want)
        for k in got:
            assert len(got[k]) == len(want[k]) == 1
            np.testing.assert_array_equal(got[k][0], want[k][0])
        (one,) = tmeas.executed_traces(t, impl, mode, (mode + 1) % 3, tile_nnz=64,
                                       rows_per_block=32, ordering=ordering, device="cpu")
        np.testing.assert_array_equal(one, want[(mode + 1) % 3][0])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("impl,jimpl", [("ref", "ref"), ("kernel", "pallas")])
def test_executed_trace_hit_rates_and_stats_match(impl, jimpl, geometry):
    t = tsyn.make_frostt_like("NELL-2", scale=1e-4, seed=0)
    j = jsyn.make_frostt_like("NELL-2", scale=1e-4, seed=0)
    chars = tsyn.scaled_characteristics("NELL-2", t, scale=1e-4)
    jchars = jsyn.scaled_characteristics("NELL-2", j, scale=1e-4)
    cache = ExecutedTraceHitRates(t, impl, device="cpu")
    jcache = jmeas.ExecutedTraceHitRates(j, jimpl)
    geom, jgeom = CacheGeometry(**GEOMETRIES[geometry]), JGeometry(**GEOMETRIES[geometry])
    for _ in range(2):  # the second round answers from the memo
        for mode in range(t.nmodes):
            assert cache.get(chars, mode, geom, 16) == jcache.get(jchars, mode, jgeom, 16)
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses)
    assert sorted(cache.stats) == sorted(jcache.stats)
    for key, stats in cache.stats.items():
        assert [(s.accesses, s.hits, s.cold_misses) for s in stats] == [
            (s.accesses, s.hits, s.cold_misses) for s in jcache.stats[key]]
    assert list(cache._input_traces) == [0, 1, 2]  # one linearization per mode
    assert cache.simulate_s > 0 and cache.capture_s > 0
    with pytest.raises(ValueError, match="do not describe"):
        cache.get(tsyn.scaled_characteristics("NELL-2", _pair()[0], scale=1.0), 0, geom, 16)
    with pytest.raises(ValueError, match="one executed run"):
        cache.get(chars, 0, geom, 16, ordering="degree")


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_mode_cost_analysis_is_the_closed_form(impl):
    t, _ = _pair()
    for mode in range(t.nmodes):
        flops, nbytes = tmeas.mode_cost_analysis(t, 16, mode, impl, tile_nnz=32,
                                                 rows_per_block=16, device="cpu")
        assert flops == 2 * 3 * t.nnz * 16
        factors = sum(t.shape[k] * 16 * 4 for k in range(3) if k != mode)
        out = t.shape[mode] * 16 * 4
        if impl == "ref":
            assert nbytes == t.nnz * 16 + factors + out
        else:
            plan = tst.build_mttkrp_plan(t, mode, tile_nnz=32, rows_per_block=16)
            assert nbytes == plan.nnz_pad * 16 + (plan.num_blocks + 1) * 8 + factors + out


@pytest.mark.parametrize("ordering", [None, "blocked"])
@pytest.mark.parametrize("impl,jimpl", [("ref", "ref"), ("kernel", "pallas")])
def test_measure_cp_als_fits_match_jax(monkeypatch, impl, jimpl, ordering):
    t = tsyn.make_frostt_like("NELL-2", scale=5e-5, seed=1)
    j = jsyn.make_frostt_like("NELL-2", scale=5e-5, seed=1)
    monkeypatch.setattr(tmeas, "cp_init", _jax_draws)
    got = measure_cp_als(t, name="tiny", impl=impl, n_iters=2, ordering=ordering,
                         fused=True, device="cpu")
    want = jmeas.measure_cp_als(j, name="tiny", impl=jimpl, n_iters=2, ordering=ordering,
                                cost_analysis=False)
    assert abs(got.fit - want.fit) <= tfused.FUSED_FIT_TOL
    assert got.fused_max_fit_delta <= tfused.FUSED_FIT_TOL
    assert abs(got.fused_fit - got.fit) <= tfused.FUSED_FIT_TOL
    assert got.fused_warm_wall_s > 0 and got.fused_wall_s > 0
    assert got.iters == want.iters == 2
    for m in got.modes:
        assert m.calls == 2 and m.steady_s > 0 and m.steady_device_s is None
        assert m.flops == m.paper_flops == 2 * 3 * t.nnz * 16
    assert tmeas.MeasuredRun.from_dict(json.loads(json.dumps(got.to_dict()))) == got


def test_measure_cp_als_first_call_hook_sees_each_mode_once():
    t, _ = _pair()
    seen = []
    measure_cp_als(t, name="tiny", impl="kernel", n_iters=3, device="cpu",
                   cost_analysis=False,
                   first_call_hook=lambda m, f, out: seen.append((m, tuple(out.shape))))
    assert seen == [(m, (t.shape[m], 16)) for m in range(3)]


def test_first_call_hook_time_is_left_out_of_the_walls(monkeypatch):
    """A clock that moves only inside the hook: the eager wall and the
    engine's host_s["measure"] read zero, however long the check takes."""
    clock = [0.0]
    fake = types.SimpleNamespace(perf_counter=lambda: clock[0])
    monkeypatch.setattr(tmeas, "time", fake)
    monkeypatch.setattr(tengine, "time", fake)

    def slow_hook(*_):
        clock[0] += 100.0

    t, _ = _pair()
    run = measure_cp_als(t, name="tiny", impl="kernel", n_iters=2, device="cpu",
                         cost_analysis=False, first_call_hook=lambda m, f, out: slow_hook())
    assert run.wall_s == 0.0 and clock[0] == 300.0
    got = run_experiments(ExperimentSpec(tensors=TINY, impls=("kernel",), n_iters=2,
                                         fused=False, device="cpu"),
                          first_call_hook=lambda *a: slow_hook())
    assert clock[0] == 600.0
    assert got.runs[0].measured.wall_s == 0.0 and got.runs[0].host_s["measure"] == 0.0


@pytest.fixture(scope="module")
def engine_pair():
    """The smallest engine run on both sides, from the same initial factors."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmeas, "cp_init", _jax_draws)
        got = run_experiments(ExperimentSpec(tensors=TINY, impls=("ref", "kernel"),
                                             n_iters=2, device="cpu"))
    want = j_run(JSpec(tensors=TINY, impls=("ref", "pallas"), n_iters=2, cost_analysis=False))
    return got, want


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0)


def test_engine_pricing_matches_jax(engine_pair):
    got, want = engine_pair
    assert [r.key for r in got.runs] == ["NELL-2@0.0001/ref", "NELL-2@0.0001/kernel"]
    assert [r.key.replace("pallas", "kernel") for r in want.runs] == [r.key for r in got.runs]
    for r, jr in zip(got.runs, want.runs):
        assert (r.tensor, r.dims, r.nnz) == (jr.tensor, jr.dims, jr.nnz)
        assert [t.tech for t in r.techs] == [t.tech for t in jr.techs]
        for t, jt in zip(r.techs, jr.techs):
            _close(t.priced_mode_s, jt.priced_mode_s)
            _close(t.modeled_mode_s, jt.modeled_mode_s)
            assert (t.priced_energy_j is None) == (jt.priced_energy_j is None)
            if t.priced_energy_j is not None:
                _close(t.priced_energy_j, jt.priced_energy_j)
                _close(t.modeled_energy_j, jt.modeled_energy_j)
            assert abs(sum(t.share_residuals)) < 1e-9
    for key, jkey in zip(got.speedup_table(), want.speedup_table()):
        _close(got.speedup_table()[key]["priced"], want.speedup_table()[jkey]["priced"])
        _close(got.speedup_table()[key]["modeled"], want.speedup_table()[jkey]["modeled"])
        _close(got.energy_table()[key]["priced"], want.energy_table()[jkey]["priced"])
        _close(got.energy_table()[key]["modeled"], want.energy_table()[jkey]["modeled"])


def test_engine_hit_rate_reconciliation_matches_jax(engine_pair):
    got, want = engine_pair
    assert got.all_within_tol and want.all_within_tol
    for r, jr in zip(got.runs, want.runs):
        assert len(r.hit_rates) == len(jr.hit_rates) == 9  # 3 geometries x 3 modes
        for h, jh in zip(r.hit_rates, jr.hit_rates):
            assert (h.capacity_bytes, h.line_bytes, h.associativity, h.mode) == (
                jh.capacity_bytes, jh.line_bytes, jh.associativity, jh.mode)
            assert h.trace_length == jh.trace_length
            assert (h.trace, h.trace_warm) == (jh.trace, jh.trace_warm)
            _close(h.che_transient, jh.che_transient)
            _close(h.che_steady, jh.che_steady)
            _close(h.max_abs_err, jh.max_abs_err)
            assert h.within_tol and h.max_abs_err <= CHE_VS_TRACE_TOL


def test_engine_fits_match_jax(engine_pair):
    got, want = engine_pair
    for r, jr in zip(got.runs, want.runs):
        assert abs(r.measured.fit - jr.measured.fit) <= tfused.FUSED_FIT_TOL
        assert abs(r.measured.fused_fit - jr.measured.fused_fit) <= tfused.FUSED_FIT_TOL
        assert r.measured.fused_max_fit_delta <= tfused.FUSED_FIT_TOL
        assert all(m.calls == 2 for m in r.measured.modes)
    assert set(got.fused_table()) == {r.key for r in got.runs}
    assert set(got.runs[0].host_s) == {"measure", "capture", "simulate", "price", "reconcile"}


def test_engine_payload_round_trips(engine_pair):
    got, _ = engine_pair
    payload = json.loads(json.dumps(got.to_json_dict()))
    assert payload["spec"]["impls"] == ["ref", "kernel"] and payload["spec"]["device"] == "cpu"
    assert payload["che_tolerance"] == CHE_VS_TRACE_TOL and payload["skipped"] == []
    assert payload["runs"][1]["measured"]["modes"][0]["flops"] == 2 * 3 * got.runs[0].nnz * 16


def test_sharded_and_autotune_are_refused_with_their_items():
    t, _ = _pair()
    with pytest.raises(NotImplementedError, match="item 8"):
        ExperimentSpec(impls=("ref", "sharded"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        measure_cp_als(t, name="x", impl="sharded", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        tmeas.executed_input_traces(t, "sharded", 0, device="cpu")
    with pytest.raises(SystemExit, match="item 8"):
        tmain.main(["--impls", "ref,sharded", "--device", "cpu"])
    with pytest.raises(SystemExit, match="item 6"):
        tmain.main(["--autotune", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device"):
        tmain.main(["--backend", "xla", "--device", "cpu"])
    with pytest.raises(TypeError):
        ExperimentSpec(autotune=True)  # no such field: nothing is silently ignored


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, _ = _pair()
    assert ExperimentSpec().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        measure_cp_als(t, name="x")
    with pytest.raises(RuntimeError, match="cuda"):
        run_experiments(ExperimentSpec(tensors=TINY))


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert tmain.main(["--device", "cpu", "--tensors", "NELL-2@5e-5", "--impls", "kernel",
                       "--iters", "2", "--no-fused", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert [r["impl"] for r in payload["runs"]] == ["kernel"]
    assert payload["all_within_tol"] and "ALL WITHIN TOLERANCE" in capsys.readouterr().out


def test_cli_default_out_names_no_committed_artifact(tmp_path, monkeypatch):
    """Run from a directory with no --out, the CLI writes a file of its own
    name, which git ignores; the JAX package's BENCH_*.json are left alone."""
    repo = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["--device", "cpu", "--tensors", "NELL-2@5e-5", "--impls", "kernel",
                       "--iters", "2", "--no-fused"]) == 0
    assert (tmp_path / tmain.DEFAULT_OUT).is_file()
    ignored = {line.strip().lstrip("/")
               for line in (repo / ".gitignore").read_text().splitlines()}
    assert tmain.DEFAULT_OUT in ignored
    assert tmain.DEFAULT_OUT not in {p.name for p in repo.glob("BENCH_*.json")} - ignored


def test_generator_coalesces_volumes_beyond_int64():
    """LBNL at Table II size has a volume of 3.9e19, beyond the raveled keys
    the JAX package coalesces by: the port sorts coordinate rows there,
    which keeps the same order and first draws wherever both work."""
    rng = np.random.default_rng(0)
    for shape in [(5, 7, 3), (40, 30, 20, 10)]:
        idx = np.stack([rng.integers(0, d, size=600) for d in shape], axis=1)
        np.testing.assert_array_equal(tst.first_occurrences(idx, shape),
                                      np.unique(idx, axis=0, return_index=True)[1])
    huge = (1 << 20,) * 4
    t = tst.random_sparse_tensor(huge, 3000, seed=1, zipf_a=1.2)
    coords = [tuple(r) for r in t.indices.tolist()]
    assert len(set(coords)) == t.nnz and coords == sorted(coords)
    assert t.nnz < 3000  # the Zipf draws repeat and were coalesced
    for scale in (1e-4, 2e-2):  # the raveled path, array-equal to the reference
        np.testing.assert_array_equal(tsyn.make_frostt_like("LBNL", scale=scale).indices,
                                      jsyn.make_frostt_like("LBNL", scale=scale).indices)
