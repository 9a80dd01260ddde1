"""The port's closed-loop tile autotuner (``repro_torch.dse.autotune``) against
``repro.dse.autotune``, on the CPU.

Where the answer is deterministic the two are held equal: the swept
configs, the band signatures, the winner, timings and covered modes under
one deterministic time function patched into both sides' ``measure_config``,
and ``measured_vs_modeled``'s modeled seconds at ``rel 1e-12`` (both are
numpy).  Fits of the fused executor under a tuner start from the JAX
package's ``cp_init`` draws and must agree within ``FUSED_FIT_TOL``.  A
real ``tune`` on the CPU times the plain version of the split kernel.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import cp_als_fused as jfused
from repro.core import sparse_tensor as jst
from repro.core.cp_als import cp_init as j_cp_init
from repro.dse import autotune as jtune
from repro.experiments import ExperimentSpec as JSpec, run_experiments as j_run
from repro.serve import DecompositionService as JService
from repro.serve.service import DecompRequest as JRequest
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import sparse_tensor as tst
from repro_torch.core.cp_als import cp_init
from repro_torch.dse import autotune as ttune
from repro_torch.dse import (
    DEFAULT_TILE_CONFIG,
    Autotuner,
    TileConfig,
    TuneResult,
    TuneSpace,
    WallTimeMemo,
    measure_config,
    measured_vs_modeled,
)
from repro_torch.experiments import ExperimentSpec, run_experiments
from repro_torch.experiments import __main__ as tmain
from repro_torch.experiments import engine as tengine
from repro_torch.experiments import measure as tmeas
from repro_torch.serve import DecompositionService, geometry_signature
from repro_torch.serve.service import DecompRequest

REL = 1e-12
SMALL_SPACE = dict(tile_nnz=(128,), rows_per_block=(64, 128), orderings=("lex",))
SPACES = [{}, SMALL_SPACE, dict(tile_nnz=(), rows_per_block=()),
          dict(tile_nnz=(64, 256), rows_per_block=(32,), orderings=("lex", "degree", "blocked"))]
TINY = (("NELL-2", 1e-4),)


def _pair(seed=0, nnz=400, shape=(37, 29, 23)):
    return (tst.random_sparse_tensor(shape, nnz, seed=seed),
            jst.random_sparse_tensor(shape, nnz, seed=seed))


def _fake_seconds(tensor, factors, mode, config, **_):
    """A deterministic 'measurement': no config ties the default, and
    (128, 64, lex) wins on every mode."""
    if (config.tile_nnz, config.rows_per_block) == (128, 64):
        return 1e-4 * (1 + mode)
    return 1e-3 * (1 + (config.tile_nnz // 64 + 3 * config.rows_per_block // 64 + mode) % 7)


@pytest.fixture
def same_times(monkeypatch):
    """Both tuners see the same times."""
    monkeypatch.setattr(ttune, "measure_config", _fake_seconds)
    monkeypatch.setattr(jtune, "measure_config", _fake_seconds)


def test_tileconfig_validation_and_label():
    for mod in (ttune, jtune):
        assert mod.TileConfig(128, 64, "lex").label == "(128,64,lex)"
        with pytest.raises(ValueError, match="tile_nnz"):
            mod.TileConfig(0, 64, "lex")
        with pytest.raises(ValueError, match="rows_per_block"):
            mod.TileConfig(128, -1, "lex")
        with pytest.raises(ValueError, match="unknown ordering"):
            mod.TileConfig(128, 64, "zigzag")
    assert dataclasses.astuple(DEFAULT_TILE_CONFIG) == dataclasses.astuple(
        jtune.DEFAULT_TILE_CONFIG) == (256, 256, "lex")
    assert TileConfig(128, 64, "blocked") < TileConfig(128, 256, "lex")  # ordered as JAX's


@pytest.mark.parametrize("space", SPACES, ids=range(len(SPACES)))
def test_tunespace_configs_equal_jax_and_default_first(space):
    got = TuneSpace(**space).configs()
    want = jtune.TuneSpace(**space).configs()
    assert [dataclasses.astuple(c) for c in got] == [dataclasses.astuple(c) for c in want]
    assert got[0] == DEFAULT_TILE_CONFIG and len(got) == len(set(got))
    assert [dataclasses.astuple(c) for c in TuneSpace().configs()] == [
        (256, 256, "lex")] + [(t, r, "lex") for t in (128, 256, 512) for r in (64, 256, 512)
                              if (t, r) != (256, 256)]


def test_walltime_memo_counters_and_reps_key():
    memo = WallTimeMemo()
    sig = geometry_signature((8, 8, 8), 64, 4)
    key = memo.key(sig, 0, DEFAULT_TILE_CONFIG, "cpu", 1)
    assert key == (sig, 0, DEFAULT_TILE_CONFIG, "cpu", 1)
    assert memo.lookup(key) is None
    assert (memo.hits, memo.misses) == (0, 1)
    memo.store(key, 0.5)
    assert memo.lookup(key) == 0.5
    assert (memo.hits, memo.misses, len(memo)) == (1, 1, 1)
    # A reps=20 request never gets a reps=1 median back.
    assert memo.lookup(memo.key(sig, 0, DEFAULT_TILE_CONFIG, "cpu", 20)) is None
    assert memo.lookup(memo.key(sig, 0, DEFAULT_TILE_CONFIG, "cuda", 1)) is None


def test_signature_of_matches_jax():
    for seed, nnz, shape in [(0, 400, (37, 29, 23)), (1, 3000, (100, 50, 30, 7)),
                             (2, 65, (9, 9, 1000))]:
        t, j = _pair(seed, nnz, shape)
        for rank in (1, 8, 16, 33):
            assert dataclasses.astuple(Autotuner.signature_of(t, rank)) == dataclasses.astuple(
                jtune.Autotuner.signature_of(j, rank))


def test_measure_config_times_the_plain_version_on_cpu():
    t, _ = _pair()
    facs = cp_init(t, 8, seed=0, device="cpu")
    for cfg in (DEFAULT_TILE_CONFIG, TileConfig(128, 64, "degree")):
        assert measure_config(t, facs, 0, cfg, reps=1) > 0.0


def test_tune_matches_jax_under_the_same_times(same_times):
    t, j = _pair()
    tuner = Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu")
    jtuner = jtune.Autotuner(jtune.TuneSpace(**SMALL_SPACE), reps=1)
    result, want = tuner.tune(t, 8), jtuner.tune(j, 8)
    assert dataclasses.astuple(result.best) == dataclasses.astuple(want.best) == (128, 64, "lex")
    assert {c.label: s for c, s in result.timings.items()} == {
        c.label: s for c, s in want.timings.items()}
    assert result.modes == want.modes == (0, 1, 2)
    assert result.device == "cpu" and result.speedup_vs_default >= 1.0
    d, jd = result.to_dict(), want.to_dict()
    assert set(d) == set(jd) and d["backend"] == "cpu"
    assert {k: v for k, v in d.items() if k != "backend"} == {
        k: v for k, v in jd.items() if k != "backend"}

    # Same band: the cached result, no new measurements.
    misses = tuner.memo.misses
    assert tuner.tune(t, 8) is result and tuner.memo.misses == misses
    assert tuner.config_for(t, 8) == result.best and tuner.memo.misses == misses
    # force=True bypasses both caches and re-stores the same cells.
    hits, cells = tuner.memo.hits, len(tuner.memo)
    forced = tuner.tune(t, 8, force=True)
    assert forced is not result and tuner.memo.hits == hits and len(tuner.memo) == cells
    # A tensor in the same band is answered from the cache.
    t2, _ = _pair(seed=5, nnz=410)
    assert tuner.signature_of(t2, 8) == result.signature
    assert tuner.tune(t2, 8) is forced
    assert (tuner.memo.hits, tuner.memo.misses, len(tuner.memo)) == (
        jtuner.memo.hits, jtuner.memo.misses, len(jtuner.memo)) == (0, 9, 9)


def test_tune_ties_go_to_the_default(monkeypatch):
    for mod in (ttune, jtune):
        monkeypatch.setattr(mod, "measure_config", lambda *a, **k: 1e-3)
    t, j = _pair()
    got = Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu").tune(t, 8)
    want = jtune.Autotuner(jtune.TuneSpace(**SMALL_SPACE), reps=1).tune(j, 8)
    assert got.best == DEFAULT_TILE_CONFIG and want.best == jtune.DEFAULT_TILE_CONFIG
    assert got.speedup_vs_default == 1.0


def test_tune_partial_modes_never_enters_band_cache(same_times):
    t, j = _pair()
    for tuner, tensor in ((Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu"), t),
                          (jtune.Autotuner(jtune.TuneSpace(**SMALL_SPACE), reps=1), j)):
        partial = tuner.tune(tensor, 8, modes=(0,))
        assert partial.modes == (0,) and tuner.results == {}
        assert dataclasses.astuple(tuner.config_for(tensor, 8)) == (256, 256, "lex")
        misses = tuner.memo.misses
        full = tuner.tune(tensor, 8)
        assert full.modes == (0, 1, 2) and tuner.results[full.signature] is full
        assert tuner.memo.misses - misses == 6  # modes 1 and 2 of 3 configs
        assert "modes" in full.to_dict()


def test_config_for_answers_cheaply_on_miss_and_tunes_on_request():
    t, _ = _pair()
    tuner = Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu")
    assert tuner.config_for(t, 8) == DEFAULT_TILE_CONFIG and len(tuner.memo) == 0
    best = tuner.tune(t, 8).best
    assert tuner.config_for(t, 8) == best
    eager = Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu", tune_on_miss=True)
    cfg = eager.config_for(t, 8)
    assert eager.results and cfg == next(iter(eager.results.values())).best


def test_real_tune_on_cpu_positive_times_and_memo_hits():
    t, _ = _pair()
    tuner = Autotuner(TuneSpace(**SMALL_SPACE), reps=2, device="cpu")
    result = tuner.tune(t, 8)
    assert set(result.timings) == set(TuneSpace(**SMALL_SPACE).configs())
    assert all(s > 0 for s in result.timings.values())
    assert result.best_s == min(result.timings.values()) <= result.default_s
    # A second band (rank 16) re-measures; a repeat of the first does not.
    misses = tuner.memo.misses
    again = Autotuner(TuneSpace(**SMALL_SPACE), reps=2, device="cpu", memo=tuner.memo)
    assert again.tune(t, 8).timings == result.timings
    assert tuner.memo.misses == misses and tuner.memo.hits == 9


def test_tuner_rejects_unknown_device():
    with pytest.raises(ValueError, match="device='hexagon'"):
        Autotuner(TuneSpace(**SMALL_SPACE), device="hexagon")
    with pytest.raises(ValueError, match="backend='hexagon'"):
        jtune.Autotuner(jtune.TuneSpace(**SMALL_SPACE), backend="hexagon")


def test_tuner_names_a_config_the_kernel_refuses(monkeypatch):
    def refuse(tensor, factors, mode, config, **_):
        if config.rows_per_block == 128:
            raise ValueError("no grid")
        return 1e-3

    monkeypatch.setattr(ttune, "measure_config", refuse)
    t, _ = _pair()
    with pytest.raises(ValueError, match=r"\(128,128,lex\), mode 0.*no grid"):
        Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu").tune(t, 8)


def test_geometry_signature_tile_align_matches_jax():
    from repro.serve import geometry_signature as jsig

    for align in (None, 256, 384, 1000):
        got = geometry_signature((100, 50, 30), 1000, 16, tile_align=align)
        assert dataclasses.astuple(got) == dataclasses.astuple(
            jsig((100, 50, 30), 1000, 16, tile_align=align))
        if align:
            assert got.nnz_pad % align == 0
    with pytest.raises(ValueError, match="tile_align"):
        geometry_signature((100, 50, 30), 1000, 16, tile_align=0)


def test_serve_buckets_align_to_tuned_tile_as_jax():
    class StubTuner:
        def config_for(self, tensor, rank):
            return TileConfig(tile_nnz=384, rows_per_block=64)

    t, j = _pair(nnz=1000)
    plain = DecompositionService(device="cpu").signature_fn(DecompRequest("r0", t, rank=8,
                                                                          n_iters=2))
    tuned = DecompositionService(autotuner=StubTuner(), device="cpu").signature_fn(
        DecompRequest("r0", t, rank=8, n_iters=2))
    jtuned = JService(autotuner=StubTuner()).signature_fn(JRequest("r0", j, rank=8, n_iters=2))
    assert plain.nnz_pad % 384 != 0 and tuned.nnz_pad % 384 == 0
    assert dataclasses.astuple(tuned) == dataclasses.astuple(jtuned)


def _results(t, j):
    """One tune result per side with the same timings over two orderings."""
    cfgs = [(256, 256, "lex"), (128, 64, "lex"), (256, 256, "degree")]
    timings = dict(zip(cfgs, (2e-3, 1e-3, 3e-3)))
    got = TuneResult(signature=Autotuner.signature_of(t, 8), device="cpu",
                     best=TileConfig(128, 64, "lex"),
                     timings={TileConfig(*c): s for c, s in timings.items()}, modes=(0, 1, 2))
    want = jtune.TuneResult(signature=jtune.Autotuner.signature_of(j, 8), backend="xla",
                            best=jtune.TileConfig(128, 64, "lex"),
                            timings={jtune.TileConfig(*c): s for c, s in timings.items()},
                            modes=(0, 1, 2))
    return got, want


def test_measured_vs_modeled_rows_match_jax():
    t, j = _pair()
    got_result, want_result = _results(t, j)
    got = measured_vs_modeled(t, got_result, rank=8, name="unit", device="cpu")
    want = jtune.measured_vs_modeled(j, want_result, rank=8, name="unit")
    assert [{k: v for k, v in r.items() if k != "modeled_s"} for r in got] == [
        {k: v for k, v in r.items() if k != "modeled_s"} for r in want]
    for r, w in zip(got, want):
        assert r["modeled_s"] == pytest.approx(w["modeled_s"], rel=REL, abs=0)
    assert sum(r["best"] for r in got) == 1
    assert len({r["modeled_s"] for r in got if r["ordering"] == "lex"}) == 1


def test_measured_vs_modeled_huge_dims_density_matches_jax():
    """The dense volume 2**63 + 2**42 wraps negative in int64; math.prod is exact."""
    t, j = _pair(nnz=300)
    big = type(t)(indices=t.indices, values=t.values, shape=(2**21, 2**21, 2**21 + 1))
    jbig = type(j)(indices=j.indices, values=j.values, shape=(2**21, 2**21, 2**21 + 1))
    assert np.prod([int(d) for d in big.shape]) < 0  # the overflow is real
    got = TuneResult(signature=Autotuner.signature_of(big, 8), device="cpu",
                     best=DEFAULT_TILE_CONFIG, timings={DEFAULT_TILE_CONFIG: 1e-3},
                     modes=(0, 1, 2))
    want = jtune.TuneResult(signature=jtune.Autotuner.signature_of(jbig, 8), backend="xla",
                            best=jtune.DEFAULT_TILE_CONFIG,
                            timings={jtune.DEFAULT_TILE_CONFIG: 1e-3}, modes=(0, 1, 2))
    (row,) = measured_vs_modeled(big, got, rank=8, name="huge", device="cpu")
    (jrow,) = jtune.measured_vs_modeled(jbig, want, rank=8, name="huge")
    assert np.isfinite(row["modeled_s"]) and row["modeled_s"] > 0.0
    assert row["modeled_s"] == pytest.approx(jrow["modeled_s"], rel=REL, abs=0)


class _Stub:
    def __init__(self, cfg):
        self.cfg = cfg
        self.calls = 0

    def config_for(self, tensor, rank):
        self.calls += 1
        return self.cfg


@pytest.mark.parametrize("ordering", [None, "lex", "blocked"])
def test_fused_cpals_takes_the_tuned_geometry_as_jax(ordering):
    t, j = _pair(nnz=600)
    stub, jstub = _Stub(TileConfig(128, 64, "degree")), _Stub(jtune.TileConfig(128, 64, "degree"))
    ex = tfused.FusedCPALS(t, 8, impl="kernel", device="cpu", ordering=ordering, autotune=stub)
    jex = jfused.FusedCPALS(j, 8, impl="pallas", ordering=ordering, autotune=jstub)
    assert stub.calls == jstub.calls == 1
    assert ex.ordering == jex.ordering == (ordering or "degree")
    geometry = [(p.tile_nnz, p.rows_per_block, p.ordering) for p in ex._plans]
    assert geometry == [(p.tile_nnz, p.rows_per_block, p.ordering) for p in jex._plans]
    assert geometry[0][:2] == (128, 64)
    inits = [np.asarray(f) for f in j_cp_init(j, 8, seed=0)]
    got = ex.run(n_iters=4, tol=0.0, init_factors=[inits])
    want = jex.run(n_iters=4, tol=0.0, seed=0)
    assert np.max(np.abs(got.fits - np.asarray(want.fits))) <= tfused.FUSED_FIT_TOL


def test_cp_als_fused_autotune_matches_jax():
    t, j = _pair(nnz=600)
    inits = [np.asarray(f) for f in j_cp_init(j, 8, seed=0)]
    got = tfused.cp_als_fused(t, 8, n_iters=4, tol=0.0, impl="kernel", device="cpu",
                              init_factors=[inits], autotune=_Stub(TileConfig(512, 64, "lex")))
    want = jfused.cp_als_fused(j, 8, n_iters=4, tol=0.0, impl="pallas",
                               autotune=_Stub(jtune.TileConfig(512, 64, "lex")))
    assert np.max(np.abs(got.fits - np.asarray(want.fits))) <= tfused.FUSED_FIT_TOL
    # A real tuner on the CPU plugs in as well.
    tuner = Autotuner(TuneSpace(**SMALL_SPACE), reps=1, device="cpu")
    tuner.tune(t, 8)
    run = tfused.cp_als_fused(t, 8, n_iters=2, tol=0.0, impl="kernel", device="cpu",
                              autotune=tuner)
    assert np.isfinite(run.fits).all()


def _jax_draws(tensor, rank, *, seed=0, device="cpu", **_):
    import torch

    jt = jst.SparseTensor(tensor.indices, tensor.values, tensor.shape)
    return [torch.from_numpy(np.array(f)).to(device) for f in j_cp_init(jt, rank, seed=seed)]


def test_experiment_spec_autotune_measures_at_the_tuned_geometry(same_times, monkeypatch):
    """Both engines tune under the same times, so both measure and trace
    their kernel cells at (128, 64); the priced results agree."""
    seen = []
    measure = tengine.measure_cp_als

    def spy(tensor, **kw):
        seen.append((kw["impl"], kw["tile_nnz"], kw["rows_per_block"]))
        return measure(tensor, **kw)

    monkeypatch.setattr(tengine, "measure_cp_als", spy)
    monkeypatch.setattr(tmeas, "cp_init", _jax_draws)
    spec = ExperimentSpec(tensors=TINY, impls=("ref", "kernel"), n_iters=2, device="cpu",
                          autotune=True)
    assert spec.to_dict()["autotune"] is True
    got = run_experiments(spec)
    want = j_run(JSpec(tensors=TINY, impls=("ref", "pallas"), n_iters=2, cost_analysis=False,
                       autotune=True))
    assert seen == [("ref", 256, 256), ("kernel", 128, 64)]
    for r, jr in zip(got.runs, want.runs):
        for h, jh in zip(r.hit_rates, jr.hit_rates):
            assert (h.trace, h.trace_warm) == (jh.trace, jh.trace_warm)
        for tc, jtc in zip(r.techs, jr.techs):
            assert tc.priced_mode_s == pytest.approx(jtc.priced_mode_s, rel=REL, abs=0)
        assert abs(r.measured.fit - jr.measured.fit) <= tfused.FUSED_FIT_TOL
    assert ExperimentSpec().autotune is False


def test_experiments_main_runs_the_tuner(tmp_path, capsys):
    out = tmp_path / "x.json"
    assert tmain.main(["--autotune", "--device", "cpu", "--tensors", "NELL-2@1e-4",
                       "--impls", "kernel", "--iters", "2", "--no-fused", "--out", str(out)]) == 0
    assert '"autotune": true' in out.read_text()
    assert "wrote" in capsys.readouterr().out
