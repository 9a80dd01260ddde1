"""The port's cycle-level memory-controller model against the JAX package's.

``repro_torch.model.controller`` and ``repro_torch.experiments.reconcile``
are numpy copies, so every result is held equal to the reference's on the
same tensors (floats bit for bit).  As ``tests/test_controller.py`` does
for the reference, the port's calibration reconciliation must land within
``CONTROLLER_RECON_TOL`` (one-sided), and the paper controller must keep
the paper's bands, as ``scripts/run_controller.py`` gates them.  Orderings
other than lex sort on ``device="cpu"`` here.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core import cache_sim as jcache
from repro.core import hierarchy as jhier
from repro.core.accelerator import PAPER_ACCEL as J_ACCEL
from repro.core.memory_tech import E_SRAM as J_E, O_SRAM as J_O, PAPER_SYSTEM as J_SYS
from repro.core.sparse_tensor import random_sparse_tensor as j_random
from repro.data.synthetic_tensors import make_frostt_like as j_frostt
from repro.dse import SweepSpec as JSweepSpec, evaluate_sweep as j_evaluate
from repro.experiments import reconcile_controller as j_reconcile
from repro.model import controller as jctl
from repro_torch.core import cache_sim as tcache
from repro_torch.core import hierarchy as thier
from repro_torch.core.accelerator import PAPER_ACCEL
from repro_torch.core.memory_tech import E_SRAM, O_SRAM, PAPER_SYSTEM, TPU_V5E
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.data.synthetic_tensors import (
    EXPERIMENT_SCALES,
    make_frostt_like,
)
from repro_torch.dse import SweepSpec, evaluate_sweep
from repro_torch.dse.evaluator import exact_hit_rates_for_geometry
from repro_torch.experiments import CONTROLLER_RECON_TOL, reconcile_controller
from repro_torch.experiments import reconcile as trecon
from repro_torch.model import controller as tctl
from repro_torch.reorder import ORDERINGS

RANK = 16
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "run_controller.py"


def _run_controller_script():
    """scripts/run_controller.py as a module (its gates' constants)."""
    spec = importlib.util.spec_from_file_location("_run_controller", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plain(x):
    """A record (or nested tuples/dicts of them) as plain Python values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _pair(seed=0, nnz=400, shape=(37, 29, 23), **kw):
    """The same random tensor drawn by both packages."""
    t = random_sparse_tensor(shape, nnz, seed=seed, **kw)
    j = j_random(shape, nnz=nnz, seed=seed, **kw)
    np.testing.assert_array_equal(t.indices, j.indices)
    return t, j


def _hiers(tech):
    tech_j = {"E-SRAM": J_E, "O-SRAM": J_O}[tech.name]
    return (thier.fpga_hierarchy(tech, accel=PAPER_ACCEL, system=PAPER_SYSTEM),
            jhier.fpga_hierarchy(tech_j, accel=J_ACCEL, system=J_SYS))


def _config_pair(**kw):
    return tctl.ControllerConfig(**kw), jctl.ControllerConfig(**kw)


@pytest.fixture(scope="module")
def correlated():
    """A conflict-heavy correlated tensor (test_controller.py's policy tensor)."""
    return _pair(seed=7, nnz=3000, shape=(64, 4096, 4096), zipf_a=1.2, correlation=0.9,
                 n_clusters=16, shuffle=True)


def test_config_validation_and_named_controllers_match():
    for bad in ({"n_banks": 0}, {"bank_conflict_policy": "roundrobin"},
                {"prefetch_depth": -1}, {"reorder_buffer_depth": 0}, {"line_bytes": 2}):
        with pytest.raises(ValueError) as got:
            tctl.ControllerConfig(**bad)
        with pytest.raises(ValueError) as want:
            jctl.ControllerConfig(**bad)
        assert str(got.value) == str(want.value)
    assert tctl.POLICIES == jctl.POLICIES
    t, j = _config_pair(n_banks=4, reorder_buffer_depth=8)
    assert (t.label, t.window_requests) == (j.label, j.window_requests)
    assert _plain(tctl.paper_controller()) == _plain(jctl.paper_controller())
    assert _plain(tctl.calibration_controller()) == _plain(jctl.calibration_controller())


@pytest.mark.parametrize("policy", ["fifo", "stall", "queue"])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("tech", [E_SRAM, O_SRAM], ids=lambda t: t.name)
def test_simulate_controller_mode_matches(correlated, policy, prefetch, tech):
    t, j = correlated
    cfg_t, cfg_j = _config_pair(n_banks=2, bank_conflict_policy=policy,
                                prefetch_depth=prefetch, reorder_buffer_depth=4)
    hier_t, hier_j = _hiers(tech)
    for mode in range(t.nmodes):
        got = tctl.simulate_controller_mode(t, mode, hier_t, config=cfg_t, rank=RANK)
        want = jctl.simulate_controller_mode(j, mode, hier_j, config=cfg_j, rank=RANK)
        assert _plain(got) == _plain(want)
        assert got.bottleneck == want.bottleneck
        assert _plain(got.as_mode_time()) == _plain(want.as_mode_time())


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_simulate_controller_run_matches_for_each_ordering(ordering):
    t, j = _pair(seed=3, nnz=1500, shape=(48, 300, 250), zipf_a=1.0)
    hier_t, hier_j = _hiers(O_SRAM)
    got = tctl.simulate_controller(t, hier_t, config=tctl.paper_controller(), rank=RANK,
                                   ordering=ordering, name="unit", device="cpu")
    want = jctl.simulate_controller(j, hier_j, config=jctl.paper_controller(), rank=RANK,
                                    ordering=ordering, name="unit")
    assert _plain(got) == _plain(want)
    assert (got.seconds, got.cycles) == (want.seconds, want.cycles)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_request_streams_and_bank_conflicts_match(ordering):
    t, j = _pair(seed=7, nnz=20_000, shape=(2048, 32768, 32768), zipf_a=1.1,
                 correlation=0.9, n_clusters=64, shuffle=True)
    for mode in range(t.nmodes):
        got = tctl.request_streams(t, mode, ordering=ordering, device="cpu")
        want = jctl.request_streams(j, mode, ordering=ordering)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert (tctl.request_stream_lengths(t, mode, ordering=ordering, device="cpu")
                == jctl.request_stream_lengths(j, mode, ordering=ordering))
    counts = tctl.bank_conflict_counts(t, 0, config=tctl.paper_controller(),
                                       ordering=ordering, device="cpu")
    assert _plain(counts) == _plain(jctl.bank_conflict_counts(
        j, 0, config=jctl.paper_controller(), ordering=ordering))
    assert counts.conflict_rate == jctl.bank_conflict_counts(
        j, 0, config=jctl.paper_controller(), ordering=ordering).conflict_rate


@pytest.mark.parametrize("num_lines,assoc", [(64, 4), (256, 256), (32, 1)])
@pytest.mark.parametrize("prefetch", [0, 3])
def test_trace_simulators_match(num_lines, assoc, prefetch):
    """The port evicts from an OrderedDict where the reference walks a dict:
    every hit, fill and count must still agree, also on a fully associative
    level whose catalog is larger than it."""
    rng = np.random.default_rng(num_lines + prefetch)
    cfg, jcfg = tcache.CacheConfig(num_lines, 64, assoc), jcache.CacheConfig(num_lines, 64, assoc)
    for trace in (rng.integers(0, 4 * num_lines, size=5000),
                  (rng.zipf(1.3, size=5000) - 1) % (8 * num_lines), np.arange(3000) % 97):
        got = tcache.simulate_trace_flags(trace, cfg, prefetch_depth=prefetch,
                                          catalog_rows=8 * num_lines)
        want = jcache.simulate_trace_flags(trace, jcfg, prefetch_depth=prefetch,
                                           catalog_rows=8 * num_lines)
        np.testing.assert_array_equal(got.hits, want.hits)
        np.testing.assert_array_equal(got.prefetch_fills, want.prefetch_fills)
        assert _plain(got.stats) == _plain(want.stats)
        assert _plain(tcache.simulate_trace(trace, cfg)) == _plain(
            jcache.simulate_trace(trace, jcfg))


def test_orderings_reduce_bank_conflicts_on_correlated_tensor():
    """The ordering gate of scripts/run_controller.py, on the port
    (``reconcile.ordering_conflicts``), at a smaller draw of its tensor."""
    t = trecon.conflict_tensor(20_000)
    script = _run_controller_script()
    j = script._conflict_workload(quick=True)  # the same draw at the script's 40,000
    np.testing.assert_array_equal(trecon.conflict_tensor(40_000).indices, j.indices)
    counts = trecon.ordering_conflicts(t, device="cpu")
    assert sorted(counts) == sorted(script.ORDERINGS)
    lex = counts["lex"]
    for ordering in ("degree", "blocked"):
        alt = counts[ordering]
        assert alt.n_requests == lex.n_requests == 2 * t.nnz
        assert alt.n_conflicts < lex.n_conflicts
        assert _plain(alt) == _plain(jctl.bank_conflict_counts(
            j_random((2048, 32768, 32768), nnz=20_000, seed=7, zipf_a=1.1, correlation=0.9,
                     n_clusters=64, shuffle=True),
            0, config=jctl.paper_controller(), ordering=ordering))
    assert trecon.ControllerGates(bands={}, conflicts=counts).conflicts_ok


def test_controller_gates_are_the_script_s():
    """One copy of scripts/run_controller.py's gate values, in the port."""
    script = _run_controller_script()
    assert trecon.SPEEDUP_BAND == script.SPEEDUP_BAND
    assert trecon.ENERGY_BAND == script.ENERGY_BAND
    assert trecon.BAND_SCALES == script.BAND_SCALES
    assert trecon.conflict_tensor().nnz == script._conflict_workload(quick=False).nnz


def test_controller_rejects_what_the_reference_rejects():
    t, _ = _pair()
    tpu = thier.resolve_hierarchy(TPU_V5E, accel=PAPER_ACCEL, system=PAPER_SYSTEM)
    with pytest.raises(ValueError, match="fpga-family"):
        tctl.simulate_controller_mode(t, 0, tpu, config=tctl.ControllerConfig(), rank=RANK)
    with pytest.raises(ValueError, match="line_bytes"):
        tctl.simulate_controller_mode(t, 0, _hiers(E_SRAM)[0],
                                      config=tctl.ControllerConfig(line_bytes=32), rank=RANK)


def test_single_bank_fifo_one_window_matches_the_port_analytic_model():
    """test_controller.py's anchor on the port: one fifo bank over the whole
    stream is the analytic max-of-bounds of a 1-unit stack."""
    t, _ = _pair(seed=3)
    cfg = tctl.ControllerConfig(n_banks=1, reorder_buffer_depth=4096)
    for tech in (E_SRAM, O_SRAM):
        hier = _hiers(tech)[0]
        lvl = hier.caching_levels()[0]
        hier1 = hier.replace_level(
            lvl.name, port_model=dataclasses.replace(lvl.port_model, n_units=1))
        geometry = hier.hit_geometries()[0]
        for mode in range(t.nmodes):
            r = tctl.simulate_controller_mode(t, mode, hier, config=cfg, rank=RANK)
            assert r.n_windows == 1
            hr = exact_hit_rates_for_geometry(t, mode, geometry, RANK)
            mt = thier.hierarchy_mode_time(
                hier1, tctl._adhoc_chars(t, "x"), mode, rank=RANK, hit_rates=hr)
            assert r.seconds == pytest.approx(mt.seconds, rel=1e-9)
            assert r.hit_rates == hr


@pytest.fixture(scope="module")
def reconciliations():
    return reconcile_controller(), j_reconcile()


def test_reconcile_controller_matches_the_reference(reconciliations):
    (cells, runs), (j_cells, j_runs) = reconciliations
    assert [c.as_dict() for c in cells] == [c.as_dict() for c in j_cells]
    assert sorted(runs) == sorted(j_runs)
    for key in runs:
        assert _plain(runs[key]) == _plain(j_runs[key])


def test_reconcile_controller_within_tolerance(reconciliations):
    (cells, runs), _ = reconciliations
    assert {c.workload for c in cells} == set(EXPERIMENT_SCALES)
    assert {c.tech for c in cells} == {"E-SRAM", "O-SRAM"}
    for c in cells:
        assert c.ok, f"{c.workload}/{c.tech}: rel={c.rel_err:+.4f}"
        assert c.rel_err >= -1e-9  # one-sided
        assert abs(c.rel_err) <= CONTROLLER_RECON_TOL
        assert runs[f"{c.workload}/{c.tech}"].energy_j > 0


@pytest.mark.parametrize("name", sorted(trecon.BAND_SCALES))
def test_paper_controller_keeps_the_paper_bands(name):
    scale = trecon.BAND_SCALES[name]
    speedup, savings = trecon.paper_bands({name: scale}, rank=RANK)[name]
    assert trecon.SPEEDUP_BAND[0] <= speedup <= trecon.SPEEDUP_BAND[1]
    assert trecon.ENERGY_BAND[0] <= savings <= trecon.ENERGY_BAND[1]
    assert trecon.in_paper_bands(speedup, savings)
    tensor = make_frostt_like(name, scale=scale, seed=0)
    ref = j_frostt(name, scale=scale, seed=0)
    np.testing.assert_array_equal(tensor.indices, ref.indices)


def test_controller_sweep_axes_price_through_event_loop_as_in_jax():
    t, j = _pair(nnz=600)
    chars = tctl._adhoc_chars(t, "unit")
    j_chars = jctl._adhoc_chars(j, "unit")
    axes = {"n_banks": (1, 12), "bank_policy": ("fifo", "queue"), "prefetch_depth": (0, 2)}
    pts = SweepSpec(axes=axes).points()
    with pytest.raises(ValueError, match="executable trace"):
        evaluate_sweep(pts, {"unit": chars})
    got = evaluate_sweep(pts, {"unit": chars}, hit_rate_method="trace",
                         trace_tensors={"unit": t})
    want = j_evaluate(JSweepSpec(axes=axes).points(), {"unit": j_chars},
                      hit_rate_method="trace", trace_tensors={"unit": j})
    assert _plain(got.results) == _plain(want.results)
    assert got.rows() == want.rows()
    with pytest.raises(ValueError, match="bank policies"):
        SweepSpec(axes={"bank_policy": ("fifo", "bogus")})
