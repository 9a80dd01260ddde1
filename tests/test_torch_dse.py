"""The port's design-space exploration (``repro_torch.dse``) against the JAX package's.

Sweep points, the evaluator's Che, trace and controller paths, the hit-rate
memo and the Pareto layer are numpy copies, so every result is held equal
to the reference's (floats bit for bit), and against the golden file's
``repro.dse`` cells as ``tests/test_hierarchy.py`` reads them.  Orderings
other than lex sort on ``device="cpu"`` here.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro import dse as jdse
from repro.core import hierarchy as jhier
from repro.core.memory_tech import E_SRAM as J_E, O_SRAM as J_O, TPU_V5E as J_TPU
from repro.core.sparse_tensor import random_sparse_tensor as j_random
from repro.data.frostt import FROSTT_TENSORS as J_TENSORS
from repro_torch import dse as tdse
from repro_torch.core import hierarchy as thier
from repro_torch.core.memory_tech import E_SRAM, O_SRAM, TPU_V5E
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.data.frostt import FROSTT_TENSORS, FrosttTensor
from repro_torch.dse import evaluator as tev
from repro_torch.reorder import ORDERINGS

GOLDEN = json.loads((Path(__file__).parent / "golden" / "flat_model_golden.json").read_text())
fromhex = float.fromhex
SMALL = ("NELL-2", "LBNL")


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


def _tables(names):
    """The port's and the reference's Table II records of ``names``."""
    return {n: FROSTT_TENSORS[n] for n in names}, {n: J_TENSORS[n] for n in names}


AXES = [
    {"frequency": (1e9, 10e9), "wavelengths": (1, 5)},
    {"cache_lines": (1024, 8192), "associativity": (2, 8), "rank": (8, 16)},
    {"n_caches": (1, 6), "dram_channels": (2, 8), "port_width": (16, 64)},
    {"n_pe": (2, 8), "pipelines": (40, 160), "f_electrical": (250e6, 1e9)},
]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: ",".join(a))
def test_sweep_points_and_cells_match(axes):
    pts, jpts = tdse.SweepSpec(axes=axes).points(), jdse.SweepSpec(axes=axes).points()
    assert tdse.SweepSpec(axes=axes).num_points() == len(jpts)
    assert _plain(pts) == _plain(jpts)
    ours, ref = _tables(SMALL)
    got, want = tdse.evaluate_sweep(pts, ours), jdse.evaluate_sweep(jpts, ref)
    assert _plain(got.results) == _plain(want.results)
    assert got.aggregate() == want.aggregate()
    assert got.rows(baseline=pts[0].label) == want.rows(baseline=jpts[0].label)
    assert (len(got.cache), got.cache.hits, got.cache.misses) == (
        len(want.cache), want.cache.hits, want.cache.misses)


def test_sweep_spec_rejections_match():
    for kw in ({"axes": {"bogus": (1,)}}, {"axes": {"hbm_bw": (1e9,)}},
               {"axes": {"frequency": (1e9,)}, "base_tech": TPU_V5E},
               {"axes": {"ordering": ("lex", "random")}}):
        jkw = dict(kw, base_tech=J_TPU) if "base_tech" in kw else kw
        with pytest.raises(ValueError) as got:
            tdse.SweepSpec(**kw)
        with pytest.raises(ValueError) as want:
            jdse.SweepSpec(**jkw)
        assert str(got.value) == str(want.value)
    assert tdse.SWEEP_AXES == jdse.SWEEP_AXES
    assert tdse.DEFAULT_AXIS_VALUES == jdse.DEFAULT_AXIS_VALUES


def test_paper_pair_and_tech_comparison_points_match():
    assert _plain(tdse.paper_pair()) == _plain(jdse.paper_pair())
    assert _plain(tdse.tech_comparison([E_SRAM, O_SRAM, TPU_V5E, thier.PHOTONIC_IMC], rank=8)) \
        == _plain(jdse.tech_comparison([J_E, J_O, J_TPU, jhier.PHOTONIC_IMC], rank=8))


def test_level_points_match():
    base, jbase = tdse.paper_pair()[1].hierarchy(), jdse.paper_pair()[1].hierarchy()
    lvl = base.caching_levels()[0].name
    pts = tdse.level_axis_points(base, level=lvl, field="capacity_bytes",
                                 values=(1 << 19, 1 << 21))
    jpts = jdse.level_axis_points(jbase, level=lvl, field="capacity_bytes",
                                  values=(1 << 19, 1 << 21))
    extra = dataclasses.replace(base.caching_levels()[0], name="L2")
    jextra = dataclasses.replace(jbase.caching_levels()[0], name="L2")
    pts.append(tdse.add_level_point(base, extra, 1))
    jpts.append(jdse.add_level_point(jbase, jextra, 1))
    pts.append(tdse.drop_level_point(base.with_level(extra, 1), lvl))
    jpts.append(jdse.drop_level_point(jbase.with_level(jextra, 1), lvl))
    assert _plain(pts) == _plain(jpts)
    ours, ref = _tables(SMALL)
    assert _plain(tdse.evaluate_sweep(pts, ours).results) == _plain(
        jdse.evaluate_sweep(jpts, ref).results)


def test_paper_pair_result_matches_golden():
    """test_hierarchy.py's golden cells, through the port's evaluator."""
    res = tdse.paper_pair_result()
    for name, ref in GOLDEN["paper_pair"].items():
        cell_e, cell_o = res.cell("E-SRAM", name), res.cell("O-SRAM", name)
        assert [fromhex(h) for h in ref["esram_mode_s"]] == list(cell_e.mode_seconds)
        assert [fromhex(h) for h in ref["osram_mode_s"]] == list(cell_o.mode_seconds)
        assert cell_e.energy_j == fromhex(ref["esram_energy_j"])
        assert cell_o.energy_j == fromhex(ref["osram_energy_j"])


def test_golden_3axis_sweep_bit_exact():
    axes = {
        "cache_lines": [int(v) for v in GOLDEN["sweep"]["axes"]["cache_lines"]],
        "frequency": GOLDEN["sweep"]["axes"]["frequency"],
        "rank": [int(v) for v in GOLDEN["sweep"]["axes"]["rank"]],
    }
    tensors = {n: FROSTT_TENSORS[n] for n in GOLDEN["sweep"]["tensors"]}
    res = tdse.evaluate_sweep(tdse.SweepSpec(axes=axes).points(), tensors)
    for ref in GOLDEN["sweep"]["cells"]:
        cell = res.cell(ref["label"], ref["tensor"])
        assert list(cell.mode_seconds) == [fromhex(h) for h in ref["mode_s"]]
        assert cell.energy_j == fromhex(ref["energy_j"])


@pytest.fixture(scope="module")
def trace_pair():
    """A small Zipf tensor drawn by both packages, and its characteristics."""
    kw = dict(seed=5, zipf_a=1.0, correlation=0.7, n_clusters=16, shuffle=True)
    t = random_sparse_tensor((300, 2000, 1500), 6000, **kw)
    j = j_random((300, 2000, 1500), 6000, **kw)
    chars = FrosttTensor(name="unit", dims=t.shape, nnz=t.nnz, density=t.density,
                         zipf_alpha=1.0)
    return t, j, chars


@pytest.mark.parametrize("method", ["che", "trace", "auto"])
def test_evaluate_sweep_hit_rate_methods_match(trace_pair, method):
    t, j, chars = trace_pair
    pts = tdse.tech_comparison([E_SRAM, O_SRAM, TPU_V5E, thier.PHOTONIC_IMC])
    jpts = jdse.tech_comparison([J_E, J_O, J_TPU, jhier.PHOTONIC_IMC])
    got = tdse.evaluate_sweep(pts, {"unit": chars}, hit_rate_method=method,
                              trace_tensors={"unit": t}, trace_nnz_limit=10_000)
    want = jdse.evaluate_sweep(jpts, {"unit": chars}, hit_rate_method=method,
                               trace_tensors={"unit": j}, trace_nnz_limit=10_000)
    assert _plain(got.results) == _plain(want.results)
    assert (got.cache.hits, got.cache.misses) == (want.cache.hits, want.cache.misses)
    assert tev.TRACE_NNZ_LIMIT == 200_000


def test_ordering_axis_under_trace_method_matches(trace_pair):
    t, j, chars = trace_pair
    axes = {"ordering": ORDERINGS}
    got = tdse.evaluate_sweep(tdse.SweepSpec(axes=axes).points(), {"unit": chars},
                              hit_rate_method="trace", trace_tensors={"unit": t},
                              device="cpu")
    want = jdse.evaluate_sweep(jdse.SweepSpec(axes=axes).points(), {"unit": chars},
                               hit_rate_method="trace", trace_tensors={"unit": j})
    assert _plain(got.results) == _plain(want.results)
    with pytest.raises(ValueError, match="invisible to the che"):
        tdse.evaluate_sweep(tdse.SweepSpec(axes=axes).points(), {"unit": chars})


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_exact_hit_rates_for_geometry_match(trace_pair, ordering):
    t, j, _ = trace_pair
    geom = thier.CacheGeometry(capacity_bytes=1 << 16, line_bytes=64, associativity=4)
    jgeom = jhier.CacheGeometry(capacity_bytes=1 << 16, line_bytes=64, associativity=4)
    for mode in range(t.nmodes):
        got = tev.exact_hit_rates_for_geometry(t, mode, geom, 16, ordering=ordering,
                                               device="cpu")
        assert got == jdse.evaluator.exact_hit_rates_for_geometry(
            j, mode, jgeom, 16, ordering=ordering)
    for rank in (8, 16, 32):
        cfg, row = tev.geometry_sim_config(geom, rank, n_inputs=2)
        jcfg, jrow = jdse.geometry_sim_config(jgeom, rank, n_inputs=2)
        assert (_plain(cfg), row) == (_plain(jcfg), jrow)


def test_pareto_and_ranking_match():
    axes = {"frequency": (1e9, 5e9, 10e9, 20e9, 40e9), "n_caches": (1, 3, 6)}
    ours, ref = _tables(SMALL)
    got = tdse.evaluate_sweep(tdse.SweepSpec(axes=axes).points(), ours)
    want = jdse.evaluate_sweep(jdse.SweepSpec(axes=axes).points(), ref)
    ranked, jranked = tdse.rank_configurations(got), jdse.rank_configurations(want)
    assert _plain(ranked) == _plain(jranked)
    assert _plain(tdse.pareto_frontier(ranked)) == _plain(jdse.pareto_frontier(jranked))
    base = got.labels()[0]
    assert tdse.compare_techs(got, baseline=base) == jdse.compare_techs(want, baseline=base)
    pts = [tdse.ParetoPoint("a", 1.0, None), tdse.ParetoPoint("b", 2.0, 1.0),
           tdse.ParetoPoint("c", 1.0, 2.0), tdse.ParetoPoint("d", 1.0, 2.0)]
    jpts = [jdse.ParetoPoint(p.label, p.time_s, p.energy_j) for p in pts]
    assert _plain(tdse.pareto_frontier(pts)) == _plain(jdse.pareto_frontier(jpts))


def test_hit_rate_cache_memo_matches(trace_pair):
    t, j, chars = trace_pair
    cache, jcache = tdse.HitRateCache(), jdse.HitRateCache()
    geom = thier.CacheGeometry(capacity_bytes=1 << 16, line_bytes=64, associativity=4)
    jgeom = jhier.CacheGeometry(capacity_bytes=1 << 16, line_bytes=64, associativity=4)
    for _ in range(2):
        for method in ("che", "trace"):
            for ordering in ("lex", "degree"):
                got = cache.get(chars, 1, geom, 16, method=method, trace=t,
                                ordering=ordering, device="cpu")
                assert got == jcache.get(chars, 1, jgeom, 16, method=method, trace=j,
                                         ordering=ordering)
    assert (len(cache), cache.hits, cache.misses) == (len(jcache), jcache.hits, jcache.misses)
    with pytest.raises(ValueError, match="hit-rate method"):
        cache.get(chars, 0, geom, 16, method="bogus")


def test_autotuner_is_not_ported_and_says_which_item():
    with pytest.raises(ImportError, match="item 6"):
        from repro_torch.dse import Autotuner  # noqa: F401
    with pytest.raises(ImportError, match="item 6"):
        tdse.measured_vs_modeled  # noqa: B018
    with pytest.raises(AttributeError):
        tdse.not_a_name  # noqa: B018
    assert set(tdse.__all__) == set(jdse.__all__) - {
        "DEFAULT_TILE_CONFIG", "Autotuner", "TileConfig", "TuneResult", "TuneSpace",
        "WallTimeMemo", "measure_config", "measured_vs_modeled"}
