"""The port's copy of the paper's analytic O-SRAM/E-SRAM model against the
JAX package's, on the CPU.

Both sides are the same numpy arithmetic, so every output is held equal
(floats bit for bit), and against the golden file as
``tests/test_hierarchy.py`` holds the reference.  The abstract's bands
(1.1-2.9x speedup, 2.8-8.1x energy saving) are checked on the port's copy.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import accelerator as jacc
from repro.core import cache_sim as jcache
from repro.core import hierarchy as jhier
from repro.core import memory_tech as jtech
from repro.core import perf_model as jperf
from repro.core import sparse_tensor as jst
from repro.data.frostt import FROSTT_TENSORS as J_TENSORS
from repro.perf import roofline as jroof
from repro.reorder import strategies as jstrat
from repro_torch.core import accelerator as tacc
from repro_torch.core import cache_sim as tcache
from repro_torch.core import hierarchy as thier
from repro_torch.core import memory_tech as ttech
from repro_torch.core import perf_model as tperf
from repro_torch.core import sparse_tensor as tst
from repro_torch.data.frostt import FROSTT_TENSORS as T_TENSORS
from repro_torch.perf import roofline as troof
from repro_torch.reorder import strategies as tstrat

GOLDEN = json.loads((Path(__file__).parent / "golden" / "flat_model_golden.json").read_text())
NAMES = sorted(T_TENSORS)
SPEEDUP_BAND = (1.1, 2.9)  # the abstract
ENERGY_BAND = (2.8, 8.1)


def _plain(x):
    """A dataclass (or nested tuples/dicts of them) as plain Python values,
    so that the port's and the reference's records compare by value."""
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


def test_frostt_records_match():
    assert set(T_TENSORS) == set(J_TENSORS)
    for name in NAMES:
        assert _plain(T_TENSORS[name]) == _plain(J_TENSORS[name])


def test_memory_tech_records_match():
    for t, j in [(ttech.E_SRAM, jtech.E_SRAM), (ttech.O_SRAM, jtech.O_SRAM),
                 (ttech.PAPER_SYSTEM, jtech.PAPER_SYSTEM), (ttech.TPU_V5E, jtech.TPU_V5E)]:
        assert _plain(t) == _plain(j)
    for f in (500e6, 1e9):
        assert ttech.O_SRAM.b_process(f) == jtech.O_SRAM.b_process(f)
        assert ttech.E_SRAM.effective_ports(f) == jtech.E_SRAM.effective_ports(f)


@pytest.fixture(scope="module")
def tables():
    return tperf.speedup_table(), tperf.energy_table()


@pytest.fixture(scope="module")
def reference_tables():
    return jperf.speedup_table(), jperf.energy_table()


@pytest.mark.parametrize("name", NAMES)
def test_speedup_table_matches(name, tables, reference_tables):
    assert _plain(tables[0][name]) == _plain(reference_tables[0][name])


@pytest.mark.parametrize("name", NAMES)
def test_energy_table_matches(name, tables, reference_tables):
    assert _plain(tables[1][name]) == _plain(reference_tables[1][name])


def test_area_table_and_energy_constants_match():
    assert tperf.area_table() == jperf.area_table()
    assert tperf.energy_constants() == jperf.energy_constants()


def _hierarchies(tmod, tech, acc):
    return {
        "E-SRAM": tmod.fpga_hierarchy(tech.E_SRAM, accel=acc.PAPER_ACCEL),
        "O-SRAM": tmod.fpga_hierarchy(tech.O_SRAM, accel=acc.PAPER_ACCEL),
        "TPU": tmod.tpu_hierarchy(tech.TPU_V5E),
        "photonic-IMC": tmod.photonic_imc_hierarchy(),
    }


@pytest.mark.parametrize("stack", ["E-SRAM", "O-SRAM", "TPU", "photonic-IMC"])
@pytest.mark.parametrize("name", ["NELL-2", "LBNL", "AMAZON"])
def test_hierarchy_mode_times_and_energy_match(stack, name):
    th = _hierarchies(thier, ttech, tacc)[stack]
    jh = _hierarchies(jhier, jtech, jacc)[stack]
    tt, jt = T_TENSORS[name], J_TENSORS[name]
    t_modes = [thier.hierarchy_mode_time(th, tt, m, rank=16) for m in range(tt.nmodes)]
    j_modes = [jhier.hierarchy_mode_time(jh, jt, m, rank=16) for m in range(jt.nmodes)]
    assert _plain(t_modes) == _plain(j_modes)
    assert _plain(thier.hierarchy_energy(th, tt, t_modes)) == _plain(
        jhier.hierarchy_energy(jh, jt, j_modes))


@pytest.mark.parametrize("family", ["fpga", "roofline"])
def test_hierarchy_mode_times_batch_matches(family):
    if family == "fpga":
        techs = [(ttech.E_SRAM, jtech.E_SRAM), (ttech.O_SRAM, jtech.O_SRAM)]
        th = [thier.fpga_hierarchy(t, accel=tacc.PAPER_ACCEL) for t, _ in techs]
        jh = [jhier.fpga_hierarchy(j, accel=jacc.PAPER_ACCEL) for _, j in techs]
    else:
        th = [thier.tpu_hierarchy(ttech.TPU_V5E)]
        jh = [jhier.tpu_hierarchy(jtech.TPU_V5E)]
    for name in ("NELL-2", "PATENTS"):
        tt, jt = T_TENSORS[name], J_TENSORS[name]
        for mode in range(tt.nmodes):
            ranks = [8, 16, 32][: len(th)] if len(th) > 1 else [16]
            t_hits = [thier.hierarchy_hit_rates(h, tt, mode, rank=r) for h, r in zip(th, ranks)]
            j_hits = [jhier.hierarchy_hit_rates(h, jt, mode, rank=r) for h, r in zip(jh, ranks)]
            assert _plain(t_hits) == _plain(j_hits)
            got = thier.hierarchy_mode_times_batch(th, tt, mode, ranks, t_hits)
            want = jhier.hierarchy_mode_times_batch(jh, jt, mode, ranks, j_hits)
            assert _plain(got) == _plain(want)


@pytest.mark.parametrize("alpha", [0.0, 0.7, 1.2])
def test_che_hit_rate_matches(alpha):
    for rows, cache in [(10_000, 1_000), (500, 1_000), (1_000_000, 4_096)]:
        for length in (None, 50_000.0):
            got = tcache.che_hit_rate(rows, cache, zipf_alpha=alpha, trace_length=length)
            want = jcache.che_hit_rate(rows, cache, zipf_alpha=alpha, trace_length=length)
            assert got == want


def test_analytic_traffic_census_matches():
    for n in (3, 4, 5):
        assert thier.analytic_traffic_census(n) == jhier.analytic_traffic_census(n)
    for name in NAMES:
        for mode in range(T_TENSORS[name].nmodes):
            hits = tuple(0.1 * k for k in range(1, T_TENSORS[name].nmodes))
            got = thier.dram_traffic_per_nnz(T_TENSORS[name], mode, hits, rank=16, row_bytes=64)
            want = jhier.dram_traffic_per_nnz(J_TENSORS[name], mode, hits, rank=16, row_bytes=64)
            assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_mttkrp_tpu_roofline_matches(name):
    for mode in range(T_TENSORS[name].nmodes):
        got = troof.mttkrp_tpu_roofline(T_TENSORS[name], mode)
        want = jroof.mttkrp_tpu_roofline(J_TENSORS[name], mode)
        assert _plain(got) == _plain(want)


@pytest.mark.parametrize("ordering", ["lex", "secondary-sort", "degree", "blocked"])
def test_exact_lru_on_ordered_traces_matches(ordering):
    """``simulate_trace`` and ``simulate_trace_flags`` on each ordering's
    executed trace (the port's ``mode_trace``, array-equal to JAX's)."""
    shape, nnz = (400, 300, 500), 20_000
    tt = tst.random_sparse_tensor(shape, nnz, seed=3, zipf_a=0.9)
    jt = jst.random_sparse_tensor(shape, nnz, seed=3, zipf_a=0.9)
    cfgs = [tcache.CacheConfig(), tcache.CacheConfig(num_lines=64, associativity=2),
            tcache.CacheConfig(num_lines=256, line_bytes=32, associativity=8)]
    for out_mode, in_mode in [(0, 1), (0, 2), (2, 1)]:
        trace = tstrat.mode_trace(tt, out_mode, in_mode, strategy=ordering, device="cpu")
        want_trace = jstrat.mode_trace(jt, out_mode, in_mode, strategy=ordering)
        np.testing.assert_array_equal(trace, want_trace)
        for cfg in cfgs:
            jcfg = jcache.CacheConfig(**dataclasses.asdict(cfg))
            got = tcache.simulate_trace(trace, cfg)
            assert _plain(got) == _plain(jcache.simulate_trace(want_trace, jcfg))
            if cfg.line_bytes >= 64:
                flags = tcache.simulate_trace_flags(trace, cfg)
                want = jcache.simulate_trace_flags(want_trace, jcfg)
                np.testing.assert_array_equal(flags.hits, want.hits)
                np.testing.assert_array_equal(flags.prefetch_fills, want.prefetch_fills)
                assert _plain(flags.stats) == _plain(got)
        fills = tcache.simulate_trace_flags(trace, cfgs[1], prefetch_depth=2,
                                            catalog_rows=shape[in_mode])
        want = jcache.simulate_trace_flags(want_trace, jcache.CacheConfig(num_lines=64, associativity=2),
                                           prefetch_depth=2, catalog_rows=shape[in_mode])
        np.testing.assert_array_equal(fills.hits, want.hits)
        np.testing.assert_array_equal(fills.prefetch_fills, want.prefetch_fills)


# --- the golden file, as tests/test_hierarchy.py holds the reference to it ---


def test_golden_paper_pair_tables_bit_exact(tables):
    st, et = tables
    for name, ref in GOLDEN["paper_pair"].items():
        for m, hx in enumerate(ref["esram_mode_s"]):
            assert st[name][m].t_esram.seconds == float.fromhex(hx), (name, m)
        for m, hx in enumerate(ref["osram_mode_s"]):
            assert st[name][m].t_osram.seconds == float.fromhex(hx), (name, m)
        assert et[name].e_esram_j == float.fromhex(ref["esram_energy_j"]), name
        assert et[name].e_osram_j == float.fromhex(ref["osram_energy_j"]), name


def test_golden_tpu_roofline_bit_exact():
    for name, rows in GOLDEN["tpu_roofline"].items():
        for m, ref in enumerate(rows):
            mt = troof.mttkrp_tpu_roofline(T_TENSORS[name], m)
            assert mt.compute_s == float.fromhex(ref["compute_s"]), (name, m)
            assert mt.memory_s == float.fromhex(ref["memory_s"]), (name, m)
            assert mt.hbm_bytes == float.fromhex(ref["hbm_bytes"]), (name, m)


# --- the abstract's bands, on the port's copy (tests/test_paper_claims.py) ---


def test_speedup_table_lies_in_abstract_band(tables):
    st, _ = tables
    for name, modes in st.items():
        total = sum(m.t_esram.seconds for m in modes) / sum(m.t_osram.seconds for m in modes)
        assert SPEEDUP_BAND[0] <= total <= SPEEDUP_BAND[1], (name, total)
        for m in modes:
            assert SPEEDUP_BAND[0] <= m.speedup <= SPEEDUP_BAND[1], (name, m.mode, m.speedup)


def test_energy_table_lies_in_abstract_band(tables):
    _, et = tables
    for name, te in et.items():
        assert ENERGY_BAND[0] <= te.savings <= ENERGY_BAND[1], (name, te.savings)


def test_bands_are_spanned_not_just_contained(tables):
    st, et = tables
    totals = {name: sum(m.t_esram.seconds for m in modes) / sum(m.t_osram.seconds for m in modes)
              for name, modes in st.items()}
    assert min(totals.values()) < 1.5
    assert max(totals.values()) > 2.0
    savings = {name: te.savings for name, te in et.items()}
    assert min(savings.values()) < 4.0
    assert max(savings.values()) > 5.5


def test_all_table_ii_tensors_are_priced(tables):
    st, et = tables
    assert set(st) == set(T_TENSORS) == set(et)
