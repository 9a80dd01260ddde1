"""The port's plans, draws and Table II catalog are array-equal to the JAX package's."""

import dataclasses

import numpy as np
import pytest

from repro.core import sparse_tensor as jst
from repro.data import frostt as jfrostt
from repro.data import synthetic_tensors as jsyn
from repro_torch.convert import plan_from_numpy
from repro_torch.core import sparse_tensor as tst
from repro_torch.data import frostt as tfrostt
from repro_torch.data import synthetic_tensors as tsyn

PLAN_ARRAYS = ("sorted_indices", "sorted_values", "local_row", "tile_block")


def _assert_tensors_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.indices.dtype == b.indices.dtype and a.values.dtype == b.values.dtype


def _assert_plans_equal(a, b):
    for f in ("mode", "shape", "tile_nnz", "rows_per_block", "num_blocks", "ordering"):
        assert getattr(a, f) == getattr(b, f), f
    for f in PLAN_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


DRAWS = [
    dict(shape=(13, 7, 9), nnz=60, seed=1),
    dict(shape=(70, 33, 41), nnz=800, seed=3, zipf_a=0.85),
    dict(shape=(50, 40, 30), nnz=500, seed=2, zipf_a=0.55, shuffle=True),
    dict(shape=(40, 30, 20), nnz=400, seed=7, correlation=0.6, n_clusters=8),
    dict(shape=(20, 15, 10, 8), nnz=300, seed=4, zipf_a=0.75, correlation=0.3, shuffle=True),
    dict(shape=(9, 8, 7, 6, 5), nnz=300, seed=5),
]


@pytest.mark.parametrize("kw", DRAWS, ids=lambda kw: f"{len(kw['shape'])}m-s{kw['seed']}")
def test_random_sparse_tensor_draws_equal(kw):
    kw = dict(kw)
    shape, nnz = kw.pop("shape"), kw.pop("nnz")
    _assert_tensors_equal(
        tst.random_sparse_tensor(shape, nnz, **kw), jst.random_sparse_tensor(shape, nnz, **kw)
    )


@pytest.mark.parametrize("tile_nnz,rows_per_block", [(8, 8), (64, 16), (256, 64), (32, 128)])
@pytest.mark.parametrize("kw", DRAWS, ids=lambda kw: f"{len(kw['shape'])}m-s{kw['seed']}")
def test_build_mttkrp_plan_array_equal(kw, tile_nnz, rows_per_block):
    kw = dict(kw)
    shape, nnz = kw.pop("shape"), kw.pop("nnz")
    t = tst.random_sparse_tensor(shape, nnz, **kw)
    tj = jst.random_sparse_tensor(shape, nnz, **kw)
    for mode in range(len(shape)):
        a = tst.build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
        b = jst.build_mttkrp_plan(tj, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
        _assert_plans_equal(a, b)
        assert a.nnz_pad == b.nnz_pad and a.num_tiles == b.num_tiles
        assert a.padding_overhead == b.padding_overhead


def test_plan_with_empty_blocks_and_single_nonzero_equal():
    idx = np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    a = tst.build_mttkrp_plan(tst.SparseTensor(idx, vals, (300, 4, 4)), 0, tile_nnz=64, rows_per_block=64)
    b = jst.build_mttkrp_plan(jst.SparseTensor(idx, vals, (300, 4, 4)), 0, tile_nnz=64, rows_per_block=64)
    _assert_plans_equal(a, b)
    one = np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32)
    for mode in range(3):
        _assert_plans_equal(
            tst.build_mttkrp_plan(tst.SparseTensor(*one, (11, 6, 9)), mode, tile_nnz=8, rows_per_block=8),
            jst.build_mttkrp_plan(jst.SparseTensor(*one, (11, 6, 9)), mode, tile_nnz=8, rows_per_block=8),
        )


def test_plan_from_numpy_copies_a_jax_plan():
    tj = jst.random_sparse_tensor((30, 20, 10), 200, seed=8)
    t = tst.random_sparse_tensor((30, 20, 10), 200, seed=8)
    jplan = jst.build_mttkrp_plan(tj, 1, tile_nnz=32, rows_per_block=8)
    converted = plan_from_numpy(jplan)
    assert isinstance(converted, tst.MTTKRPPlan)
    _assert_plans_equal(converted, tst.build_mttkrp_plan(t, 1, tile_nnz=32, rows_per_block=8))


def test_hypergraph_stats_and_helpers_equal():
    kw = dict(seed=9, zipf_a=0.9)
    t = tst.random_sparse_tensor((25, 20, 15), 400, **kw)
    tj = jst.random_sparse_tensor((25, 20, 15), 400, **kw)
    assert dataclasses.asdict(t.hypergraph_stats()) == dataclasses.asdict(tj.hypergraph_stats())
    assert t.density == tj.density
    np.testing.assert_array_equal(t.to_dense(), tj.to_dense())
    _assert_tensors_equal(t.mode_sorted(2), tj.mode_sorted(2))


def test_non_lex_ordering_plan_matches_jax_and_unknown_raises():
    """The orderings are ported now (tests/test_torch_reorder.py holds every
    one against JAX): a non-lex plan equals JAX's, and an unknown ordering
    raises as JAX's does."""
    t = tst.random_sparse_tensor((10, 10, 10), 50, seed=0)
    tj = jst.random_sparse_tensor((10, 10, 10), 50, seed=0)
    got = tst.build_mttkrp_plan(t, 0, ordering="degree", device="cpu")
    want = jst.build_mttkrp_plan(tj, 0, ordering="degree")
    np.testing.assert_array_equal(got.sorted_indices, want.sorted_indices)
    with pytest.raises(ValueError, match="unknown ordering"):
        tst.build_mttkrp_plan(t, 0, ordering="random", device="cpu")


def test_frostt_catalog_and_stand_ins_equal():
    assert tfrostt.PAPER_RANK == jfrostt.PAPER_RANK
    assert {k: dataclasses.astuple(v) for k, v in tfrostt.FROSTT_TENSORS.items()} == {
        k: dataclasses.astuple(v) for k, v in jfrostt.FROSTT_TENSORS.items()
    }
    for name in tfrostt.FROSTT_TENSORS:
        assert tsyn.scaled_dims(name, 1e-4) == jsyn.scaled_dims(name, 1e-4)
    for name, scale in [("NELL-2", 2e-6), ("LBNL", 2e-4)]:
        _assert_tensors_equal(
            tsyn.make_frostt_like(name, scale=scale, seed=1, shuffle=True),
            jsyn.make_frostt_like(name, scale=scale, seed=1, shuffle=True),
        )
