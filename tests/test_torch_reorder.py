"""The port's nonzero orderings against the JAX package's, on the CPU.

Orders, relabelings, traces and plans must be array-equal to the
reference for every ordering; MTTKRP and fused CP-ALS with an ordering
within the JAX tests' tolerances (1e-4 for f32 MTTKRP, ``FUSED_FIT_TOL``
for fits).  The split kernel's two modes are replayed on the CPU
(``partition``): the row-run mode stores a ``blocked`` plan's rows more
than once, which is why its wrapper refuses such a plan, and the tile mode
stores every output row of every ordering exactly once.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import cp_als as jcp
from repro.core import cp_als_fused as jfused
from repro.core import hypergraph as jhyper
from repro.core import mttkrp as jmttkrp
from repro.core import sparse_tensor as jst
from repro.reorder import strategies as js
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import hypergraph as thyper
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import sparse_tensor as tst
from repro_torch.kernels.mttkrp import kernel as kmod
from repro_torch.kernels.mttkrp import ops, partition
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
from repro_torch.reorder import strategies as ts

ORDERINGS = ("lex", "secondary-sort", "degree", "blocked")
MTTKRP_TOL = 1e-4
CASES = [  # (shape, nnz, seed, random_sparse_tensor kwargs)
    ((60, 50, 70), 3000, 0, dict(zipf_a=0.9)),
    ((20, 18, 16, 14), 2000, 1, {}),
    ((300, 40, 500), 8000, 2, dict(zipf_a=1.1, shuffle=True)),
]


def _pair(shape, nnz, seed, **kw):
    return (tst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
            jst.random_sparse_tensor(shape, nnz, seed=seed, **kw))


def _factors(shape, rank, seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [rng.standard_normal(lead + (s, rank)).astype(np.float32) for s in shape]


def _rows_contiguous(plan) -> bool:
    """Whether every output row's real nonzeros form one run of the stream."""
    rows = plan.sorted_indices[plan.sorted_values != 0, plan.mode]
    runs = 1 + int(np.count_nonzero(rows[1:] != rows[:-1])) if rows.size else 0
    return runs == np.unique(rows).size


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_nonzero_order_matches_jax(ordering):
    for shape, nnz, seed, kw in CASES:
        t, tj = _pair(shape, nnz, seed, **kw)
        for mode in range(len(shape)):
            for rpb, block_rows in [(256, 128), (16, 8), (7, 3)]:
                want = js.nonzero_order(tj, mode, ordering, rows_per_block=rpb,
                                        block_rows=block_rows)
                got = ts.nonzero_order(t, mode, ordering, rows_per_block=rpb,
                                       block_rows=block_rows, device="cpu")
                assert got.dtype == np.int64
                np.testing.assert_array_equal(got, want)
            if ordering != "lex":
                for primary in (k for k in range(len(shape)) if k != mode):
                    np.testing.assert_array_equal(
                        ts.nonzero_order(t, mode, ordering, primary_input=primary, device="cpu"),
                        js.nonzero_order(tj, mode, ordering, primary_input=primary))


def test_nonzero_order_tensor_stays_on_its_device_and_rejects_bad_args():
    t, _ = _pair((30, 20, 10), 500, 3)
    idx = torch.from_numpy(t.indices)
    order = ts.nonzero_order_tensor(idx, t.shape, 1, "blocked", rows_per_block=8)
    assert order.dtype == torch.int64 and order.device == idx.device
    np.testing.assert_array_equal(
        order.numpy(), ts.nonzero_order(t, 1, "blocked", rows_per_block=8, device="cpu"))
    with pytest.raises(ValueError, match="unknown ordering"):
        ts.nonzero_order(t, 0, "random", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        ts.nonzero_order(t, 3, "lex", device="cpu")
    with pytest.raises(ValueError, match="primary_input"):
        ts.nonzero_order(t, 0, "degree", primary_input=0, device="cpu")


def test_nonzero_order_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, _ = _pair((10, 9, 8), 60, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.nonzero_order(t, 0, "degree")
    with pytest.raises(RuntimeError, match="cuda"):
        tst.build_mttkrp_plan(t, 0, ordering="blocked")
    # The lex plan sorts on the host, as before.
    assert tst.build_mttkrp_plan(t, 0).ordering == "lex"


@pytest.mark.parametrize("strategy", ORDERINGS)
def test_relabelings_match_jax(strategy):
    for shape, nnz, seed, kw in CASES:
        t, tj = _pair(shape, nnz, seed, **kw)
        for mode in range(len(shape)):
            np.testing.assert_array_equal(ts.degree_reorder(t, mode), js.degree_reorder(tj, mode))
        for modes in (None, [0], [1, 2]):
            got, got_perms = ts.reorder_tensor(t, modes, strategy=strategy)
            want, want_perms = js.reorder_tensor(tj, modes, strategy=strategy)
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(got.values, want.values)
            for a, b in zip(got_perms, want_perms):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ordering", (None,) + ORDERINGS)
def test_prepare_execution_matches_jax(ordering):
    t, tj = _pair((40, 30, 20), 900, 4, zipf_a=0.8)
    got, got_perms = ts.prepare_execution(t, ordering)
    want, want_perms = js.prepare_execution(tj, ordering)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    assert (got_perms is None) == (want_perms is None)
    for a, b in zip(got_perms or [], want_perms or []):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown ordering"):
        ts.prepare_execution(t, "nope")


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_traces_match_jax(ordering):
    for shape, nnz, seed, kw in CASES:
        t, tj = _pair(shape, nnz, seed, **kw)
        view = ts.trace_view(t, 0, ordering, rows_per_block=16, block_rows=8, device="cpu")
        want = js.trace_view(tj, 0, ordering, rows_per_block=16, block_rows=8)
        np.testing.assert_array_equal(view.indices, want.indices)
        np.testing.assert_array_equal(view.values, want.values)
        for out_mode in range(len(shape)):
            for in_mode in (k for k in range(len(shape)) if k != out_mode):
                np.testing.assert_array_equal(
                    ts.mode_trace(t, out_mode, in_mode, strategy=ordering, device="cpu"),
                    js.mode_trace(tj, out_mode, in_mode, strategy=ordering))
                ordered = ts.apply_nonzero_order(t, ts.nonzero_order(t, out_mode, ordering,
                                                                     device="cpu"))
                assert ordered.nnz == t.nnz


def test_hypergraph_shim_matches_jax():
    t, tj = _pair((40, 30, 20), 900, 5, zipf_a=0.8)
    np.testing.assert_array_equal(thyper.degree_reorder(t, 1), jhyper.degree_reorder(tj, 1))
    np.testing.assert_array_equal(thyper.reorder_tensor(t)[0].indices,
                                  jhyper.reorder_tensor(tj)[0].indices)
    np.testing.assert_array_equal(thyper.mode_trace(t, 0, 2, secondary_sort=True, device="cpu"),
                                  jhyper.mode_trace(tj, 0, 2, secondary_sort=True))


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_plans_match_jax(ordering):
    for shape, nnz, seed, kw in CASES:
        t, tj = _pair(shape, nnz, seed, **kw)
        for mode in range(len(shape)):
            for tile, rpb in [(256, 256), (8, 16), (32, 7)]:
                got = tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb,
                                            ordering=ordering, device="cpu")
                want = jst.build_mttkrp_plan(tj, mode, tile_nnz=tile, rows_per_block=rpb,
                                             ordering=ordering)
                for field in ("sorted_indices", "sorted_values", "local_row", "tile_block"):
                    np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
                assert (got.num_blocks, got.ordering) == (want.num_blocks, want.ordering)
                assert got.rows_contiguous == (ordering != "blocked")
                if got.rows_contiguous:
                    assert _rows_contiguous(got)
                bufs = ops.plan_device_buffers(got, "cpu")
                assert bufs.rows_contiguous == got.rows_contiguous
                np.testing.assert_array_equal(bufs.block_nnz_start.numpy(), ops.block_nnz_start(got))


def test_blocked_plans_break_row_contiguity():
    """The fault the tile mode exists for: blocked plans bring rows back."""
    t, _ = _pair((600, 500, 700), 40_000, 1, zipf_a=0.8)
    for mode in range(3):
        plan = tst.build_mttkrp_plan(t, mode, tile_nnz=32, rows_per_block=64,
                                     ordering="blocked", device="cpu")
        assert not _rows_contiguous(plan)


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_mttkrp_with_ordering_matches_jax(ordering, impl):
    t, tj = _pair((50, 40, 60), 4000, 6, zipf_a=0.9)
    facs = _factors(t.shape, 8, seed=1)
    jax_kw = dict(impl="ref") if impl == "ref" else dict(impl="pallas", backend="xla",
                                                        tile_nnz=32, rows_per_block=16)
    port_kw = {} if impl == "ref" else dict(tile_nnz=32, rows_per_block=16)
    for mode in range(3):
        want = np.asarray(jmttkrp.mttkrp(tj, [jnp.asarray(f) for f in facs], mode,
                                         ordering=ordering, **jax_kw))
        got = tmttkrp.mttkrp(t, [torch.from_numpy(f) for f in facs], mode, impl=impl,
                             ordering=ordering, **port_kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=MTTKRP_TOL, atol=MTTKRP_TOL)


def test_ordered_ref_view_is_memoized():
    t, _ = _pair((30, 20, 10), 500, 7)
    a = tmttkrp._ordered_ref_view(t, 1, "degree", torch.device("cpu"))
    assert tmttkrp._ordered_ref_view(t, 1, "degree", torch.device("cpu")) is a
    np.testing.assert_array_equal(
        a.indices, t.indices[ts.nonzero_order(t, 1, "degree", device="cpu")])


def _jax_init(tj, rank, seed):
    return [np.asarray(f) for f in jcp.cp_init(tj, rank, seed=seed)]


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("impl,jax_kw", [("ref", dict(impl="ref")),
                                         ("kernel", dict(impl="pallas", backend="xla"))])
def test_fused_with_ordering_matches_jax(ordering, impl, jax_kw):
    t, tj = _pair((28, 22, 18), 900, 6, zipf_a=0.7)
    jr = jfused.FusedCPALS(tj, 5, ordering=ordering, tile_nnz=32, rows_per_block=8,
                           **jax_kw).run(n_iters=5, tol=0.0, seed=3, restarts=2, fit_every=5)
    inits = [_jax_init(tj, 5, seed=s) for s in (3, 4)]
    ex = tfused.FusedCPALS(t, 5, impl=impl, device="cpu", ordering=ordering, tile_nnz=32,
                           rows_per_block=8)
    pr = ex.run(n_iters=5, tol=0.0, fit_every=5, init_factors=inits)
    assert ex.ordering == ordering
    if impl == "kernel":
        assert [p.ordering for p in ex._plans] == [ordering] * 3
    np.testing.assert_allclose(pr.fits, jr.fits, atol=tfused.FUSED_FIT_TOL, rtol=0)
    one = tfused.cp_als_fused(t, 5, n_iters=5, tol=0.0, impl=impl, device="cpu",
                              ordering=ordering, tile_nnz=32, rows_per_block=8,
                              init_factors=inits[:1])
    np.testing.assert_allclose(one.fits[0], jr.fits[0], atol=tfused.FUSED_FIT_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_fused_ordering_none_is_the_lex_path_bit_for_bit(impl):
    t, _ = _pair((25, 20, 15), 700, 8, zipf_a=0.6)
    init = [_factors(t.shape, 4, seed=2)]
    base = tfused.cp_als_fused(t, 4, n_iters=4, tol=0.0, impl=impl, device="cpu",
                               init_factors=init)
    if impl == "kernel":  # the lex plan, as the executor always built it
        again = tfused.cp_als_fused(t, 4, n_iters=4, tol=0.0, impl=impl, device="cpu",
                                    ordering="lex", init_factors=init)
    else:  # the fit's own COO stream, unpermuted
        ex = tfused.FusedCPALS(t, 4, impl=impl, device="cpu")
        assert all(s[0] is ex._indices for s in ex._ref_streams)
        again = ex.run(n_iters=4, tol=0.0, init_factors=init)
    np.testing.assert_array_equal(again.fits, base.fits)
    for a, b in zip(again.state.factors, base.state.factors):
        assert torch.equal(a, b)


# --- the split kernel's two modes, replayed on the CPU ------------------------


def _plan_bufs(t, mode, ordering, tile, rpb):
    plan = tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb, ordering=ordering,
                                 device="cpu")
    return ops.plan_device_buffers(plan, "cpu")


def _scale(bufs, facs, mode, i_out):
    """Per element, the MTTKRP of |values| and |factors|: the sum of the
    absolute terms, which bounds the error of summing them in any order."""
    return mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                           mode, i_out)


def test_row_run_mode_stores_blocked_rows_more_than_once_and_is_refused():
    t, _ = _pair((600, 500, 700), 40_000, 1, zipf_a=0.8)
    facs = [torch.from_numpy(f) for f in _factors(t.shape, 16, seed=0)]
    for mode in range(3):
        bufs = _plan_bufs(t, mode, "blocked", 32, 64)
        assert not bufs.rows_contiguous
        _, stores, _ = partition.emulate_split(bufs, facs, mode, t.shape[mode], 37)[:3]
        assert int(stores.max()) > 1
        with pytest.raises(ValueError, match="row-run mode"):
            kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode], split_mode="rows")
        assert kmod.split_mode_for(bufs, None) == "tiles"
        lex = _plan_bufs(t, mode, "lex", 32, 64)
        assert kmod.split_mode_for(lex, None) == "rows"
        assert kmod.split_mode_for(lex, "tiles") == "tiles"
    with pytest.raises(ValueError, match="unknown split mode"):
        kmod.split_mode_for(lex, "runs")
    with pytest.raises(ValueError, match="split variant"):
        kmod.mttkrp_cuda(lex, facs, 0, t.shape[0], variant="block", split_mode="tiles")


def _tiles_ok(bufs, facs, mode, i_out, replay):
    """Every output element stored exactly once, and within MTTKRP_TOL of
    the sum of absolute terms of the plain version."""
    want = mttkrp_plan_ref(bufs, facs, mode, i_out)
    diff = (replay.out - want).abs()
    return (int(replay.stores.min()) == int(replay.stores.max()) == 1
            and bool((diff <= MTTKRP_TOL * _scale(bufs, facs, mode, i_out) + 1e-30).all()))


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("batch", [None, 3])
def test_tile_mode_stores_every_row_once(ordering, batch):
    """37 slices, one and four restarts a pass (at B = 3 the one pass of
    four is ragged)."""
    t, _ = _pair((600, 500, 700), 40_000, 1, zipf_a=0.8)
    facs = [torch.from_numpy(f) for f in _factors(t.shape, 16, seed=1, batch=batch)]
    for mode in range(3):
        bufs = _plan_bufs(t, mode, ordering, 32, 64)
        i_out = t.shape[mode]
        for b_pass in (1, 4):
            replay = partition.emulate_tiles(bufs, facs, mode, i_out, 37, b_pass)
            assert replay.stores.shape == replay.out.shape[:-1]
            assert _tiles_ok(bufs, facs, mode, i_out, replay), (mode, b_pass)
        if ordering != "blocked":  # the row-run mode is right for these
            want = mttkrp_plan_ref(bufs, facs, mode, i_out)
            got, runs, _ = partition.emulate_split(bufs, facs, mode, i_out, 37)[:3]
            assert int(runs.max()) == 1
            assert bool(((got - want).abs() <= MTTKRP_TOL * _scale(bufs, facs, mode, i_out)
                         + 1e-30).all())


def _edges_tensor(rng, n0=3000):
    rows = np.concatenate([rng.integers(0, 16, n0),  # block 0: shared by many slices
                           rng.integers(64, 80, 40),  # blocks 1-3 empty, block 4 small
                           rng.integers(160, 176, 5)])  # a block of mostly padding
    idx = np.stack([rows, rng.integers(0, 30, rows.size), rng.integers(0, 20, rows.size)], 1)
    return tst.SparseTensor(idx.astype(np.int32),
                            rng.standard_normal(rows.size).astype(np.float32), (200, 30, 20))


def test_tile_mode_partition_edges():
    """Slices that start and end inside one block, a block shared by more
    than two slices, empty blocks, and slice boundaries inside padding."""
    t = _edges_tensor(np.random.default_rng(9))
    facs = [torch.from_numpy(f) for f in _factors(t.shape, 16, seed=2)]
    bufs = _plan_bufs(t, 0, "blocked", 8, 16)
    start = bufs.block_nnz_start.numpy()
    real_end = bufs.block_real_end.numpy()
    for slices in (5, 64, 700):
        bounds = partition.slice_bounds(int(bufs.values.shape[0]), slices)
        blk = np.searchsorted(start, bounds[:-1], side="right") - 1
        inner = (bounds[:-1] > start[blk]) & (bounds[1:] < start[blk + 1])
        per_block = np.bincount(blk, minlength=start.size - 1)
        in_padding = (bounds[1:-1] >= real_end[blk[1:]]) & (bounds[1:-1] < start[blk[1:] + 1])
        if slices >= 64:
            assert inner.any() and per_block.max() > 2 and in_padding.any()
        assert (real_end == start[:-1]).any()  # empty blocks (padding only)
        replay = partition.emulate_tiles(bufs, facs, 0, t.shape[0], slices)
        assert _tiles_ok(bufs, facs, 0, t.shape[0], replay)
        assert bool((replay.out[16:64] == 0).all())  # empty blocks are stored as zeros
        if slices >= 64:
            assert (replay.carry_blocks[:, 0] == 0).sum() > 2  # block 0's carries, many slices
    # Fewer nonzeros than slices: empty slices hold nothing.
    few = tst.SparseTensor(t.indices[:3], np.ones(3, np.float32), (200, 30, 20))
    fb = _plan_bufs(few, 0, "blocked", 8, 16)
    replay = partition.emulate_tiles(fb, facs, 0, 200, 1000)
    assert int(replay.stores.min()) == int(replay.stores.max()) == 1
    np.testing.assert_allclose(replay.out.numpy(), mttkrp_plan_ref(fb, facs, 0, 200).numpy(),
                               rtol=1e-5, atol=1e-6)


def _band_cells(rng):
    """Block 0's 16 rows over 256 cells of input bands (32 x 8 bands of 128
    rows), two or three nonzeros in each: a step's 8 entries span several
    cells, its rows descend at each band change, and rows of the band
    before come back after it."""
    rows = rng.integers(0, 16, 600)
    idx = np.stack([rows, rng.integers(0, 4096, 600), rng.integers(0, 1024, 600)], 1)
    return tst.SparseTensor(idx.astype(np.int32), rng.standard_normal(600).astype(np.float32),
                            (16, 4096, 1024))


def _boundaries_in_padding(bufs, bounds):
    start, real_end = bufs.block_nnz_start.numpy(), bufs.block_real_end.numpy()
    inner = bounds[1:-1]
    blk = np.searchsorted(start, inner, side="right") - 1
    return bool(((inner > real_end[blk]) & (inner < start[blk + 1])).any())


# name -> (tensor maker, rows_per_block, tile_nnz, slices, batch, b_pass, premise)
TILE_REPLAY_CASES = {
    "a row repeated among one warp step's entries": (
        _band_cells, 16, 8, 3, None, 1, lambda bufs, bounds, r: r.repeated_rows > 0
        and r.max_turns >= 2),
    "slices that start or end in padding": (
        lambda rng: _edges_tensor(rng), 16, 8, 64, None, 1,
        lambda bufs, bounds, r: _boundaries_in_padding(bufs, bounds)),
    "fewer nonzeros than slices": (
        lambda rng: _edges_tensor(rng, 30), 16, 8, 200, None, 1,
        lambda bufs, bounds, r: int(bufs.values.shape[0]) < 200),
    "B = 3 with b_pass 4 (a ragged restart group)": (
        lambda rng: _edges_tensor(rng), 16, 8, 64, 3, 4, lambda bufs, bounds, r: True),
    # The card's grid takes 3 restarts a pass at 1024 rows a block
    # (tests/test_torch_kernel_cuda.py::test_tile_grid_on_the_card), so B = 4
    # runs a pass of 3 and a pass of 1.
    "fewer than 4 restarts fit one pass (rows_per_block 1024)": (
        lambda rng: tst.random_sparse_tensor((3000, 60, 50), 20_000, seed=3, zipf_a=0.8),
        1024, 64, 29, 4, 3, lambda bufs, bounds, r: True),
}


@pytest.mark.parametrize("name", list(TILE_REPLAY_CASES))
def test_tile_mode_replay_edges(name):
    make, rpb, tile_nnz, slices, batch, b_pass, premise = TILE_REPLAY_CASES[name]
    t = make(np.random.default_rng(11))
    facs = [torch.from_numpy(f) for f in _factors(t.shape, 16, seed=3, batch=batch)]
    reached = []  # the case's edge, per mode
    for mode in range(t.nmodes):
        bufs = _plan_bufs(t, mode, "blocked", tile_nnz, rpb)
        replay = partition.emulate_tiles(bufs, facs, mode, t.shape[mode], slices, b_pass)
        bounds = partition.slice_bounds(int(bufs.values.shape[0]), slices)
        reached.append(premise(bufs, bounds, replay))
        assert _tiles_ok(bufs, facs, mode, t.shape[mode], replay), mode
    assert any(reached)
