"""The port's MTTKRP against the JAX package's, on the CPU.

On CPU tensors the port's kernel path (``impl="kernel"``) runs the CUDA
kernel's plain PyTorch version over the same plan buffers; it is held
against JAX ``mttkrp_ref``, ``dense_mttkrp_oracle`` and the Pallas kernel
in interpret mode, with the tolerances of tests/test_mttkrp_kernel.py:
1e-4 for float32 factors, 3e-2 for bfloat16.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import mttkrp as jm
from repro.core import sparse_tensor as jst
from repro.kernels.mttkrp import mttkrp_pallas
from repro_torch.convert import factors_from_numpy
from repro_torch.core import mttkrp as tm
from repro_torch.core import sparse_tensor as tst
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref

F32_TOL = 1e-4
BF16_TOL = 3e-2


def _pair(shape, nnz, seed, **kw):
    return (
        tst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
        jst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
    )


def _pair_from(idx, vals, shape):
    return tst.SparseTensor(idx, vals, shape), jst.SparseTensor(idx, vals, shape)


def _np_factors(shape, rank, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [rng.standard_normal(lead + (s, rank)).astype(np.float32) for s in shape]


def _check_kernel_vs_pallas(t, tj, rank, *, mode=0, tile_nnz=256, rows_per_block=64, seed=0):
    """Port impl='kernel' (plain version on CPU) vs the Pallas kernel (interpret)."""
    facs = _np_factors(t.shape, rank, seed)
    got = tm.mttkrp(
        t, factors_from_numpy(facs, device="cpu"), mode, impl="kernel",
        tile_nnz=tile_nnz, rows_per_block=rows_per_block,
    ).numpy()
    want = np.asarray(
        mttkrp_pallas(
            tj, [jnp.asarray(f) for f in facs], mode, tile_nnz=tile_nnz,
            rows_per_block=rows_per_block, backend="interpret",
        )
    )
    assert got.shape == want.shape == (t.shape[mode], rank)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    return got


def test_ref_matches_jax_ref_and_dense_oracles():
    t, tj = _pair((13, 7, 9), 60, seed=1)
    facs = _np_factors(t.shape, 4, seed=1)
    tf = factors_from_numpy(facs, device="cpu")
    for mode in range(3):
        got = tm.mttkrp_ref(t, tf, mode).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jm.mttkrp_ref(tj, [jnp.asarray(f) for f in facs], mode)),
            rtol=F32_TOL, atol=F32_TOL,
        )
        np.testing.assert_allclose(
            tm.dense_mttkrp_oracle(t.to_dense(), facs, mode),
            jm.dense_mttkrp_oracle(tj.to_dense(), facs, mode),
            rtol=F32_TOL, atol=F32_TOL,
        )
        np.testing.assert_allclose(
            got, tm.dense_mttkrp_oracle(t.to_dense(), facs, mode), rtol=2e-4, atol=2e-4
        )


def test_khatri_rao_matches_jax():
    mats = _np_factors((3, 4, 5), 6, seed=2)
    np.testing.assert_allclose(
        tm.khatri_rao([torch.from_numpy(m) for m in mats]).numpy(),
        np.asarray(jm.khatri_rao([jnp.asarray(m) for m in mats])),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_kernel_path_matches_pallas_3mode(mode):
    t, tj = _pair((70, 33, 41), 800, seed=3)
    _check_kernel_vs_pallas(t, tj, 16, mode=mode, tile_nnz=128, rows_per_block=64)


@pytest.mark.parametrize("nm,shape", [(4, (20, 15, 10, 8)), (5, (9, 8, 7, 6, 5))])
def test_kernel_path_4mode_and_5mode(nm, shape):
    t, tj = _pair(shape, 300, seed=nm)
    for mode in range(nm):
        _check_kernel_vs_pallas(t, tj, 8, mode=mode, tile_nnz=64, rows_per_block=32)


def test_kernel_path_matches_jax_ref_on_zipf_tensor():
    t, tj = _pair((60, 50, 40), 1500, seed=11, zipf_a=0.85, shuffle=True)
    facs = _np_factors(t.shape, 16, seed=11)
    tf = factors_from_numpy(facs, device="cpu")
    for mode in range(3):
        np.testing.assert_allclose(
            tm.mttkrp(t, tf, mode, impl="kernel", tile_nnz=64, rows_per_block=16).numpy(),
            np.asarray(jm.mttkrp_ref(tj, [jnp.asarray(f) for f in facs], mode)),
            rtol=F32_TOL, atol=F32_TOL,
        )


def test_bf16_factors():
    t, tj = _pair((40, 30, 20), 400, seed=7)
    facs = [f.astype(jnp.bfloat16) for f in _np_factors(t.shape, 16, seed=7)]
    want = np.asarray(
        mttkrp_pallas(tj, [jnp.asarray(f) for f in facs], 0, tile_nnz=128,
                      rows_per_block=64, backend="interpret"),
        np.float32,
    )
    tf = factors_from_numpy([np.asarray(f, np.float32) for f in facs], device="cpu",
                            dtype=torch.bfloat16)
    got = tm.mttkrp(t, tf, 0, impl="kernel", tile_nnz=128, rows_per_block=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


def test_empty_blocks_are_zeroed():
    idx = np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32)
    t, tj = _pair_from(idx, np.array([1.0, 2.0, 3.0], np.float32), (300, 4, 4))
    got = _check_kernel_vs_pallas(t, tj, 8, tile_nnz=64, rows_per_block=64, seed=9)
    assert np.all(got[100:200] == 0.0)


def test_single_nonzero_tensor():
    t, tj = _pair_from(np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32), (11, 6, 9))
    got = _check_kernel_vs_pallas(t, tj, 8)
    assert (np.abs(got).sum(axis=1) > 0).sum() == 1


@pytest.mark.parametrize("rank", [1, 128])
def test_rank_one_and_full_lane(rank):
    t, tj = _pair((30, 20, 10), 200, seed=21)
    _check_kernel_vs_pallas(t, tj, rank, tile_nnz=64, rows_per_block=16)


def test_all_nonzeros_in_one_output_block():
    rng = np.random.default_rng(4)
    idx = np.stack(
        [rng.integers(0, 16, size=300), rng.integers(0, 40, size=300), rng.integers(0, 40, size=300)],
        axis=1,
    ).astype(np.int32)
    t, tj = _pair_from(idx, rng.standard_normal(300).astype(np.float32), (256, 40, 40))
    got = _check_kernel_vs_pallas(t, tj, 16)
    assert np.all(got[16:] == 0.0)


def test_nnz_smaller_than_tile():
    t, tj = _pair((40, 30, 20), 5, seed=13)
    _check_kernel_vs_pallas(t, tj, 16, tile_nnz=256, rows_per_block=64)


def test_single_tile_single_block():
    t, tj = _pair((30, 20, 10), 40, seed=31)
    _check_kernel_vs_pallas(t, tj, 8, tile_nnz=64, rows_per_block=32, seed=31)


def test_t0_wrap_every_nonzero_in_block_zero_over_many_tiles():
    rng = np.random.default_rng(32)
    idx = np.stack(
        [rng.integers(0, 30, size=300), rng.integers(0, 25, size=300), rng.integers(0, 25, size=300)],
        axis=1,
    ).astype(np.int32)
    t, tj = _pair_from(idx, rng.standard_normal(300).astype(np.float32), (32, 25, 25))
    _check_kernel_vs_pallas(t, tj, 8, tile_nnz=64, rows_per_block=32, seed=32)


@pytest.mark.parametrize("mode", [0, 2])
def test_batched_factors_match_per_restart_jax_loop(mode):
    t, tj = _pair((35, 25, 30), 600, seed=14, zipf_a=0.7)
    facs = _np_factors(t.shape, 8, seed=14, batch=3)
    got = tm.mttkrp(
        t, factors_from_numpy(facs, device="cpu"), mode, impl="kernel",
        tile_nnz=64, rows_per_block=16,
    ).numpy()
    assert got.shape == (3, t.shape[mode], 8)
    for b in range(3):
        want = np.asarray(jm.mttkrp_ref(tj, [jnp.asarray(f[b]) for f in facs], mode))
        np.testing.assert_allclose(got[b], want, rtol=F32_TOL, atol=F32_TOL)
    ref_batched = tm.mttkrp_ref(t, factors_from_numpy(facs, device="cpu"), mode).numpy()
    np.testing.assert_allclose(ref_batched, got, rtol=F32_TOL, atol=F32_TOL)


def test_plan_ref_chunking_changes_nothing_beyond_reassociation():
    t, _ = _pair((50, 40, 30), 700, seed=15)
    plan = tst.build_mttkrp_plan(t, 1, tile_nnz=32, rows_per_block=16)
    bufs = tops.plan_device_buffers(plan, "cpu")
    tf = factors_from_numpy(_np_factors(t.shape, 8, seed=15), device="cpu")
    whole = mttkrp_plan_ref(bufs, tf, 1, t.shape[1])
    chunked = mttkrp_plan_ref(bufs, tf, 1, t.shape[1], nnz_chunk=100)
    assert whole.dtype == torch.float32 and whole.shape == (t.shape[1], 8)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_plan_device_buffers_uploaded_once_with_block_offsets():
    t, _ = _pair((40, 30, 20), 200, seed=22)
    plan = tst.build_mttkrp_plan(t, 0, tile_nnz=64, rows_per_block=8)
    a = tops.plan_device_buffers(plan, "cpu")
    assert tops.plan_device_buffers(plan, torch.device("cpu")) is a
    for buf, host in [
        (a.indices, plan.sorted_indices),
        (a.values, plan.sorted_values),
        (a.local_row, plan.local_row),
    ]:
        np.testing.assert_array_equal(buf.numpy(), host)
    start = a.block_nnz_start.numpy()
    assert start.dtype == np.int64 and start.shape == (plan.num_blocks + 1,)
    assert start[0] == 0 and start[-1] == plan.nnz_pad
    for b in range(plan.num_blocks):
        rows = plan.sorted_indices[start[b] : start[b + 1], 0]
        assert np.all(rows // plan.rows_per_block == b)
    assert a.rows_per_block == 8
    assert a.index_bound == tuple(int(m) + 1 for m in plan.sorted_indices.max(axis=0))
    plan2 = tst.build_mttkrp_plan(t, 0, tile_nnz=64, rows_per_block=8)
    assert tops.plan_device_buffers(plan2, "cpu") is not a


def test_plan_with_out_of_range_index_is_refused():
    bad = tst.SparseTensor(np.array([[0, 9, 0]], np.int32), np.ones(1, np.float32), (4, 4, 4))
    with pytest.raises(ValueError, match="outside"):
        tops.plan_device_buffers(tst.build_mttkrp_plan(bad, 0, tile_nnz=8, rows_per_block=8), "cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU buffers raise."""
    t, _ = _pair((20, 10, 10), 50, seed=23)
    plan = tst.build_mttkrp_plan(t, 0, tile_nnz=32, rows_per_block=8)
    bufs = tops.plan_device_buffers(plan, "cpu")
    tf = factors_from_numpy(_np_factors(t.shape, 4), device="cpu")
    before = tkernel.mttkrp_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.mttkrp_cuda(bufs, tf, 0, t.shape[0])
    assert tkernel.mttkrp_cuda.launches == before


@pytest.mark.parametrize(
    "rank,rows_per_block,want", [(16, 256, 16), (128, 256, 64), (1, 8, 1), (64, 1024, 56)]
)
def test_rank_chunk_fits_shared_memory(rank, rows_per_block, want):
    chunk = tkernel.rank_chunk(rank, rows_per_block)
    assert chunk == want
    assert 4 * rows_per_block * chunk <= tkernel.SHARED_MEMORY_LIMIT


def test_mttkrp_dispatch_errors():
    t, _ = _pair((10, 10, 10), 40, seed=24)
    tf = factors_from_numpy(_np_factors(t.shape, 4), device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        tm.mttkrp(t, tf, 0, impl="sharded")
    with pytest.raises(ValueError, match="unknown impl"):
        tm.mttkrp(t, tf, 0, impl="pallas")
    with pytest.raises(NotImplementedError, match="lex"):
        tm.mttkrp(t, tf, 0, impl="ref", ordering="degree")
    with pytest.raises(NotImplementedError, match="lex"):
        tm.mttkrp(t, tf, 0, impl="kernel", ordering="degree")
