"""The port's sharded MTTKRP and CP-ALS (``repro_torch.distributed``) against the JAX package.

On the CPU, with gloo ranks started by ``repro_torch.distributed.spawn``:

  * the partitions, each rank's setup (its shard, the row starts and the
    leftovers) and the per-shard traces are array-equal to the JAX
    package's (those are numpy on both sides);
  * the sharded MTTKRP, both schemes and every mode, matches JAX's
    ``mttkrp_ref`` at ``rtol = atol = 1e-4`` (``tests/test_distributed.py``'s
    tolerance) at world sizes 3 and 8.  The JAX package's own sharded path
    is not the reference: under this JAX version its ``mode_ordered``
    scheme raises;
  * sharded eager and fused CP-ALS, from the JAX package's ``cp_init``
    draws, match JAX's ``cp_als(impl="ref")`` within ``FUSED_FIT_TOL``;
  * the engine's sharded run through its worker prices the hit rates of
    JAX's ``ExecutedTraceHitRates(impl="sharded")`` and reports the share
    of each shard's trace that its plan leaves to the residual pass;
  * what must raise does: no process group, NCCL with more ranks than
    cards, a failing rank, the engine's ``allreduce`` in the native order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import cp_als as jcp
from repro.core.mttkrp import mttkrp_ref as j_mttkrp_ref
from repro.core.sparse_tensor import SparseTensor as JTensor
from repro.distributed import mttkrp_dist as jdist
from repro.dse import evaluate_sweep as j_evaluate_sweep, tech_comparison as j_tech_comparison
from repro.experiments import engine as jengine
from repro.experiments import measure as jmeas
from repro.reorder import nonzero_order as j_nonzero_order

import torch_dist_ranks as ranks
from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import mttkrp as tm
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.data.synthetic_tensors import make_frostt_like, scaled_characteristics
from repro_torch.distributed import mttkrp_dist as tdist
from repro_torch.distributed import backend_for, spawn
from repro_torch.experiments import ExperimentSpec, measure_cp_als, run_experiments
from repro_torch.experiments import measure as tmeas
from repro_torch.perf import report as treport
from repro_torch.reorder import ORDERINGS

TOL = 1e-4  # tests/test_distributed.py
ORDERS = (None,) + ORDERINGS
CASES = ranks.sharded_cases()


def _jax(t) -> JTensor:
    return JTensor(t.indices, t.values, t.shape)


def _case_ids():
    return [f"{t.shape}-{t.nnz}-{o}" for t, _, o, _ in CASES]


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("case", range(len(CASES)), ids=_case_ids())
def test_partitions_and_setups_array_equal_to_jax(case, n):
    t, _, _, rpb = CASES[case]
    j = _jax(t)
    for mode in range(t.nmodes):
        for ordering in ORDERS:
            order = None if ordering is None else j_nonzero_order(j, mode, ordering,
                                                                 rows_per_block=rpb)
            for got, want in zip(tdist.partition_by_output_rows(t, mode, n, order=order),
                                 jdist.partition_by_output_rows(j, mode, n, order=order)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=str((mode, ordering)))
            for scheme in tdist.SCHEMES:
                want = jdist.build_sharded_mode_setup(j, mode, n, scheme=scheme,
                                                      ordering=ordering, rows_per_block=rpb)
                idx, val = np.asarray(want.idx), np.asarray(want.val)
                for r in range(n):
                    got = tdist.build_sharded_mode_setup(
                        t, mode, n, rank=r, scheme=scheme, ordering=ordering,
                        rows_per_block=rpb, device="cpu")
                    assert got.rows_per == want.rows_per and got.i_out == want.i_out
                    if scheme == "allreduce":
                        block = slice(r * got.rows_per, min((r + 1) * got.rows_per, t.nnz))
                        np.testing.assert_array_equal(got.shard.indices, idx[block])
                        np.testing.assert_array_equal(got.shard.values, val[block])
                        continue
                    # The owned real nonzeros of JAX's shard r, in its layout.
                    own = (idx[r, :, mode] // got.rows_per == r) & (val[r] != 0)
                    shard_idx = got.shard.indices.copy()
                    shard_idx[:, mode] += got.row_base
                    np.testing.assert_array_equal(shard_idx, idx[r][own])
                    np.testing.assert_array_equal(got.shard.values, val[r][own])
                    assert got.row_base % rpb == 0 and got.block_offset < rpb
                    np.testing.assert_array_equal(got.row_start, np.asarray(want.row_start))
                    if want.leftover_idx is None:
                        assert got.leftovers is None and got.leftover_plan is None
                    else:
                        np.testing.assert_array_equal(got.leftovers.indices,
                                                      np.asarray(want.leftover_idx))
                        np.testing.assert_array_equal(got.leftovers.values,
                                                      np.asarray(want.leftover_val))


@pytest.mark.parametrize("scheme", tdist.SCHEMES)
@pytest.mark.parametrize("ordering", ORDERS)
def test_sharded_traces_equal_jax_and_each_shard_plan_runs_its_trace(ordering, scheme):
    for t, _, _, rpb in CASES[::2] + CASES[-1:]:
        j = _jax(t)
        for n in (3, 8):
            for mode in range(t.nmodes):
                got = tmeas.executed_input_traces(t, "sharded", mode, scheme=scheme, n_shards=n,
                                                  ordering=ordering, rows_per_block=rpb,
                                                  device="cpu")
                want = jmeas.executed_input_traces(j, "sharded", mode, scheme=scheme,
                                                   n_shards=n, ordering=ordering,
                                                   rows_per_block=rpb)
                assert sorted(got) == sorted(want)
                for k in got:
                    assert len(got[k]) == len(want[k]) == n
                    for a, b in zip(got[k], want[k]):
                        np.testing.assert_array_equal(a, b)
                order = None if ordering is None else j_nonzero_order(j, mode, ordering,
                                                                     rows_per_block=rpb)
                idx_s, val_s, _ = tdist.partition_by_output_rows(t, mode, n, order=order)
                for r in range(n):
                    setup = tdist.build_sharded_mode_setup(
                        t, mode, n, rank=r, scheme=scheme, ordering=ordering,
                        rows_per_block=rpb, device="cpu")
                    if scheme == "mode_ordered":
                        # The shard's trace without its leftovers, which the
                        # residual pass runs.
                        keep = (val_s[r] != 0) & (idx_s[r, :, mode] // setup.rows_per == r)
                        expect = idx_s[r][keep]
                    else:  # the shard's equal block of the raw (or strategy) order
                        per = -(-t.nnz // n)
                        pos = np.arange(t.nnz) if order is None else order
                        pos = pos[r * per:(r + 1) * per]
                        if ordering is None:  # the raw block, as its lex plan runs it
                            pos = pos[np.argsort(t.indices[pos, mode], kind="stable")]
                        expect = t.indices[pos[t.values[pos] != 0]]
                    for k in got:
                        np.testing.assert_array_equal(
                            setup.plan.executed_row_trace(k, include_padding=False),
                            expect[:, k], err_msg=str((mode, r, k)))
                    assert setup.plan.rows_contiguous == (ordering != "blocked")


def _jax_refs():
    """JAX ``mttkrp_ref`` of every case, each mode twice (one per scheme)."""
    refs = []
    for t, facs, _, _ in CASES:
        j = _jax(t)
        for mode in range(t.nmodes):
            if facs[0].ndim == 3:
                want = np.stack([np.asarray(j_mttkrp_ref(j, [jnp.asarray(f[b]) for f in facs],
                                                          mode))
                                 for b in range(facs[0].shape[0])])
            else:
                want = np.asarray(j_mttkrp_ref(j, [jnp.asarray(f) for f in facs], mode))
            refs += [want, want]
    return refs


@pytest.mark.parametrize("world", [3, 8])
def test_sharded_mttkrp_matches_jax_ref(world):
    results = spawn(ranks.sharded_outputs, world, device="cpu",
                           backend=backend_for("cpu", world), args=(CASES, "cpu"))
    refs = _jax_refs()
    for rank, res in enumerate(results):
        assert res["launches"] == 0  # the CPU runs the plain version
        assert res["repeat"]  # mode_ordered is bit for bit repeatable
        assert len(res["outs"]) == len(refs)
        for i, (got, want) in enumerate(zip(res["outs"], refs)):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"rank {rank} #{i}")
    # mode_ordered's blocks are disjoint: every rank holds the same bits.
    for res in results[1:]:
        for i in range(1, len(refs), 2):
            np.testing.assert_array_equal(res["outs"][i], results[0]["outs"][i])


def test_sharded_cp_als_matches_jax_ref():
    t = random_sparse_tensor((30, 25, 20), 1200, seed=5, zipf_a=0.8, shuffle=True)
    j = _jax(t)
    seeds, iters = (2, 3), 5
    inits = [[np.asarray(f) for f in jcp.cp_init(j, 6, seed=s)] for s in seeds]
    want = [jcp.cp_als(j, 6, n_iters=iters, tol=0.0, seed=s, impl="ref").fits for s in seeds]
    results = spawn(ranks.sharded_cp_als, 3, device="cpu", backend="gloo",
                           args=(t, 6, inits, iters, "cpu"))
    for out in results[1:]:  # factors and fits are replicated
        for scheme, fits in out.items():
            for got, first in zip(fits, results[0][scheme]):
                np.testing.assert_array_equal(got, first)
    for scheme, (eager, fused) in results[0].items():
        np.testing.assert_allclose(eager, want[0], atol=tfused.FUSED_FIT_TOL, rtol=0,
                                   err_msg=scheme)
        assert fused.shape == (len(seeds), iters)
        for r in range(len(seeds)):
            np.testing.assert_allclose(fused[r], want[r], atol=tfused.FUSED_FIT_TOL, rtol=0,
                                       err_msg=scheme)


def test_engine_sharded_run_through_the_worker_prices_jax_traces():
    spec = ExperimentSpec(tensors=(("NELL-2", 1e-4),), impls=("sharded",), n_iters=2,
                          n_shards=4, device="cpu")
    result = run_experiments(spec)
    (run,) = result.runs
    assert run.impl == "sharded" and np.isfinite(run.measured.fit)
    assert run.measured.launches_per_rank is None  # counted on the card only
    assert all(m.calls == 2 for m in run.measured.modes)
    assert run.measured.fused_max_fit_delta <= tfused.FUSED_FIT_TOL
    # JAX's pricing of the same partition: its trace cache, one unit per shard.
    t = make_frostt_like("NELL-2", scale=1e-4, seed=0)
    ft = scaled_characteristics("NELL-2", t, scale=1e-4)
    jcache = jmeas.ExecutedTraceHitRates(_jax(t), "sharded", scheme="mode_ordered", n_shards=4)
    j_evaluate_sweep(j_tech_comparison(list(jengine.ALL_TECHS), rank=spec.rank),
                     {ft.name: ft}, cache=jcache)
    want = jengine._reconcile_hit_rates(jcache, ft, spec.rank)
    assert len(run.hit_rates) == len(want) > 0
    for got, w in zip(run.hit_rates, want):
        assert (got.mode, got.capacity_bytes, got.trace_length) == (w.mode, w.capacity_bytes,
                                                                    w.trace_length)
        assert got.trace == w.trace and got.trace_warm == w.trace_warm
    # The engine reports the part of each shard's trace its plan leaves to
    # the residual pass, per mode, and the report renders it.
    assert run.residual_share == tuple(
        tuple(tdist.residual_shares(t, m, 4).tolist()) for m in range(t.nmodes))
    payload = result.to_json_dict()
    assert payload["runs"][0]["residual_share"] == [list(x) for x in run.residual_share]
    assert "Sharded traces the shard plans do not run" in treport.experiments_report_md(payload)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("case", range(len(CASES)), ids=_case_ids())
def test_residual_shares_are_the_leftovers_of_jax_partition(case, n):
    """Per shard, the share of its JAX trace (real nonzeros) outside its
    equal-height block: the part of the priced trace the shard's plan
    leaves to the residual pass."""
    t = CASES[case][0]
    for mode in range(t.nmodes):
        idx, val, _ = jdist.partition_by_output_rows(_jax(t), mode, n)
        rows_per = -(-t.shape[mode] // n)
        real = val != 0
        left = real & (idx[..., mode] // rows_per != np.arange(n)[:, None])
        want = left.sum(axis=1) / np.maximum(real.sum(axis=1), 1)
        np.testing.assert_array_equal(tdist.residual_shares(t, mode, n), want)


def test_engine_refuses_allreduce_in_the_native_order():
    """Under allreduce the native order's trace is the raw COO block, which
    no plan runs as is: the engine would price hit rates no run produced."""
    with pytest.raises(ValueError, match="allreduce.*explicit ordering"):
        ExperimentSpec(impls=("sharded",), scheme="allreduce", device="cpu")
    with pytest.raises(ValueError, match="allreduce.*explicit ordering"):
        ExperimentSpec(impls=("sharded",), scheme="allreduce", orderings=("lex", None),
                       device="cpu")
    spec = ExperimentSpec(impls=("sharded",), scheme="allreduce", orderings=("lex",),
                          device="cpu")
    assert spec.orderings == ("lex",)
    # The kernel and ref impls, and mode_ordered, keep the native order.
    ExperimentSpec(impls=("ref", "kernel"), scheme="allreduce", device="cpu")
    ExperimentSpec(impls=("sharded",), device="cpu")


def test_sharded_entry_points_without_a_process_group_raise():
    t = random_sparse_tensor((10, 9, 8), 60, seed=0)
    facs = [torch.rand(s, 4) for s in t.shape]
    for call in (lambda: tm.mttkrp(t, facs, 0, impl="sharded"),
                 lambda: tcp.cp_als(t, 4, impl="sharded", device="cpu"),
                 lambda: tfused.FusedCPALS(t, 4, impl="sharded", device="cpu"),
                 lambda: measure_cp_als(t, name="x", impl="sharded", device="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group") as err:
            call()
        assert "repro_torch.distributed.spawn" in str(err.value)


def test_nccl_is_refused_with_more_ranks_than_cards(monkeypatch):
    with pytest.raises(ValueError, match="device='cuda'"):
        spawn(ranks.failing_rank, 2, device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank of a group on a card"):
        spawn(ranks.failing_rank, 2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        spawn(ranks.failing_rank, 2, device="cpu", backend="mpi")
    assert backend_for("cpu", 1) == "gloo"
    assert backend_for("cuda", 1) == "nccl"
    assert backend_for("cuda", 4) == "gloo"


def test_a_failing_rank_fails_spawn():
    with pytest.raises(Exception, match="rank 1 planted failure"):
        spawn(ranks.failing_rank, 2, device="cpu", backend="gloo")
