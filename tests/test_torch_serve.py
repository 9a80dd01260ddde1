"""The port's CP-ALS service against the JAX package's, on the CPU.

``MultiTensorCPALS.run_batch`` runs on the same padded numpy operands and
initial factors as the JAX executor; on CPU tensors every mode's MTTKRP is
the plain version over the batch's stacked plan, the same buffers the
split kernel takes on the card.  Tolerances: per-sweep fits within
``FUSED_FIT_TOL``; factors after one sweep within 1e-4 relative (float32);
each mode's stacked MTTKRP within 1e-4 of JAX ``mttkrp_ref`` per tensor.
Budgets are fixed (``n_iters``); iteration counts are never compared.

The service invariants of tests/test_serve.py (pad-slot exclusion,
backpressure, duplicate and invalid requests, the randomised soak,
deterministic replay, metrics) run on the port with ``device="cpu"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cp_als as jcp
from repro.core import cp_als_fused as jfused
from repro.core import mttkrp as jm
from repro.core import sparse_tensor as jst
from repro.kernels.mttkrp import ops as jops
from repro.runtime.metrics import MetricsLogger as JaxMetricsLogger
from repro import serve as jserve
from repro_torch.convert import bucket_from_numpy, factors_from_numpy
from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import sparse_tensor as tst
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp import partition
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch import serve as tserve
from repro_torch.serve import service as tservice
from tests.property_compat import given, settings, st

FIT_TOL = tfused.FUSED_FIT_TOL
F32_TOL = 1e-4


def _pair(shape, nnz, seed, **kw):
    return (
        tst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
        jst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
    )


def _request(i, dims=(19, 15, 12), nnz=120, rank=4, n_iters=2, seed=None, tseed=None):
    tensor = tst.random_sparse_tensor(dims, nnz, seed=i if tseed is None else tseed)
    return tserve.DecompRequest(
        request_id=f"r{i}",
        tensor=tensor,
        rank=rank,
        n_iters=n_iters,
        seed=i * 7 + 1 if seed is None else seed,
    )


def _assert_parity(resp, req):
    """A served response against a standalone port run on the same seed."""
    ref = tfused.cp_als_fused(req.tensor, req.rank, n_iters=req.n_iters, tol=0.0,
                              seed=req.seed, impl="kernel", device="cpu")
    delta = np.max(np.abs(np.asarray(resp.state.fits) - ref.fits[0]))
    assert delta <= FIT_TOL, (req.request_id, delta)
    assert [tuple(f.shape) for f in resp.state.factors] == [(d, req.rank) for d in req.tensor.shape]
    assert tuple(resp.state.weights.shape) == (req.rank,)
    assert len(resp.state.fits) == req.n_iters


# -- MultiTensorCPALS against the JAX executor --------------------------------

# name -> (per-tensor (shape, nnz, rank), batch padded to)
BATCHES = {
    "3 modes, heterogeneous, pad slot, rank padding": (
        [((19, 15, 12), 150, 4), ((22, 13, 14), 170, 3), ((17, 16, 10), 200, 4)], 4),
    "3 modes, all-empty tail blocks": (  # mode 0 bands to 2048: blocks 5-7 hold no row
        [((1100, 15, 12), 400, 5), ((1050, 13, 14), 350, 6)], 2),
    "4 modes": ([((11, 9, 8, 7), 90, 3), ((12, 10, 7, 6), 110, 3)], 3),
}


def _bucket(name, seed=0):
    """Both packages' tensors, the bucket signature, padded numpy operands
    and the JAX cp_init draws padded to the bucket (pad slots replay 0)."""
    specs, pad_to = BATCHES[name]
    pairs = [_pair(shape, nnz, seed=seed + i, zipf_a=0.7) for i, (shape, nnz, _) in enumerate(specs)]
    ranks = [r for _, _, r in specs]
    jreqs = [jserve.DecompRequest(f"j{i}", tj, rank=r, seed=11 + i)
             for i, ((_, tj), r) in enumerate(zip(pairs, ranks))]
    sigs = {jserve.bucket_signature(r) for r in jreqs}
    assert len(sigs) == 1, sigs
    sig = sigs.pop()
    order = list(range(len(pairs))) + [0] * (pad_to - len(pairs))
    ops = [jops.tensor_device_operands(pairs[i][1], nnz_pad=sig.nnz_pad) for i in order]
    inits = [[np.pad(np.asarray(f), ((0, sig.dims[k] - f.shape[0]), (0, sig.rank_pad - f.shape[1])))
              for k, f in enumerate(jcp.cp_init(jreqs[i].tensor, ranks[i], seed=jreqs[i].seed))]
             for i in order]
    return dict(
        sig=sig,
        port_tensors=[pairs[i][0] for i in order],
        jax_tensors=[pairs[i][1] for i in order],
        indices=np.stack([np.asarray(o.indices) for o in ops]),
        values=np.stack([np.asarray(o.values) for o in ops]),
        norm2=np.stack([np.asarray(o.norm2) for o in ops]),
        factors=[np.stack([init[k] for init in inits]) for k in range(sig.nmodes)],
    )


def _run_both(b, n_iters):
    sig = b["sig"]
    jf, jw, jfits = jfused.MultiTensorCPALS(sig.dims, nnz_pad=sig.nnz_pad, rank=sig.rank_pad).run_batch(
        jnp.asarray(b["indices"]), jnp.asarray(b["values"]), jnp.asarray(b["norm2"]),
        [jnp.asarray(f) for f in b["factors"]], n_iters=n_iters)
    idx, vals, n2, facs = bucket_from_numpy(b["indices"], b["values"], b["norm2"], b["factors"],
                                            device="cpu")
    nnz = [t.nnz for t in b["port_tensors"]]
    plans = [tops.stacked_plan_buffers(idx, vals, nnz, sig.dims, m) for m in range(sig.nmodes)]
    tf, tw, tfits = tfused.MultiTensorCPALS(sig.dims, nnz_pad=sig.nnz_pad, rank=sig.rank_pad).run_batch(
        idx, vals, n2, facs, n_iters=n_iters, plans=plans)
    return (jf, jw, np.asarray(jfits)), (tf, tw, tfits.numpy())


@pytest.mark.parametrize("name", list(BATCHES))
def test_run_batch_fits_match_jax_run_batch(name):
    b = _bucket(name)
    (_, _, jfits), (tf, tw, tfits) = _run_both(b, n_iters=4)
    assert tfits.shape == jfits.shape == (len(b["port_tensors"]), 4)
    np.testing.assert_allclose(tfits, jfits, atol=FIT_TOL, rtol=0)
    assert tf[0].device.type == "cpu" and tw.shape == (len(b["port_tensors"]), b["sig"].rank_pad)


@pytest.mark.parametrize("name", list(BATCHES))
def test_run_batch_one_sweep_factors_match_jax(name):
    (jf, jw, _), (tf, tw, _) = _run_both(_bucket(name, seed=3), n_iters=1)
    for got, want in zip(tf, jf):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=F32_TOL, atol=1e-6)


@pytest.mark.parametrize("name", list(BATCHES))
def test_stacked_mttkrp_matches_jax_mttkrp_ref_per_tensor(name):
    b = _bucket(name, seed=5)
    sig = b["sig"]
    batch = len(b["port_tensors"])
    rng = np.random.default_rng(1)
    facs = [rng.standard_normal((batch, d, sig.rank_pad)).astype(np.float32) for d in sig.dims]
    ex = tfused.MultiTensorCPALS(sig.dims, nnz_pad=sig.nnz_pad, rank=sig.rank_pad)
    for mode in range(sig.nmodes):
        plan = _stacked_plan(b["port_tensors"], sig.dims, mode)
        got = ex._mttkrp(plan, factors_from_numpy(facs, device="cpu"), mode).numpy()
        for i, tj in enumerate(b["jax_tensors"]):
            # The tensor at the padded shape: its rows past the true dims get zeros.
            padded = jst.SparseTensor(tj.indices, tj.values, sig.dims)
            want = jm.mttkrp_ref(padded, [jnp.asarray(f[i]) for f in facs], mode)
            np.testing.assert_allclose(got[i], np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_multi_tensor_executor_rejects_geometry_mismatch():
    ex = tfused.MultiTensorCPALS((16, 16, 16), nnz_pad=64, rank=4)
    n2 = torch.ones(2)
    factors = tuple(torch.zeros(2, 16, 4) for _ in range(3))
    with pytest.raises(ValueError, match="indices shape"):
        ex.run_batch(torch.zeros(2, 32, 3, dtype=torch.int32), torch.zeros(2, 32), n2, factors,
                     n_iters=1, plans=[])
    idx, val = torch.zeros(2, 64, 3, dtype=torch.int32), torch.zeros(2, 64)
    with pytest.raises(ValueError, match="factor 0"):
        ex.run_batch(idx, val, n2, (torch.zeros(2, 16, 8),) + factors[1:], n_iters=1, plans=[])
    with pytest.raises(ValueError, match="stacked plans"):
        ex.run_batch(idx, val, n2, factors, n_iters=1, plans=[])
    with pytest.raises(ValueError, match="n_iters"):
        ex.run_batch(idx, val, n2, factors, n_iters=0, plans=[])
    for kw in (dict(nnz_pad=0, rank=4), dict(nnz_pad=64, rank=0)):
        with pytest.raises(ValueError):
            tfused.MultiTensorCPALS((16, 16, 16), **kw)


def test_fit_over_distinct_tensors_matches_jax_per_tensor():
    b = _bucket("3 modes, heterogeneous, pad slot, rank padding", seed=7)
    idx, vals, n2, facs = bucket_from_numpy(b["indices"], b["values"], b["norm2"], b["factors"],
                                            device="cpu")
    w = torch.rand((idx.shape[0], b["sig"].rank_pad), generator=torch.Generator().manual_seed(2))
    got = tcp._fit(n2, idx, vals, facs, w)
    chunked = tcp._fit(n2, idx, vals, facs, w, nnz_chunk=37)
    recon = tcp.reconstruct_values(idx, facs, w)
    for i in range(idx.shape[0]):
        jf = [jnp.asarray(f[i]) for f in b["factors"]]
        want = jcp._fit(jnp.asarray(b["norm2"][i]), jnp.asarray(b["indices"][i]),
                        jnp.asarray(b["values"][i]), jf, jnp.asarray(w[i].numpy()))
        np.testing.assert_allclose(got[i].item(), float(want), atol=1e-5)
        np.testing.assert_allclose(chunked[i].item(), float(want), atol=1e-5)
        want_r = jcp.reconstruct_values(jnp.asarray(b["indices"][i]), jf, jnp.asarray(w[i].numpy()))
        np.testing.assert_allclose(recon[i].numpy(), np.asarray(want_r), rtol=1e-5, atol=1e-6)


# -- stacked plans --------------------------------------------------------------

def _stacked_case():
    """Heterogeneous tensors of one bucket, with a pad slot: mode 0 bands to
    2048 rows, so each tensor's rows end in whole empty blocks."""
    dims = (2048, 32, 64)
    tensors = [tst.random_sparse_tensor(shape, nnz, seed=s, zipf_a=0.9)
               for s, (shape, nnz) in enumerate([((1100, 20, 40), 600), ((1300, 30, 50), 900),
                                                 ((1030, 17, 33), 300)])]
    return dims, tensors + [tensors[0]]


def _stacked_plan(tensors, dims, mode, nnz_pad=1024):
    idx, vals, _ = tops.stacked_operands(tensors, dims, nnz_pad, device="cpu")
    return tops.stacked_plan_buffers(idx, vals, [t.nnz for t in tensors], dims, mode)


def _block_diagonal(tensors, dims):
    """The B tensors as one tensor of shape ``B * dims``, tensor ``b``'s
    coordinates offset by ``b * dims[k]``."""
    idx = np.concatenate([t.indices + b * np.asarray(dims, dtype=np.int32)
                          for b, t in enumerate(tensors)])
    return tst.SparseTensor(idx.astype(np.int32), np.concatenate([t.values for t in tensors]),
                            tuple(len(tensors) * d for d in dims))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_stacked_plan_keeps_padding_detectable_and_offsets_real_entries(mode):
    """The device-built stacked plan is the host plan of the block-diagonal
    tensor, up to more padding at the end of its last block, and its
    ``block_real_end`` counts exactly each block's real nonzeros."""
    dims, tensors = _stacked_case()
    bufs = _stacked_plan(tensors, dims, mode)
    host = tst.build_mttkrp_plan(_block_diagonal(tensors, dims), mode,
                                 rows_per_block=bufs.rows_per_block)
    n = host.nnz_pad
    np.testing.assert_array_equal(bufs.indices[:n].numpy(), host.sorted_indices)
    np.testing.assert_array_equal(bufs.values[:n].numpy(), host.sorted_values)
    np.testing.assert_array_equal(bufs.local_row[:n].numpy(), host.local_row)
    start = tops.block_nnz_start(host)
    np.testing.assert_array_equal(bufs.block_nnz_start[:-1].numpy(), start[:-1])
    np.testing.assert_array_equal(bufs.block_real_end.numpy(), tops.block_real_end(host))
    # What the blocks leave of the fixed length is padding of the last block.
    length = int(bufs.block_nnz_start[-1])
    assert length == bufs.values.shape[0] >= n and (length - n) % 256 == 0
    assert not bufs.values[n:].any() and not bufs.local_row[n:].any()
    last_row = (host.num_blocks - 1) * host.rows_per_block
    assert bool((bufs.indices[n:, mode] == last_row).all())
    # Each tensor's real entries, in its own row and factor ranges.
    rows = bufs.indices[partition.real_mask(bufs)]
    tenant = torch.div(rows[:, mode], dims[mode], rounding_mode="floor")
    for k, d in enumerate(dims):
        assert bool((torch.div(rows[:, k], d, rounding_mode="floor") == tenant).all())
    assert sorted(tenant.unique().tolist()) == list(range(len(tensors)))
    assert bufs.index_bound == tuple(len(tensors) * d for d in dims)


SLICES = (1, 7, 64, 300)


def test_split_partition_over_stacked_plan_stores_every_row_once():
    dims, tensors = _stacked_case()
    rank, batch = 8, len(tensors)
    rng = np.random.default_rng(3)
    facs = [torch.from_numpy(rng.standard_normal((batch * d, rank)).astype(np.float32))
            for d in dims]
    crossed = False
    for mode in range(3):
        bufs = _stacked_plan(tensors, dims, mode)
        i_out = batch * dims[mode]
        want = mttkrp_plan_ref(bufs, facs, mode, i_out)
        per = torch.zeros_like(want)
        for b, t in enumerate(tensors):
            own = [f[b * d : b * d + s] for f, d, s in zip(facs, dims, t.shape)]
            lo = b * dims[mode]
            per[lo : lo + t.shape[mode]] = mttkrp_plan_ref(
                tops.plan_device_buffers(tst.build_mttkrp_plan(t, mode), "cpu"), own, mode,
                t.shape[mode])
        np.testing.assert_allclose(want.numpy(), per.numpy(), rtol=F32_TOL, atol=F32_TOL)
        for slices in SLICES:
            out, stores, carry_rows = partition.emulate_split(bufs, facs, mode, i_out, slices)[:3]
            assert stores.tolist() == [1] * i_out, f"mode {mode}, {slices} slices"
            np.testing.assert_allclose(out.numpy(), per.numpy(), rtol=F32_TOL, atol=F32_TOL)
            first, last = carry_rows[:, 0], np.where(carry_rows[:, 1] >= 0, carry_rows[:, 1],
                                                      carry_rows[:, 0])
            crossed |= bool(((first >= 0) & (first // dims[mode] != last // dims[mode])).any())
    assert crossed, "no slice holds two tenants' rows"


def test_stacked_operands_match_jax_padding_and_refuse_what_the_kernel_cannot_take():
    (t, tj), (u, uj) = _pair((12, 10, 8), 50, seed=3), _pair((9, 16, 5), 40, seed=4)
    idx, vals, n2 = tops.stacked_operands([t, u, t], (16, 16, 8), 64, device="cpu")
    assert idx.shape == (3, 64, 3) and idx.dtype == torch.int32 and vals.shape == (3, 64)
    for b, want in enumerate([tj, uj, tj]):
        ja = jops.tensor_device_operands(want, nnz_pad=64)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ja.indices))
        np.testing.assert_array_equal(vals[b].numpy(), np.asarray(ja.values))
        np.testing.assert_allclose(n2[b].item(), float(ja.norm2), rtol=1e-6)
    with pytest.raises(ValueError, match="does not fit"):
        tops.stacked_operands([t], (8, 16, 8), 64, device="cpu")
    with pytest.raises(ValueError, match="nnz_pad"):
        tops.stacked_operands([t], (16, 16, 8), 32, device="cpu")
    bad = tst.SparseTensor(t.indices.copy(), t.values, t.shape)
    bad.indices[7, 2] = -1
    with pytest.raises(ValueError, match="outside"):
        tops.stacked_operands([bad], (16, 16, 8), 64, device="cpu")
    bad.indices[7, 2] = 8
    with pytest.raises(ValueError, match="outside"):
        tops.stacked_operands([bad], (16, 16, 8), 64, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tops.stacked_operands([], (16, 16, 8), 64, device="cpu")
    with pytest.raises(ValueError, match="nonzero counts"):
        tops.stacked_plan_buffers(idx, vals, [t.nnz], (16, 16, 8), 0)
    with pytest.raises(ValueError, match="overflows"):
        tops.stacked_plan_buffers(idx, vals, [t.nnz, u.nnz, t.nnz], (2**30, 16, 8), 0)


def test_tensor_device_operands_memo_and_padding_match_jax():
    t, tj = _pair((12, 10, 8), 50, seed=3)
    a = tops.tensor_device_operands(t, nnz_pad=64, device="cpu")
    assert tops.tensor_device_operands(t, nnz_pad=64, device="cpu") is a
    c = tops.tensor_device_operands(t, nnz_pad=128, device="cpu")
    assert c is not a and a.nnz_pad == 64 and c.nnz_pad == 128
    ja = jops.tensor_device_operands(tj, nnz_pad=64)
    np.testing.assert_array_equal(a.indices.numpy(), np.asarray(ja.indices))
    np.testing.assert_array_equal(a.values.numpy(), np.asarray(ja.values))
    np.testing.assert_allclose(a.norm2.item(), float(ja.norm2), rtol=1e-6)
    assert tops.tensor_device_operands(t, device="cpu").nnz_pad == t.nnz
    with pytest.raises(ValueError, match="nnz_pad"):
        tops.tensor_device_operands(t, nnz_pad=t.nnz - 1, device="cpu")


# -- signatures, traces, metrics against JAX --------------------------------------

@settings(max_examples=40, deadline=None)
@given(
    d0=st.integers(1, 5000), d1=st.integers(1, 300), d2=st.integers(1, 70),
    nnz=st.integers(1, 100_000), rank=st.integers(1, 40), n_iters=st.integers(0, 12),
    tile=st.sampled_from([None, 1, 64, 96, 256]),
)
def test_geometry_signature_matches_jax(d0, d1, d2, nnz, rank, n_iters, tile):
    got = tserve.geometry_signature((d0, d1, d2), nnz, rank, n_iters, tile_align=tile)
    want = jserve.geometry_signature((d0, d1, d2), nnz, rank, n_iters, tile_align=tile)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("dims,nnz,rank", [((19, 15, 12), 150, 5), ((5, 4, 3), 20, 1),
                                           ((11, 9, 8, 7), 90, 3), ((40, 30, 25), 300, 6)])
def test_bucket_signature_matches_jax(dims, nnz, rank):
    t, tj = _pair(dims, nnz, seed=4)
    got = tserve.bucket_signature(tserve.DecompRequest("a", t, rank=rank, n_iters=4))
    want = jserve.bucket_signature(jserve.DecompRequest("a", tj, rank=rank, n_iters=4))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(ValueError, match="tile_align"):
        tserve.bucket_signature(tserve.DecompRequest("a", t, rank=rank), tile_align=0)


def _traffic(module, **kw):
    cfg = dict(n_requests=8, base_dims=(20, 16, 14), nnz_range=(80, 140), ranks=(3, 4),
               n_iters=2, seed=5)
    cfg.update(kw)
    return module.synthetic_trace(module.TrafficConfig(**cfg))


@pytest.mark.parametrize("kw", [{}, dict(zipf_a=None, seed=9, base_dims=(12, 10, 9, 8))])
def test_synthetic_trace_matches_jax(kw):
    got, want = _traffic(tserve, **kw), _traffic(jserve, **kw)
    assert len(got) == len(want)
    for (a, r), (aj, rj) in zip(got, want):
        assert a == aj and r.request_id == rj.request_id
        assert (r.rank, r.n_iters, r.seed) == (rj.rank, rj.n_iters, rj.seed)
        assert r.tensor.shape == rj.tensor.shape
        np.testing.assert_array_equal(r.tensor.indices, rj.tensor.indices)
        np.testing.assert_array_equal(r.tensor.values, rj.tensor.values)
    with pytest.raises(ValueError, match="n_requests"):
        tserve.synthetic_trace(tserve.TrafficConfig(n_requests=0))


def test_metrics_logger_matches_jax():
    rows = [dict(latency=float(i % 17) + 0.5, batch=i % 3) for i in range(60)]
    for capacity in (None, 10):
        ours, theirs = MetricsLogger("t", capacity=capacity, quiet=True), JaxMetricsLogger(
            "t", capacity=capacity, quiet=True)
        for i, r in enumerate(rows):
            ours.log(i, **r)
            theirs.log(i, **r)
        assert [{k: v for k, v in r.items() if k != "t"} for r in ours.rows] == [
            {k: v for k, v in r.items() if k != "t"} for r in theirs.rows]
        assert ours.total_logged == theirs.total_logged == 60
        for q in (0, 50, 99, 100):
            assert ours.percentile("latency", q) == theirs.percentile("latency", q)
        assert ours.summary("latency") == theirs.summary("latency")
        assert ours.summary("missing") == theirs.summary("missing")
    assert MetricsLogger.SUMMARY_STATS == JaxMetricsLogger.SUMMARY_STATS
    with pytest.raises(ValueError, match="no values"):
        MetricsLogger("t", quiet=True).percentile("missing", 50)
    with pytest.raises(ValueError, match="capacity"):
        MetricsLogger("t", capacity=0)


def test_metrics_logger_prints_rows_unless_quiet(capsys):
    MetricsLogger("svc").log(3, latency=0.25, batch=2)
    MetricsLogger("svc", quiet=True).log(4, latency=0.5)
    assert capsys.readouterr().out == "[svc] step=3 latency=0.25 batch=2\n"


# -- the whole service against JAX's ----------------------------------------------

def test_service_matches_jax_service(monkeypatch):
    """Both services take one trace in full, then drain: same batches, same
    signatures, fits within FUSED_FIT_TOL from the same (JAX) initial draws."""
    def jax_init(tensor, rank, *, seed, dtype, device):
        draws = jcp.cp_init(jst.SparseTensor(tensor.indices, tensor.values, tensor.shape), rank,
                            seed=seed)
        return [torch.from_numpy(np.array(f)).to(device=device, dtype=dtype) for f in draws]

    monkeypatch.setattr(tservice, "cp_init", jax_init)
    kw = dict(n_requests=10, base_dims=(30, 22, 18), nnz_range=(150, 400), ranks=(3, 5),
              n_iters=3, seed=2)
    ours = tserve.DecompositionService(max_batch=4, device="cpu")
    theirs = jserve.DecompositionService(max_batch=4)
    done = tserve.replay_trace(ours, _traffic(tserve, **kw), time_scale=0.0)
    want = jserve.replay_trace(theirs, _traffic(jserve, **kw), time_scale=0.0)
    assert sorted(done) == sorted(want) and len(done) == 10
    assert len({r.signature for r in done.values()}) > 1  # more than one bucket
    for rid, resp in done.items():
        w = want[rid]
        assert dataclasses.astuple(resp.signature) == dataclasses.astuple(w.signature)
        assert resp.batch_size == w.batch_size
        np.testing.assert_allclose(resp.state.fits, w.state.fits, atol=FIT_TOL, rtol=0)
        assert [tuple(f.shape) for f in resp.state.factors] == [
            tuple(f.shape) for f in w.state.factors]


# -- the JAX suite's service invariants, on the port ---------------------------------

def test_single_request_bucket_parity():
    svc = tserve.DecompositionService(max_batch=4, device="cpu")
    req = _request(0, dims=(23, 17, 11), nnz=150, rank=5, n_iters=3)
    assert svc.submit(req)
    done = svc.run_until_drained()
    assert set(done) == {"r0"} and done["r0"].batch_size == 1
    _assert_parity(done["r0"], req)


def test_padded_bucket_parity_heterogeneous_tensors():
    svc = tserve.DecompositionService(max_batch=4, device="cpu")
    reqs = [
        _request(0, dims=(19, 15, 12), nnz=150, rank=4),
        _request(1, dims=(22, 13, 14), nnz=170, rank=4),
        _request(2, dims=(17, 16, 10), nnz=200, rank=4),
        _request(3, dims=(20, 12, 16), nnz=160, rank=4),
    ]
    assert len({tserve.bucket_signature(r) for r in reqs}) == 1
    for r in reqs:
        assert svc.submit(r)
    done = svc.run_until_drained()
    assert len(done) == 4
    for r in reqs:
        assert done[r.request_id].batch_size == 4
        _assert_parity(done[r.request_id], r)


def test_mixed_rank_bucket_parity():
    svc = tserve.DecompositionService(max_batch=4, device="cpu")
    reqs = [_request(0, rank=3, n_iters=3), _request(1, rank=4, n_iters=3),
            _request(2, rank=3, n_iters=3)]
    assert len({tserve.bucket_signature(r) for r in reqs}) == 1
    for r in reqs:
        assert svc.submit(r)
    done = svc.run_until_drained()
    assert {done[r.request_id].batch_size for r in reqs} == {3}
    for r in reqs:
        _assert_parity(done[r.request_id], r)


def test_pad_slot_exclusion():
    svc = tserve.DecompositionService(max_batch=8, device="cpu")
    reqs = [_request(i) for i in range(3)]
    for r in reqs:
        assert svc.submit(r)
    done = svc.run_until_drained()
    assert sorted(done) == ["r0", "r1", "r2"]
    assert all(done[r.request_id].batch_size == 3 for r in reqs)
    assert svc.metrics.total_logged == 3
    for r in reqs:
        _assert_parity(done[r.request_id], r)


def test_multiple_buckets_and_four_modes_parity():
    svc = tserve.DecompositionService(max_batch=4, device="cpu")
    reqs = [
        _request(0, dims=(19, 15, 12), nnz=150, rank=4),
        _request(1, dims=(40, 30, 25), nnz=300, rank=6, n_iters=3),
        _request(2, dims=(19, 14, 13), nnz=160, rank=4),
        _request(3, dims=(11, 9, 8, 7), nnz=90, rank=3, n_iters=3),
    ]
    assert len({tserve.bucket_signature(r) for r in reqs}) == 3
    for r in reqs:
        assert svc.submit(r)
    done = svc.run_until_drained()
    assert len(done) == 4 and done["r1"].batch_size == 1
    for r in reqs:
        _assert_parity(done[r.request_id], r)


@settings(max_examples=6, deadline=None)
@given(
    order_seed=st.integers(0, 2**16),
    max_batch=st.sampled_from([1, 2, 4]),
    max_inflight=st.sampled_from([1, 2]),
)
def test_soak_invariants_randomized_arrival_order(order_seed, max_batch, max_inflight):
    """No drop, no double answer, in-flight bounded, every admitted request completes."""
    reqs = [
        _request(i, dims=(13, 11, 9), nnz=60, rank=3, n_iters=2)
        if i % 3
        else _request(i, dims=(26, 22, 18), nnz=120, rank=3, n_iters=2)
        for i in range(10)
    ]
    order = np.random.default_rng(order_seed).permutation(len(reqs))
    svc = tserve.DecompositionService(max_batch=max_batch, max_inflight=max_inflight, device="cpu")
    for j in order:
        assert svc.submit(reqs[j])
    assert svc.admitted == len(reqs)
    ticks = 0
    while True:
        more = svc.tick()
        assert svc.in_flight <= max_inflight
        ticks += 1
        assert ticks < 10_000, "service failed to drain"
        if not more:
            break
    assert sorted(svc.completed) == sorted(r.request_id for r in reqs)
    assert svc.metrics.total_logged == len(reqs)
    assert svc.rejected == 0


def test_soak_trace_replay_deterministic_and_complete():
    t1, t2 = _traffic(tserve), _traffic(tserve)
    assert [r.request_id for _, r in t1] == [r.request_id for _, r in t2]
    for (a1, r1), (a2, r2) in zip(t1, t2):
        assert a1 == a2 and r1.rank == r2.rank and r1.seed == r2.seed
        np.testing.assert_array_equal(r1.tensor.indices, r2.tensor.indices)
    svc = tserve.DecompositionService(max_batch=4, max_inflight=2, device="cpu")
    done = tserve.replay_trace(svc, t1, time_scale=0.0)
    assert sorted(done) == sorted(r.request_id for _, r in t1)
    assert svc.rejected == 0
    paced = tserve.DecompositionService(max_batch=4, device="cpu")
    assert sorted(tserve.replay_trace(paced, _traffic(tserve, seed=6), time_scale=2.0)) == sorted(
        r.request_id for _, r in _traffic(tserve, seed=6))


def test_backpressure_rejects_on_full_queue():
    svc = tserve.DecompositionService(max_batch=2, max_queue=2, device="cpu")
    assert svc.submit(_request(0)) and svc.submit(_request(1))
    assert not svc.submit(_request(2))
    assert svc.rejected == 1
    assert sorted(svc.run_until_drained()) == ["r0", "r1"]


def test_duplicate_request_id_refused():
    svc = tserve.DecompositionService(device="cpu")
    assert svc.submit(_request(0))
    with pytest.raises(ValueError, match="duplicate request_id"):
        svc.submit(_request(0))
    svc.run_until_drained()
    with pytest.raises(ValueError, match="duplicate request_id"):
        svc.submit(_request(0))


def test_invalid_requests_and_settings_refused():
    svc = tserve.DecompositionService(device="cpu")
    empty = tst.SparseTensor(np.zeros((0, 3), np.int32), np.zeros((0,), np.float32), (4, 4, 4))
    with pytest.raises(ValueError, match="at least one nonzero"):
        svc.submit(tserve.DecompRequest("e", empty, rank=2))
    with pytest.raises(ValueError, match="rank"):
        svc.submit(tserve.DecompRequest("k", _request(0).tensor, rank=0))
    with pytest.raises(ValueError, match="n_iters"):
        svc.submit(tserve.DecompRequest("i", _request(0).tensor, rank=2, n_iters=0))
    for kw in (dict(max_batch=0), dict(max_inflight=0), dict(max_queue=0)):
        with pytest.raises(ValueError):
            tserve.DecompositionService(device="cpu", **kw)
    ex = tserve.BucketExecutor(tserve.bucket_signature(_request(0)), device=torch.device("cpu"))
    with pytest.raises(ValueError, match="batch size"):
        ex.launch([], pad_to=2)


def test_service_keeps_nothing_of_answered_requests():
    """A request's operands and plans live as long as its batch: after N
    distinct requests are answered, no memo holds any of their tensors."""
    tops.clear_caches()
    svc = tserve.DecompositionService(max_batch=2, max_inflight=2, device="cpu")
    reqs = [_request(i) for i in range(5)]
    for r in reqs:
        assert svc.submit(r)
    assert sorted(svc.run_until_drained()) == sorted(r.request_id for r in reqs)
    caches = (tops._PLAN_CACHE, tops._BUFFER_CACHE, tops._OPERAND_CACHE)
    assert sum(len(c) for c in caches) == 0
    assert all(s is None for s in svc._slots) and not svc._queue


def test_service_metrics_report_percentiles():
    svc = tserve.DecompositionService(max_batch=2, device="cpu")
    for i in range(4):
        svc.submit(_request(i))
    svc.run_until_drained()
    lat = svc.metrics.summary("latency_s")
    assert lat["count"] == 4 and 0.0 < lat["p50"] <= lat["p99"]
    waits = svc.metrics.values("queue_wait_s")
    assert len(waits) == 4 and all(w >= 0.0 for w in waits)
    for resp in svc.completed.values():
        assert resp.latency_s == pytest.approx(resp.queue_wait_s + resp.service_s)


def test_custom_metrics_backend_and_duck_typed_autotuner():
    class Tuner:
        def config_for(self, tensor, rank):
            return dataclasses.make_dataclass("Cfg", [("tile_nnz", int)])(96)

    log = MetricsLogger("svc", capacity=2, quiet=True)
    svc = tserve.DecompositionService(max_batch=1, metrics=log, autotuner=Tuner(), device="cpu")
    for i in range(3):
        svc.submit(_request(i))
    done = svc.run_until_drained()
    assert log.total_logged == 3 and len(log.rows) == 2
    assert all(r.signature.nnz_pad % 96 == 0 for r in done.values())
    _assert_parity(done["r0"], _request(0))
