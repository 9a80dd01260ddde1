"""The port's CP-ALS, eager and fused, against the JAX package's, on the CPU.

Both sides start from the JAX ``cp_init`` draws (handed to the port as
``init_factors``) and run fixed budgets (``tol=0``) on tensors that are not
near-exact, where the fit is not clamped at 1.0.  Fits must agree within
``FUSED_FIT_TOL`` and factors within 1e-3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import cp_als as jcp
from repro.core import cp_als_fused as jfused
from repro.core import sparse_tensor as jst
from repro_torch.convert import cpstate_to_numpy, factors_from_numpy
from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import sparse_tensor as tst

FACTOR_TOL = 1e-3


def _pair(shape, nnz, seed, **kw):
    return (
        tst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
        jst.random_sparse_tensor(shape, nnz, seed=seed, **kw),
    )


def _jax_init(tj, rank, seed):
    return [np.asarray(f) for f in jcp.cp_init(tj, rank, seed=seed)]


def _assert_state_close(port_state, jax_state):
    np.testing.assert_allclose(port_state.fits, jax_state.fits, atol=tfused.FUSED_FIT_TOL, rtol=0)
    factors, weights = cpstate_to_numpy(port_state)
    for got, want in zip(factors, jax_state.factors):
        np.testing.assert_allclose(got, np.asarray(want), atol=FACTOR_TOL, rtol=FACTOR_TOL)
    np.testing.assert_allclose(weights, np.asarray(jax_state.weights), rtol=FACTOR_TOL, atol=FACTOR_TOL)


@pytest.mark.parametrize("impl,jax_kw", [("kernel", dict(impl="pallas", backend="xla")),
                                         ("ref", dict(impl="ref"))])
def test_eager_matches_jax_eager(impl, jax_kw):
    t, tj = _pair((30, 25, 20), 1200, seed=5, zipf_a=0.8, shuffle=True)
    sj = jcp.cp_als(tj, 6, n_iters=6, tol=0.0, seed=2, **jax_kw)
    sp = tcp.cp_als(t, 6, n_iters=6, tol=0.0, impl=impl, device="cpu",
                    init_factors=_jax_init(tj, 6, seed=2))
    assert sp.iters == sj.iters == 6
    _assert_state_close(sp, sj)


def test_eager_4mode_matches_jax():
    t, tj = _pair((12, 10, 8, 6), 400, seed=9)
    sj = jcp.cp_als(tj, 4, n_iters=4, tol=0.0, seed=1, impl="pallas", backend="xla")
    sp = tcp.cp_als(t, 4, n_iters=4, tol=0.0, impl="kernel", device="cpu",
                    init_factors=_jax_init(tj, 4, seed=1))
    _assert_state_close(sp, sj)


def test_fused_restarts_match_jax_fused():
    t, tj = _pair((28, 22, 18), 900, seed=6, zipf_a=0.7)
    jr = jfused.FusedCPALS(tj, 5, impl="pallas", backend="xla").run(
        n_iters=6, tol=0.0, seed=3, restarts=3, fit_every=3
    )
    inits = [_jax_init(tj, 5, seed=s) for s in (3, 4, 5)]
    pr = tfused.FusedCPALS(t, 5, impl="kernel", device="cpu").run(
        n_iters=6, tol=0.0, fit_every=3, init_factors=inits
    )
    assert pr.fits.shape == jr.fits.shape == (3, 6)
    np.testing.assert_allclose(pr.fits, jr.fits, atol=tfused.FUSED_FIT_TOL, rtol=0)
    assert pr.sync_count == jr.sync_count == 2
    assert pr.best_restart == jr.best_restart
    assert pr.seeds == ()
    _assert_state_close(pr.state, jr.state)


def test_fused_single_restart_matches_port_eager():
    t, _ = _pair((25, 20, 15), 700, seed=7, zipf_a=0.6)
    init = [np.asarray(f) for f in tcp.cp_init(t, 4, seed=11, device="cpu")]
    eager = tcp.cp_als(t, 4, n_iters=5, tol=0.0, impl="kernel", device="cpu", init_factors=init)
    fused = tfused.cp_als_fused(t, 4, n_iters=5, tol=0.0, impl="kernel", device="cpu",
                                fit_every=2, init_factors=[init])
    np.testing.assert_allclose(fused.state.fits, eager.fits, atol=1e-6, rtol=0)
    assert fused.sync_count == 3


def test_fused_seeded_restarts_are_deterministic_and_batched():
    t, _ = _pair((20, 18, 16), 500, seed=8)
    ex = tfused.FusedCPALS(t, 3, impl="kernel", device="cpu")
    a = ex.run(n_iters=3, tol=0.0, seed=4, restarts=2)
    b = ex.run(n_iters=3, tol=0.0, seeds=(4, 5))
    np.testing.assert_array_equal(a.fits, b.fits)
    assert a.seeds == (4, 5) and a.fits.shape == (2, 3)
    single = ex.run(n_iters=3, tol=0.0, seed=5)
    np.testing.assert_allclose(a.fits[1], single.fits[0], atol=1e-6, rtol=0)


def test_fit_chunking_is_reassociation_only():
    t, _ = _pair((30, 20, 10), 800, seed=10)
    fac = [torch.rand((s, 4), generator=torch.Generator().manual_seed(k)) for k, s in enumerate(t.shape)]
    w = torch.rand(4, generator=torch.Generator().manual_seed(9))
    idx = torch.from_numpy(t.indices)
    val = torch.from_numpy(t.values)
    norm2 = torch.tensor(float((t.values.astype(np.float64) ** 2).sum()))
    whole = tcp._fit(norm2, idx, val, fac, w)
    chunked = tcp._fit(norm2, idx, val, fac, w, nnz_chunk=97)
    np.testing.assert_allclose(chunked.item(), whole.item(), atol=1e-6)
    want = jcp._fit(jnp.asarray(norm2.numpy()), jnp.asarray(t.indices), jnp.asarray(t.values),
                    [jnp.asarray(f.numpy()) for f in fac], jnp.asarray(w.numpy()))
    np.testing.assert_allclose(whole.item(), float(want), atol=1e-5)


def test_mode_update_matches_jax():
    rng = np.random.default_rng(12)
    facs = [rng.random((s, 5)).astype(np.float32) for s in (9, 7, 6)]
    m = rng.standard_normal((7, 5)).astype(np.float32)
    w = np.ones(5, np.float32)
    got_f, got_w = tcp._mode_update(factors_from_numpy(facs, device="cpu"),
                                    torch.from_numpy(w), torch.from_numpy(m), 1)
    want_f, want_w = jcp._mode_update([jnp.asarray(f) for f in facs], jnp.asarray(w),
                                      jnp.asarray(m), 1)
    assert got_f[1].is_contiguous()
    for g, h in zip(got_f, want_f):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-4)


def test_bf16_factors_run_finite():
    t, _ = _pair((20, 15, 10), 300, seed=13)
    s = tcp.cp_als(t, 4, n_iters=3, tol=0.0, impl="kernel", device="cpu", dtype=torch.bfloat16)
    assert all(f.dtype == torch.bfloat16 for f in s.factors)
    assert np.isfinite(s.fits).all()


def test_reconstruct_values_matches_jax():
    t, tj = _pair((10, 9, 8), 50, seed=0)
    rng = np.random.default_rng(1)
    facs = [rng.random((s, 4)).astype(np.float32) for s in t.shape]
    w = rng.random(4).astype(np.float32)
    got = tcp.reconstruct_values(torch.from_numpy(t.indices), factors_from_numpy(facs, device="cpu"),
                                 torch.from_numpy(w))
    want = jcp.reconstruct_values(jnp.asarray(tj.indices), [jnp.asarray(f) for f in facs], jnp.asarray(w))
    assert got.shape == (t.nnz,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_argument_errors():
    t, _ = _pair((10, 9, 8), 50, seed=0)
    empty = tst.SparseTensor(np.zeros((0, 3), np.int32), np.zeros(0, np.float32), (4, 4, 4))
    with pytest.raises(ValueError, match="nonzero"):
        tcp.cp_als(empty, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        tcp.cp_als(t, 2, impl="sharded", device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        tfused.FusedCPALS(t, 2, impl="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tfused.FusedCPALS(t, 2, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tcp.cp_als(t, 2, device="cpu", init_factors=[np.ones((10, 3))] * 3)
    ex = tfused.FusedCPALS(t, 2, impl="kernel", device="cpu")
    init = [np.ones((s, 2), np.float32) for s in t.shape]
    with pytest.raises(ValueError, match="init_factors"):
        ex.run(init_factors=[init, init], restarts=3)
