"""The backward of the port's recurrences against the JAX package's, on the
CPU: the backward kernels' chunked algorithm (``ref``'s
``wkv6_scan_bwd_chunked_ref`` and ``ssd_scan_bwd_chunked_ref``) and
autograd through the step loops (``ops.wkv6_scan_logw`` /
``ssd_scan_logdec`` on CPU tensors), the decays taken in their log as the
models take them, against ``jax.vjp`` of JAX's scans through
``_chunked_scan`` (``tests/test_torch_recurrence.py``'s ``_jax_wkv_ys`` and
``_jax_ssd_ys``): at S around the 16- and 32-step edges in the four decay
regimes, at ``scan_chunk`` 1, 16 and 128, and at S = 4096 with the models'
decays.  Every gradient within 1e-4 of its (b, h)'s largest magnitude of
JAX's (du: of each head's; dbm and dcm, shared by the heads: of each
sequence's).  The decays are drawn as logs, so "strong" puts exact zeros
among the decays (exp of a log below -104) with a finite log, as the
models' are.  A file of its own beside ``test_torch_recurrence.py``, so
that a parallel run takes the two on two workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.recurrence import ops as rops
from repro_torch.kernels.recurrence import ref as rops_ref
from test_torch_recurrence import DECAYS, _jax_ssd_ys, _jax_wkv_ys, one_torch_thread  # noqa: F401

BWD_TOL = 1e-4
BWD_SEQS = [1, 15, 16, 17, 33]  # longer: S = 4096 below


def _log_decays(kind: str, shape, rng, decay: str) -> np.ndarray:
    """WKV-6's log w or the SSD's log decay in one of DECAYS."""
    if decay == "none":
        return np.zeros(shape, np.float32)
    if kind == "wkv6":
        hi = {"model": 0.5, "strong": 5.0, "spike": -2.0}[decay]
        out = -np.exp(rng.uniform(-6.0, hi, shape))
    else:
        out = -{"model": 2.0, "strong": 150.0, "spike": 0.1}[decay] * rng.uniform(0.0, 1.0, shape)
    if decay == "spike":
        out[:, min(2, shape[1] - 1)] = -69.0  # a decay of 1e-30
    return out.astype(np.float32)


def _bwd_inputs(kind: str, b, s, h, seed, decay="model"):
    """The scan's inputs with the decays as logs, and dy."""
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    if kind == "wkv6":
        r, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32) for _ in range(3))
        u = (0.1 * rng.standard_normal((h, 64))).astype(np.float32)
        return (r, k, v, _log_decays(kind, (b, s, h, 64), rng, decay), u), dy
    dtx = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, 64)).astype(np.float32) for _ in range(2))
    return (_log_decays(kind, (b, s, h), rng, decay), dtx, bm, cm), dy


def _jax_vjp(kind: str, args, dy, chunk: int) -> list[np.ndarray]:
    if kind == "wkv6":
        def f(r, k, v, log_w, u):
            return _jax_wkv_ys(r, k, v, jnp.exp(log_w), u, chunk)
    else:
        def f(log_dec, dtx, bm, cm):
            return _jax_ssd_ys(jnp.exp(log_dec), dtx, bm, cm, chunk)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _chunked_bwd(kind: str, args, dy) -> list[torch.Tensor]:
    t = [torch.from_numpy(a) for a in args]
    g = torch.from_numpy(dy)
    if kind == "wkv6":
        r, k, v, log_w, u = t
        return list(rops_ref.wkv6_scan_bwd_chunked_ref(r, k, v, torch.exp(log_w), u, g))
    log_dec, dtx, bm, cm = t
    dlog, ddtx, dbm_h, dcm_h = rops_ref.ssd_scan_bwd_chunked_ref(torch.exp(log_dec), dtx, bm, cm, g)
    return [dlog, ddtx, dbm_h.sum(2), dcm_h.sum(2)]


def _autograd_bwd(kind: str, args, dy) -> list[torch.Tensor]:
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    fn = rops.wkv6_scan_logw if kind == "wkv6" else rops.ssd_scan_logdec
    y = fn(*t)
    return list(torch.autograd.grad(y, t, torch.from_numpy(dy), allow_unused=True,
                                    materialize_grads=True))


def _grad_scale_dims(kind: str, i: int, ndim: int):
    """The dims over which a gradient's scale is taken: each (b, h) of a
    (B, S, H, 64) or (B, S, H) gradient, each head of du, each sequence of
    the SSD's shared dbm and dcm."""
    if kind == "wkv6" and i == 4:
        return (1,)
    if kind == "ssd" and i >= 2:
        return (1, 2)
    return (1, 3) if ndim == 4 else (1,)


def _bwd_close(kind: str, got: list, want: list, tol: float = BWD_TOL) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (kind, i, g.shape, w.shape)
        assert np.isfinite(g).all() and np.isfinite(w).all(), (kind, i)
        scale = np.maximum(np.abs(w).max(axis=_grad_scale_dims(kind, i, w.ndim), keepdims=True),
                           1e-30)
        err = float((np.abs(g - w) / scale).max()) if w.size else 0.0
        assert err <= tol, (kind, i, err)


def _check_bwd(kind: str, b, s, h, seed, decay, chunk):
    args, dy = _bwd_inputs(kind, b, s, h, seed, decay)
    want = _jax_vjp(kind, args, dy, chunk)
    _bwd_close(kind, _chunked_bwd(kind, args, dy), want)
    _bwd_close(kind, _autograd_bwd(kind, args, dy), want)
    return args, want


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("s", BWD_SEQS)
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_scan_backward_matches_jax_vjp(kind, s, decay):
    """At and around the 16- and 32-step edges, each decay regime, JAX's
    scan_chunk 16 (checkpoints every 16 steps when S is a multiple)."""
    args, want = _check_bwd(kind, 2, s, 3, seed=s + 3, decay=decay, chunk=16)
    if decay == "strong" and s > 1:
        log_dec = args[3] if kind == "wkv6" else args[0]
        assert (np.exp(log_dec) == 0).any()  # exact zeros, with finite logs and gradients


@pytest.mark.parametrize("chunk", [1, 16, 128])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_scan_backward_does_not_depend_on_scan_chunk(kind, chunk):
    """JAX's checkpoints (one scan at chunk 1; 16 and 2 chunks of it at 256)
    change no gradient beyond float32 rounding."""
    _check_bwd(kind, 1, 256, 2, seed=chunk, decay="model", chunk=chunk)


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_scan_backward_at_4096_steps_with_the_models_decays(kind):
    """The training length, decays as the models draw them at their init
    (log w = -exp(w_base + lora), w_base = -6: w ~ 0.9975; the SSD's
    softplus(dt) * A with A = -1), where the state carries across the whole
    sequence and the reverse sums are longest."""
    rng = np.random.default_rng(7)
    args, dy = _bwd_inputs(kind, 1, 4096, 2, seed=7)
    if kind == "wkv6":
        args = (*args[:3], (-np.exp(-6.0 + 0.3 * rng.standard_normal(args[3].shape)))
                .astype(np.float32), args[4])
    else:
        dt = np.log1p(np.exp(rng.standard_normal(args[0].shape)))  # softplus
        args = (-dt.astype(np.float32), *args[1:])
    want = _jax_vjp(kind, args, dy, 128)
    _bwd_close(kind, _chunked_bwd(kind, args, dy), want)
    _bwd_close(kind, _autograd_bwd(kind, args, dy), want)


def _direct_pairs(kind: str, dec: np.ndarray, dmat: np.ndarray, r: np.ndarray, k: np.ndarray):
    """The pairs' sum of the decays' gradient over one chunk, summed directly
    in O(L^3): WKV-6's sum_{s<t<tau} D[tau,s] r_tau k_s prod_{s<sigma<tau} w
    per channel; the SSD's sum_{s<t<=tau} M[tau,s], M = Ls E (C B^T) with
    Ls = prod_{s<sigma<=tau} of the decays (r and k unused; dmat is E (C B^T))."""
    n = dec.shape[0]
    out = np.zeros((n,) + dec.shape[1:])
    for t in range(n):
        for tau in range(t if kind == "ssd" else t + 1, n):
            for s in range(t):
                if kind == "wkv6":
                    out[t] += dmat[tau, s] * r[tau] * k[s] * np.prod(dec[s + 1:tau], axis=0)
                else:
                    out[t] += dmat[tau, s] * np.prod(dec[s + 1:tau + 1], axis=0)
    return out


@pytest.mark.parametrize("decay", ["model", "strong", "zero"])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_pairs_in_l_squared_equal_the_direct_sum(kind, decay):
    """The backward kernels' O(L^2) pairs (``ref._pairs_below``: a running
    sum along s, then along tau) against the O(L^3) direct sum, in float64,
    over one 32-step chunk: within 1e-12 of the largest; exactly 0 at t = 0,
    and at every step whose decay is exactly 0."""
    rng = np.random.default_rng(11)
    n, x = rops_ref.CHUNK, 64 if kind == "wkv6" else 1
    args, _ = _bwd_inputs(kind, 1, n, 1, seed=5, decay="model" if decay == "zero" else decay)
    log_dec = (args[3][0, :, 0] if kind == "wkv6" else args[0][0, :, :1]).astype(np.float64)
    dec = np.exp(log_dec)
    zeros = [5, 17] if decay == "zero" else []
    dec[zeros] = 0.0
    dmat = rng.standard_normal((n, n))
    r, k = rng.standard_normal((n, x)), rng.standard_normal((n, x))
    want = _direct_pairs(kind, dec, dmat, r, k)
    tdec = torch.from_numpy(dec)
    if kind == "wkv6":
        wp = rops_ref._pair_products(tdec, inclusive=False)  # (tau, s, X)
        y = torch.from_numpy(dmat)[..., None] * wp * torch.from_numpy(k)[None]
        got = rops_ref._pairs_below(y, torch.from_numpy(r), strict=True).numpy()
    else:
        ls = rops_ref._pair_products(tdec, inclusive=True)
        got = rops_ref._pairs_below(torch.from_numpy(dmat)[..., None] * ls, None,
                                    strict=False).numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= 1e-12 * scale, np.abs(got - want).max() / scale
    assert (got[0] == 0).all()
    for t in zeros:
        assert (got[t] == 0).all() and (want[t] == 0).all(), t
