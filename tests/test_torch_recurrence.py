"""The port's recurrences (RWKV-6's WKV and Mamba2's state scan) against the
JAX package's, on the CPU.

On CPU tensors ``repro_torch.kernels.recurrence.ops`` runs the plain
per-step loops that the CUDA kernels are held against on the card.  They,
and the model functions around them (``rwkv_time_mix_seq``, ``mamba_seq``
and the one-token ``_step`` functions), are held against JAX's at S in
{1, 7, 128, 130, 256} with ``scan_chunk`` 1, 64 and 128 on the JAX side
(JAX's ``_chunked_scan`` checkpoints at chunk boundaries and falls back to
one scan when S is not a multiple of the chunk).  The port takes no chunk:
its output must not depend on the config's ``scan_chunk`` at all.  Float32,
tolerance 1e-5 (the same sums in another order).  Inputs are drawn with
numpy from a seed; weights come from JAX's ``init_rwkv_block`` and
``init_mamba``.

The CUDA kernels' chunked algorithm, in plain float32 (``ref``'s
``wkv6_scan_chunked_ref`` and ``ssd_scan_chunked_ref``: 32-step chunks of
16-step sub-chunks, every decay factor a product over a segment), is held
against JAX's scans and the step loops at S in {1, 15, 16, 17, 63, 64, 65,
128, 130, 1000}, with the models' decays, strong ones (some exactly 0),
none (w = dec = 1) and one near-zero decay among mild ones.

The backward is held against ``jax.vjp`` in ``tests/test_torch_recurrence_bwd.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.kernels.recurrence import kernel as rkernel
from repro_torch.kernels.recurrence import ops as rops
from repro_torch.kernels.recurrence.ref import (
    ssd_scan_chunked_ref,
    ssd_scan_ref,
    wkv6_scan_chunked_ref,
    wkv6_scan_ref,
)
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm

TOL = 1e-5
SEQS = [1, 7, 128, 130, 256]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its step loops are thousands of
    small operations, which run several times slower when each process of
    a parallel test run spreads them over every core (measured: six
    processes side by side, 60 s each against 17 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CHUNKS = [1, 64, 128]
CHUNKED_SEQS = [1, 15, 16, 17, 63, 64, 65, 128, 130, 1000]  # around 16- and 32-step edges
DECAYS = ["model", "strong", "none", "spike"]


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol, atol=tol * scale)


def _configs(arch: str, chunk: int = 128):
    return (jreg.reduced_config(arch, dtype=jnp.float32, scan_chunk=chunk),
            treg.reduced_config(arch, dtype=torch.float32, scan_chunk=chunk))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _torch_tree(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _jax_wkv_ys(r, k, v, w, u, chunk):
    """JAX's WKV scan: rwkv_time_mix_seq's step through its _chunked_scan,
    as a jnp function of its inputs; y (B, S, H, 64)."""
    def step(s_state, ins):
        r_t, k_t, v_t, w_t = ins
        kv = k_t[..., :, None] * v_t[..., None, :]
        y = jnp.einsum("bhk,bhkv->bhv", r_t, s_state + u[None, :, :, None] * kv)
        return w_t[..., None] * s_state + kv, y

    b, s, h, hd = r.shape
    xs = tuple(jnp.asarray(a).transpose(1, 0, 2, 3) for a in (r, k, v, w))
    s0 = jnp.zeros((b, h, hd, hd), jnp.float32)
    _, ys = jrwkv._chunked_scan(step, s0, xs, s, chunk)
    return ys.transpose(1, 0, 2, 3)


def _jax_wkv(r, k, v, w, u, chunk):
    return np.asarray(_jax_wkv_ys(r, k, v, w, jnp.asarray(u), chunk))


def _jax_ssd_ys(decay, dtx, bm, cm, chunk):
    """JAX's Mamba2 scan: mamba_seq's step through _chunked_scan, as a jnp
    function of its inputs; y (B, S, H, 64)."""
    def step(h, ins):
        dec_t, dtx_t, b_t, c_t = ins
        h = h * dec_t[..., None, None] + dtx_t[..., None] * b_t[:, None, None, :]
        return h, jnp.einsum("bhds,bs->bhd", h, c_t)

    b, s, h, hd = dtx.shape
    xs = (jnp.asarray(decay).transpose(1, 0, 2), jnp.asarray(dtx).transpose(1, 0, 2, 3),
          jnp.asarray(bm).transpose(1, 0, 2), jnp.asarray(cm).transpose(1, 0, 2))
    h0 = jnp.zeros((b, h, hd, bm.shape[-1]), jnp.float32)
    _, ys = jrwkv._chunked_scan(step, h0, xs, s, chunk)
    return ys.transpose(1, 0, 2, 3)


def _jax_ssd(decay, dtx, bm, cm, chunk):
    return np.asarray(_jax_ssd_ys(decay, dtx, bm, cm, chunk))


def _spiked(mild: np.ndarray) -> np.ndarray:
    """Mild decays with one near-zero step (1e-30) early in the first chunk."""
    mild[:, min(2, mild.shape[1] - 1)] = 1e-30
    return mild


def _wkv_inputs(b, s, h, seed, decay="model"):
    """decay: "model" (w = exp(-exp(x)), x in [-6, 0.5]), "strong" (x up to 5:
    some w exactly 0), "none" (w = 1) or "spike" (see ``_spiked``)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32) for _ in range(3))
    hi = {"model": 0.5, "strong": 5.0, "none": 0.5, "spike": -2.0}[decay]
    w = np.exp(-np.exp(rng.uniform(-6.0, hi, (b, s, h, 64)))).astype(np.float32)
    if decay == "none":
        w = np.ones_like(w)
    elif decay == "spike":
        w = _spiked(w)
    u = (0.1 * rng.standard_normal((h, 64))).astype(np.float32)
    return r, k, v, w, u


def _ssd_inputs(b, s, h, n, seed, decay="model"):
    """decay: "model" (exp(-U[0, 2])), "strong" (exp(-U[0, 60]), a fifth
    exactly 0), "none" (1) or "spike" (exp(-U[0, 0.1]), see ``_spiked``)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, (b, s, h))
    decay_ = np.exp(-{"model": 2.0, "strong": 60.0, "none": 0.0, "spike": 0.1}[decay] * u)
    if decay == "strong":
        decay_[u > 0.8] = 0.0
    elif decay == "spike":
        decay_ = _spiked(decay_)
    dtx = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    return decay_.astype(np.float32), dtx, bm, cm


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", SEQS)
def test_wkv6_scan_plain_matches_jax_scan(s, chunk):
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(2, s, 3, seed=s))
    log_w = torch.log(w)
    got = rops.wkv6_scan_logw(r, k, v, log_w, u)
    assert got.shape == (2, s, 3, 64) and got.dtype == torch.float32
    _close(got, _jax_wkv(*(t.numpy() for t in (r, k, v, torch.exp(log_w), u)), chunk))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", SEQS)
def test_ssd_scan_plain_matches_jax_scan(s, chunk):
    decay, dtx, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(2, s, 3, 64, seed=s))
    log_decay = torch.log(decay)
    got = rops.ssd_scan_logdec(log_decay, dtx, bm, cm)
    assert got.shape == (2, s, 3, 64) and got.dtype == torch.float32
    _close(got, _jax_ssd(*(t.numpy() for t in (torch.exp(log_decay), dtx, bm, cm)), chunk))


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("s", CHUNKED_SEQS)
def test_wkv6_chunked_ref_matches_jax_scan_and_step_loop(s, decay):
    """The kernel's chunked algorithm against JAX's scan and the step loop."""
    arrays = _wkv_inputs(2, s, 3, seed=s + 11, decay=decay)
    tensors = [torch.from_numpy(a) for a in arrays]
    got = wkv6_scan_chunked_ref(*tensors)
    assert got.shape == (2, s, 3, 64) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _close(got, _jax_wkv(*arrays, 64))
    _close(got, wkv6_scan_ref(*tensors).numpy())


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("s", CHUNKED_SEQS)
def test_ssd_chunked_ref_matches_jax_scan_and_step_loop(s, decay):
    arrays = _ssd_inputs(2, s, 3, 64, seed=s + 13, decay=decay)
    tensors = [torch.from_numpy(a) for a in arrays]
    got = ssd_scan_chunked_ref(*tensors)
    assert got.shape == (2, s, 3, 64) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _close(got, _jax_ssd(*arrays, 64))
    _close(got, ssd_scan_ref(*tensors).numpy())


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_refs_take_other_chunk_lengths(chunk):
    """One sub-chunk a chunk, and four (products of whole sub-chunks between
    an off-diagonal block's rows and columns), against the step loops."""
    wkv = [torch.from_numpy(a) for a in _wkv_inputs(2, 130, 2, seed=chunk, decay="strong")]
    _close(wkv6_scan_chunked_ref(*wkv, chunk=chunk), wkv6_scan_ref(*wkv).numpy())
    ssd = [torch.from_numpy(a) for a in _ssd_inputs(2, 130, 2, 64, seed=chunk, decay="spike")]
    _close(ssd_scan_chunked_ref(*ssd, chunk=chunk), ssd_scan_ref(*ssd).numpy())


def test_scans_take_strided_views_of_one_projection():
    """The kernels' layout through strides: r, k, v, w as column slices of one
    fused tensor, b and c as slices of the conv output, against contiguous
    copies."""
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.standard_normal((2, 9, 4 * 3 * 64)).astype(np.float32))
    r, k, v, w = (fused[..., i * 192:(i + 1) * 192].reshape(2, 9, 3, 64) for i in range(4))
    w = torch.sigmoid(w)
    u = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    assert not r.is_contiguous()
    log_w = torch.log(w)
    torch.testing.assert_close(rops.wkv6_scan_logw(r, k, v, log_w, u), wkv6_scan_ref(
        *(t.contiguous() for t in (r, k, v, torch.exp(log_w))), u), rtol=0, atol=0)
    conv = torch.from_numpy(rng.standard_normal((2, 9, 3 * 64 + 2 * 64)).astype(np.float32))
    dtx = conv[..., :192].reshape(2, 9, 3, 64)
    bm, cm = conv[..., 192:256], conv[..., 256:]
    decay = torch.rand((2, 9, 3), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(rops.ssd_scan_logdec(torch.log(decay), dtx, bm, cm), ssd_scan_ref(
        torch.exp(torch.log(decay)), dtx.contiguous(), bm.contiguous(), cm.contiguous()),
        rtol=0, atol=0)


def test_scan_layout_checks_raise():
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 4, 2, seed=1))
    log_w = torch.log(w)
    with pytest.raises(ValueError, match="differs"):
        rops.wkv6_scan_logw(r, k[:, :3], v, log_w, u)
    with pytest.raises(ValueError, match="u must be"):
        rops.wkv6_scan_logw(r, k, v, log_w, u[:1])
    with pytest.raises(TypeError, match="float32"):
        rops.wkv6_scan_logw(r.double(), k, v, log_w, u)
    with pytest.raises(ValueError, match="CUDA"):
        rkernel.wkv6_scan_cuda(r, k, v, w, u)
    decay, dtx, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(1, 4, 2, 64, seed=1))
    log_decay = torch.log(decay)
    with pytest.raises(ValueError, match="decay must be"):
        rops.ssd_scan_logdec(log_decay[:, :, :1], dtx, bm, cm)
    with pytest.raises(ValueError, match="differ"):
        rops.ssd_scan_logdec(log_decay, dtx, bm, cm[..., :32])
    with pytest.raises(ValueError, match="CUDA"):
        rkernel.ssd_scan_cuda(decay, dtx, bm, cm)
    before = (rkernel.wkv6_scan_cuda.launches, rkernel.ssd_scan_cuda.launches)
    rops.wkv6_scan_logw(r, k, v, log_w, u)
    rops.ssd_scan_logdec(log_decay, dtx, bm, cm)
    assert (rkernel.wkv6_scan_cuda.launches, rkernel.ssd_scan_cuda.launches) == before


def _rwkv_block(s: int, chunk: int = 128):
    jcfg, tcfg = _configs("rwkv6-3b", chunk)
    params = _np_tree(jrwkv.init_rwkv_block(jax.random.PRNGKey(s), jcfg))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, params), _torch_tree(params), x, x_prev


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", SEQS)
def test_rwkv_time_mix_matches_jax(s, chunk):
    """The WKV path of the time mix, from a previous token's input (the
    prompt continuation's form), against JAX's at each scan_chunk."""
    jcfg, tcfg, jp, tp, x, x_prev = _rwkv_block(s, chunk)
    got = trwkv.rwkv_time_mix_seq(tp, tcfg, torch.from_numpy(x), x_prev=torch.from_numpy(x_prev))
    _close(got, jrwkv.rwkv_time_mix_seq(jp, jcfg, jnp.asarray(x), x_prev=jnp.asarray(x_prev)))
    other = trwkv.rwkv_time_mix_seq(tp, dataclasses.replace(tcfg, scan_chunk=7),
                                    torch.from_numpy(x), x_prev=torch.from_numpy(x_prev))
    torch.testing.assert_close(other, got, rtol=0, atol=0)  # scan_chunk changes nothing


@pytest.mark.parametrize("s", SEQS)
def test_rwkv_channel_mix_and_zero_shift_match_jax(s):
    """The channel mix (no scan) with and without a previous token, and the
    time mix from a zero shift."""
    jcfg, tcfg, jp, tp, x, x_prev = _rwkv_block(s)
    for kw in ({}, {"x_prev": x_prev}):
        jkw = {k_: jnp.asarray(v_) for k_, v_ in kw.items()}
        tkw = {k_: torch.from_numpy(v_) for k_, v_ in kw.items()}
        got = trwkv.rwkv_channel_mix_seq(tp, tcfg, torch.from_numpy(x), **tkw)
        _close(got, jrwkv.rwkv_channel_mix_seq(jp, jcfg, jnp.asarray(x), **jkw))
    got = trwkv.rwkv_time_mix_seq(tp, tcfg, torch.from_numpy(x))
    _close(got, jrwkv.rwkv_time_mix_seq(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", SEQS)
def test_mamba_seq_matches_jax(s, chunk):
    jcfg, tcfg = _configs("zamba2-1.2b", chunk)
    params = _np_tree(jssm.init_mamba(jax.random.PRNGKey(s), jcfg))
    # Nonzero a_log, dt_bias and d_skip, so the decay and the skip are exercised.
    rng = np.random.default_rng(s)
    for name in ("a_log", "dt_bias", "d_skip"):
        params[name] = (0.5 * rng.standard_normal(params[name].shape)).astype(np.float32)
    x = rng.standard_normal((1, s, jcfg.d_model)).astype(np.float32)
    got = tssm.mamba_seq(_torch_tree(params), tcfg, torch.from_numpy(x))
    want = jssm.mamba_seq(jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(x))
    _close(got, want)
    other = tssm.mamba_seq(_torch_tree(params), dataclasses.replace(tcfg, scan_chunk=1),
                           torch.from_numpy(x))
    torch.testing.assert_close(other, got, rtol=0, atol=0)


def test_rwkv_step_functions_match_jax():
    jcfg, tcfg = _configs("rwkv6-3b")
    params = _np_tree(jrwkv.init_rwkv_block(jax.random.PRNGKey(4), jcfg))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _torch_tree(params)
    rng = np.random.default_rng(4)
    b, d, heads = 3, jcfg.d_model, jcfg.d_model // 64
    xt, xp, xc = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(3))
    wkv = rng.standard_normal((b, heads, 64, 64)).astype(np.float32)
    want = jrwkv.rwkv_time_mix_step(jp, jcfg, jnp.asarray(xt), jnp.asarray(wkv), jnp.asarray(xp))
    got = trwkv.rwkv_time_mix_step(tp, tcfg, torch.from_numpy(xt), torch.from_numpy(wkv),
                                   torch.from_numpy(xp))
    for g, w in zip(got, want):
        _close(g, w)
    want = jrwkv.rwkv_channel_mix_step(jp, jcfg, jnp.asarray(xt), jnp.asarray(xc))
    got = trwkv.rwkv_channel_mix_step(tp, tcfg, torch.from_numpy(xt), torch.from_numpy(xc))
    for g, w in zip(got, want):
        _close(g, w)
    jstate = jrwkv.init_rwkv_state(jcfg, b)
    tstate = trwkv.init_rwkv_state(tcfg, b)
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        k: v.shape for k, v in jstate.items()}


def test_mamba_decode_step_matches_jax():
    jcfg, tcfg = _configs("zamba2-1.2b")
    params = _np_tree(jssm.init_mamba(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    params["a_log"] = (0.5 * rng.standard_normal(params["a_log"].shape)).astype(np.float32)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _torch_tree(params)
    jstate = jssm.init_mamba_state(jcfg, 2)
    tstate = tssm.init_mamba_state(tcfg, 2)
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        k: v.shape for k, v in jstate.items()}
    state = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jstate.items()}
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want_y, want_st = jssm.mamba_decode_step(
        jp, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    got_y, got_st = tssm.mamba_decode_step(
        tp, tcfg, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got_y, want_y)
    for key in state:
        _close(got_st[key], want_st[key])


def test_sequence_paths_equal_their_decode_steps():
    """Each seq function over S tokens against S of its one-token steps from a
    zero state (the decode path's own recurrence), in the port alone."""
    _, tcfg = _configs("rwkv6-3b")
    params = _torch_tree(_np_tree(jrwkv.init_rwkv_block(jax.random.PRNGKey(6),
                                                        _configs("rwkv6-3b")[0])))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 11, tcfg.d_model))
                         .astype(np.float32))
    st = trwkv.init_rwkv_state(tcfg, 2)
    wkv, xp = st["wkv"], st["x_prev_t"]
    outs = []
    for t in range(11):
        out, wkv, xp = trwkv.rwkv_time_mix_step(params, tcfg, x[:, t], wkv, xp)
        outs.append(out)
    torch.testing.assert_close(torch.stack(outs, 1), trwkv.rwkv_time_mix_seq(params, tcfg, x),
                               rtol=TOL, atol=TOL)
