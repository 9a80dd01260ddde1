"""Plain PyTorch versions of the recurrence kernels: per-step loops written as
the JAX package's step functions (``repro.models.rwkv.rwkv_time_mix_seq``'s
and ``repro.models.ssm.mamba_seq``'s).

The CPU path of ``ops`` and the oracle that the tests and ``chip_smoke.py``
hold the CUDA kernels against.  Each step is a handful of small launches
on the card, so at model lengths the kernels take their place there.
JAX's ``scan_chunk`` only places rematerialisation checkpoints
(``_chunked_scan``); the forward values do not depend on it, so these
loops take no chunk.

``wkv6_scan_chunked_ref`` and ``ssd_scan_chunked_ref`` are the CUDA
kernels' chunked algorithm in plain float32 (``csrc/recurrence.cu``'s note
derives it): chunks of ``CHUNK`` steps cut into sub-chunks of ``SUB``,
every decay factor a product of the decays over one segment (never a
quotient or a log), the off-diagonal sub-blocks split at the later
sub-chunk's start, WKV-6's diagonal sub-blocks as running products along
t.  Nothing on the main path calls them; the CPU tests hold them against
JAX's scans and the step loops, so the algorithm's arithmetic is checked
where no card is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "HEAD_DIM", "SUB", "ssd_scan_bwd_chunked_ref", "ssd_scan_bwd_ref",
           "ssd_scan_chunked_ref", "ssd_scan_ref", "wkv6_scan_bwd_chunked_ref",
           "wkv6_scan_bwd_ref", "wkv6_scan_chunked_ref", "wkv6_scan_ref"]

HEAD_DIM = 64
CHUNK = 32  # time steps a chunk, as the CUDA kernels cut the sequence
SUB = 16  # time steps a sub-chunk: one tensor-core tile edge


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """WKV-6 over a sequence from a zero state.  r, k, v, w (B, S, H, 64) and
    u (H, 64), all float32; returns y (B, S, H, 64) float32."""
    b, s, h, hd = r.shape
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    uu = u[None, :, :, None]
    for t in range(s):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, hd)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, hd, hd)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r_t, state + uu * kv)
        state = w_t[..., None] * state + kv
    return y


def ssd_scan_ref(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor) -> torch.Tensor:
    """The Mamba2 state recurrence over a sequence from a zero state.  decay
    (B, S, H), dtx (B, S, H, 64), bm and cm (B, S, N), all float32; returns
    y (B, S, H, 64) float32."""
    b, s, h, hd = dtx.shape
    n = bm.shape[-1]
    state = torch.zeros((b, h, hd, n), dtype=torch.float32, device=dtx.device)
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=dtx.device)
    for t in range(s):
        state = (state * decay[:, t, :, None, None]
                 + dtx[:, t, :, :, None] * bm[:, t, None, None, :])
        y[:, t] = torch.einsum("bhds,bs->bhd", state, cm[:, t])
    return y


def _seg(g: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The product of whole sub-chunks ``lo .. hi - 1`` of ``g`` (sub-chunk
    dim -2), left to right; ones when the range is empty."""
    out = torch.ones_like(g[..., 0, :])
    for m in range(lo, hi):
        out = out * g[..., m, :]
    return out


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``t`` (B, S, ...) zero-padded along S to whole chunks, as the kernels'
    staging pads the last one, and cut to (B, ..., n_chunks, nsub, SUB, -1)
    with the sequence's dims last."""
    n = -(-t.shape[1] // chunk) * chunk
    t = F.pad(t, [0, 0] * (t.dim() - 2) + [0, n - t.shape[1]])
    if t.dim() == 3:  # (B, S, X): one row a step
        t = t[:, None]
    else:  # (B, S, H, X)
        t = t.transpose(1, 2)
    return t.reshape(t.shape[:2] + (n // chunk, chunk // SUB, SUB, t.shape[-1]))


def _wkv_diag(r, k, w, u) -> torch.Tensor:
    """Each sub-chunk's diagonal block: A[t, s] = sum_i r_t k_s prod_{s<tau<t}
    w_tau for s < t, the bonus sum_i r_t u k_t at s = t; each k_s carried
    along t as a running product.  r, k, w (..., SUB, 64), u broadcast."""
    sub = r.shape[-2]
    a = torch.zeros(r.shape[:-1] + (sub,), dtype=r.dtype, device=r.device)
    e = torch.zeros_like(k)  # e[s] = k_s prod_{s < tau < t} w_tau
    for t in range(sub):
        a[..., t, :t] = torch.einsum("...i,...si->...s", r[..., t, :], e[..., :t, :])
        a[..., t, t] = (r[..., t, :] * (u[..., 0, :] * k[..., t, :])).sum(-1)
        e[..., :t, :] = e[..., :t, :] * w[..., t:t + 1, :]
        e[..., t, :] = k[..., t, :]
    return a


def _intra(rows: torch.Tensor, diag: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A V inside each chunk: ``rows[a][bb]`` A's (SUB x SUB) block of
    sub-chunks (a, bb < a), ``diag[..., a]`` the diagonal ones, v
    (..., nsub, SUB, 64); returns (..., nsub, SUB, 64)."""
    out = diag @ v
    for a, blocks in enumerate(rows):
        for bb, blk in enumerate(blocks):
            out[..., a, :, :] = out[..., a, :, :] + blk @ v[..., bb, :, :]
    return out


def wkv6_scan_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                          u: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """WKV-6 from a zero state in the CUDA kernel's chunked form; the same
    function as ``wkv6_scan_ref``.  Per chunk, with P_t = prod_{start<=tau<t} w
    and Q_s = prod_{s<tau<end} w (per key channel i):

        y = (r * P) S_start + A V,   S_end = diag(P_L) S_start + (k * Q)^T V

    P and Q are a sub-chunk's own running product times whole sub-chunks'
    products; A's off-diagonal sub-blocks (t in sub-chunk a, s in b < a) are
    (r_t * prod_{c_a<=tau<t} w) . (k_s * prod_{s<tau<c_a} w), split at c_a,
    the start of sub-chunk a.  Everything but the state's passage from one
    chunk to the next is formed for all chunks at once."""
    b, s, h, hd = r.shape
    nsub = chunk // SUB
    rc, kc, vc, wc = (_chunked(t, chunk) for t in (r, k, v, w))  # (B, H, nc, nsub, SUB, 64)
    ra, kb = torch.empty_like(rc), torch.empty_like(kc)
    p = torch.ones_like(wc[..., 0, :])
    for t in range(SUB):  # r_t * prod_{c_a <= tau < t} w_tau
        ra[..., t, :] = rc[..., t, :] * p
        p = p * wc[..., t, :]
    g = p  # (B, H, nc, nsub, 64): each sub-chunk's whole product
    p = torch.ones_like(g)
    for t in reversed(range(SUB)):  # k_s * prod_{s < tau < end of its sub-chunk} w_tau
        kb[..., t, :] = kc[..., t, :] * p
        p = p * wc[..., t, :]
    rows = [[ra[..., a, :, :] @ (kb[..., bb, :, :] * _seg(g, bb + 1, a)[..., None, :])
             .transpose(-1, -2) for bb in range(a)] for a in range(nsub)]
    y = _intra(rows, _wkv_diag(rc, kc, wc, u[None, :, None, None, None, :]), vc)
    rp = torch.stack([ra[..., a, :, :] * _seg(g, 0, a)[..., None, :] for a in range(nsub)], -3)
    kq = torch.stack([kb[..., a, :, :] * _seg(g, a + 1, nsub)[..., None, :] for a in range(nsub)], -3)
    p_l = _seg(g, 0, nsub)  # (B, H, nc, 64)
    nc = rc.shape[2]
    rp, kq, vv = (t.reshape(b, h, nc, chunk, hd) for t in (rp, kq, vc))
    y = y.reshape(b, h, nc, chunk, hd)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    for c in range(nc):
        y[:, :, c] = y[:, :, c] + rp[:, :, c] @ state
        state = state * p_l[:, :, c, :, None] + kq[:, :, c].transpose(-1, -2) @ vv[:, :, c]
    return y.reshape(b, h, nc * chunk, hd)[:, :, :s].transpose(1, 2).contiguous()


def ssd_scan_chunked_ref(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                         cm: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """The Mamba2 state recurrence from a zero state in the CUDA kernel's
    chunked form; the same function as ``ssd_scan_ref``.  With the state as
    h^T (N x 64) and the scalar decays of one head, per chunk:

        y = pre * (C h^T_start) + (Ls * C B^T) X,
        h^T_end = P_L h^T_start + (suf * B)^T X

    pre_t = prod_{start<=tau<=t} dec, suf_s = prod_{s<tau<end} dec,
    Ls[t, s] = prod_{s<tau<=t} dec (s <= t): on an off-diagonal sub-block
    the product up to c_a times the product from c_a to t, on a diagonal one
    a running product along t.  Everything but the state's passage from one
    chunk to the next is formed for all chunks at once."""
    b, s, h, hd = dtx.shape
    nsub = chunk // SUB
    dc = _chunked(decay[..., None], chunk)[..., 0]  # (B, H, nc, nsub, SUB)
    xc = _chunked(dtx, chunk)  # (B, H, nc, nsub, SUB, 64)
    bc, cc = (_chunked(t, chunk) for t in (bm, cm))  # (B, 1, nc, nsub, SUB, N)
    pinc, sexc = torch.empty_like(dc), torch.empty_like(dc)
    p = torch.ones_like(dc[..., 0])
    for t in range(SUB):  # prod_{c_a <= tau <= t} dec_tau
        p = p * dc[..., t]
        pinc[..., t] = p
    g = p[..., None]  # (B, H, nc, nsub, 1): each sub-chunk's whole product
    p = torch.ones_like(dc[..., 0])
    for t in reversed(range(SUB)):  # prod_{s < tau < end of its sub-chunk} dec_tau
        sexc[..., t] = p
        p = p * dc[..., t]
    ldiag = torch.zeros(dc.shape + (SUB,), dtype=torch.float32, device=dtx.device)
    for sl in range(SUB):  # prod_{s < tau <= t} dec_tau along t, inside one sub-chunk
        p = torch.ones_like(dc[..., 0])
        ldiag[..., sl, sl] = p
        for tl in range(sl + 1, SUB):
            p = p * dc[..., tl]
            ldiag[..., tl, sl] = p
    cbt = lambda a, bb: cc[..., a, :, :] @ bc[..., bb, :, :].transpose(-1, -2)
    rows = [[(pinc[..., a, :, None] * (sexc[..., bb, None, :] * _seg(g, bb + 1, a)[..., None]))
             * cbt(a, bb) for bb in range(a)] for a in range(nsub)]
    diag = ldiag * (cc @ bc.transpose(-1, -2))
    y = _intra(rows, diag, xc)
    pre = torch.stack([_seg(g, 0, a) * pinc[..., a, :] for a in range(nsub)], -2)
    suf = torch.stack([sexc[..., a, :] * _seg(g, a + 1, nsub) for a in range(nsub)], -2)
    p_l = _seg(g, 0, nsub)[..., 0]  # (B, H, nc)
    nc = xc.shape[2]
    cq = cc.reshape(b, 1, nc, chunk, -1)
    bq = suf.reshape(b, h, nc, chunk, 1) * bc.reshape(b, 1, nc, chunk, -1)
    xx = xc.reshape(b, h, nc, chunk, hd)
    pre = pre.reshape(b, h, nc, chunk, 1)
    y = y.reshape(b, h, nc, chunk, hd)
    state = torch.zeros((b, h, bm.shape[-1], hd), dtype=torch.float32, device=dtx.device)
    for c in range(nc):
        y[:, :, c] = y[:, :, c] + pre[:, :, c] * (cq[:, :, c] @ state)
        state = state * p_l[:, :, c, None, None] + bq[:, :, c].transpose(-1, -2) @ xx[:, :, c]
    return y.reshape(b, h, nc * chunk, hd)[:, :, :s].transpose(1, 2).contiguous()


# ---- the backward ----


def _grads_of(fn, inputs: list, dy: torch.Tensor) -> list:
    """autograd's gradients of fn(*inputs) against dy in float64 (the step
    loops' states take the inputs' dtype); zeros for unused inputs."""
    with torch.enable_grad():
        leaves = [t.detach().double().requires_grad_() for t in inputs]
        return list(torch.autograd.grad(fn(*leaves), leaves, dy.double(), allow_unused=True,
                                        materialize_grads=True))


def wkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                      u: torch.Tensor, dy: torch.Tensor):
    """The backward kernel's plain version: autograd through ``wkv6_scan_ref``
    against dy, in float64, ``(dr, dk, dv, dlogw, du)`` as
    ``wkv6_scan_bwd_cuda`` returns them (float32); the gradient of log w is
    w times that of w (the chain rule through w = exp(log w), no division)."""
    dr, dk, dv, dw, du = _grads_of(wkv6_scan_ref, [r, k, v, w, u], dy)
    return tuple(g.float() for g in (dr, dk, dv, w.double() * dw, du))


def ssd_scan_bwd_ref(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor, dy: torch.Tensor):
    """The backward kernel's plain version: autograd through ``ssd_scan_ref``
    against dy, in float64, ``(dlogdec, ddtx, dbm, dcm)`` (float32), dbm and
    dcm (B, S, N), the gradients of the shared bm and cm (the kernel's
    per-head ones summed over H)."""
    ddec, ddtx, dbm, dcm = _grads_of(ssd_scan_ref, [decay, dtx, bm, cm], dy)
    return tuple(g.float() for g in (decay.double() * ddec, ddtx, dbm, dcm))


# ---- the backward, in the backward kernels' chunked form ----
#
# ``wkv6_scan_bwd_chunked_ref`` and ``ssd_scan_bwd_chunked_ref`` are
# ``csrc/recurrence_bwd.cu``'s algorithm in plain float32 (its note derives
# it): the chunk-start states from a forward pass over the chunks, then a
# reverse pass that carries G, the gradient of the state at a chunk's end,
# from each chunk to the one before it.  Inside a chunk every gradient is a
# product of the chunk's inputs, its start state, G and the segment products
# of the decays (running products: nothing divides by a decay).  The decays'
# gradient is taken in their log, per step t and key channel (per head for
# the SSD), as sums of products that each contain the decay of step t:
#
#   WKV-6:  dlogw_t = sum_{s<t<tau} M[tau, s] + sum_{tau>t} r_tau * dr0_tau
#                     + sum_{s<t} k_s * dke_s + P_L * rowsum(G * S_start)
#   SSD:    dlogdec_t = sum_{s<t<=tau} M[tau, s] + sum_{tau>=t} c_tau . dc0_tau
#                     + sum_{s<t} b_s . dbe_s + P_L * sum(G * h_start)
#
# where M[tau, s] is the product of a pair of steps inside the chunk
# (WKV-6: (dy_tau . v_s) r_tau k_s prod_{s<sigma<tau} w, per channel; SSD:
# Ls[tau, s] (dy_tau . x_s) (c_tau . b_s)), dr0 (dc0) the part of dr (dc)
# through the chunk's start state and dke (dbe) the part of dk (db) through
# its end state; every sum runs inside one chunk and each is summed
# directly, never as the difference of two larger sums (which would give a
# gradient that is 0, or small beside its terms, as float32 noise); the
# pairs in O(L^2) a chunk (``_pairs_below``).  The kernels split each (b, h)
# over two CTAs by half of the state's key dimension (WKV-6's key channels,
# the SSD's state columns); the gradient that sums over it (dv; ddtx and
# dlogdec) is formed here, as there, as the halves' shares summed in order.
# Nothing here is on the main path: the CPU tests hold both against
# autograd through the step loops and against ``jax.vjp`` of the JAX
# package's scans.


def _chunk_rows(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``_chunked`` without the sub-chunk split: (B, H, n_chunks, chunk, X)."""
    return _chunked(t, chunk).flatten(-3, -2)


def _unchunk(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, n_chunks, chunk, X) back to (B, S, H, X)."""
    b, h, nc, c, x = t.shape
    return t.reshape(b, h, nc * c, x)[:, :, :s].transpose(1, 2).contiguous()


def _excl_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """prod_{tau < t} x_tau along ``dim``, by running products."""
    out = torch.ones_like(x)
    n = x.shape[dim]
    for t in range(1, n):
        out.select(dim, t).copy_(out.select(dim, t - 1) * x.select(dim, t - 1))
    return out


def _pair_products(x: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """M[..., t, s, :] = prod of x over s < tau < t (``inclusive``: s < tau <= t)
    for s < t (s <= t when inclusive), else 0; x (..., L, X) -> (..., L, L, X),
    built gap by gap as running products."""
    n = x.shape[-2]
    m = torch.zeros(x.shape[:-2] + (n, n, x.shape[-1]), dtype=x.dtype, device=x.device)
    run = torch.ones_like(x)  # at gap d: run[s] = the product for t = s + d
    first = 0 if inclusive else 1
    for d in range(first, n):
        if d > first:
            step = x[..., d:, :] if inclusive else x[..., d - 1:n - 1, :]
            run = run[..., :n - d, :] * step
        idx = torch.arange(n - d, device=x.device)
        m[..., idx + d, idx, :] = run[..., :n - d, :]
    return m


def _suffix(x: torch.Tensor, inclusive: bool) -> torch.Tensor:
    """sum_{tau >= t} (``inclusive``) or sum_{tau > t} of x along dim -2."""
    incl = x.flip(-2).cumsum(-2).flip(-2)
    return incl if inclusive else F.pad(incl[..., 1:, :], [0, 0, 0, 1])


def _prefix_excl(x: torch.Tensor) -> torch.Tensor:
    """sum_{s < t} of x along dim -2."""
    return F.pad(x.cumsum(-2)[..., :-1, :], [0, 0, 1, 0])


_HALVES = (slice(0, HEAD_DIM // 2), slice(HEAD_DIM // 2, HEAD_DIM))  # the kernels' two CTAs


def _pairs_below(y: torch.Tensor, r: torch.Tensor | None, strict: bool) -> torch.Tensor:
    """The pairs' sum of the decays' gradient in O(L^2) a chunk, as the
    kernels form it: y (..., tau, s, X) the pair terms (0 off the pairs),
    R[tau][t] = sum_{s<t} y[tau, s] a running sum along s, then pairs_t =
    sum over tau > t (``strict``; tau >= t otherwise) of R[tau][t] times
    r_tau (``r`` (..., tau, X), or 1), a running sum along tau.  Every sum
    adds terms, so t = 0, and a t whose decay is 0, give exactly 0."""
    n = y.shape[-2]
    rows = torch.zeros_like(y)  # R[tau][t]
    for t in range(1, n):
        rows[..., t, :] = rows[..., t - 1, :] + y[..., t - 1, :]
    pairs = torch.zeros_like(y[..., 0, :, :])  # (..., t, X)
    for tau in range(n):
        hi = tau if strict else tau + 1
        term = rows[..., tau, :hi, :]
        if r is not None:
            term = r[..., tau:tau + 1, :] * term
        pairs[..., :hi, :] = pairs[..., :hi, :] + term
    return pairs


def wkv6_scan_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor, *,
                              chunk: int = CHUNK):
    """The gradients of ``wkv6_scan_ref``'s output against ``dy`` (B, S, H, 64):
    ``(dr, dk, dv, dlogw, du)``, dr, dk, dv and the gradient of log w
    (B, S, H, 64), du (H, 64); from a zero state, in float32 (float64 for
    float64 inputs)."""
    b, s, h, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    rc, kc, vc, wc, gy = (_chunk_rows(t.to(dt), chunk) for t in (r, k, v, w, dy))
    p = _excl_cumprod(wc, -2)  # prod_{start <= tau < t} w
    p_l = p[..., -1, :] * wc[..., -1, :]  # (B, H, nc, 64)
    q = _excl_cumprod(wc.flip(-2), -2).flip(-2)  # prod_{s < tau < end} w
    nc = rc.shape[2]
    starts = []
    state = torch.zeros((b, h, hd, hd), dtype=dt, device=r.device)
    for c in range(nc):  # the chunk-start states, forward
        starts.append(state)
        state = p_l[:, :, c, :, None] * state + (kc[:, :, c] * q[:, :, c]).transpose(-1, -2) @ vc[:, :, c]
    s0 = torch.stack(starts, 2)  # (B, H, nc, 64, 64)
    gs = [None] * nc
    g = torch.zeros_like(state)
    for c in reversed(range(nc)):  # G at each chunk's end, backward
        gs[c] = g
        g = p_l[:, :, c, :, None] * g + (rc[:, :, c] * p[:, :, c]).transpose(-1, -2) @ gy[:, :, c]
    g = torch.stack(gs, 2)
    wp = _pair_products(wc, inclusive=False)  # (B, H, nc, t, s, 64)
    dmat = gy @ vc.transpose(-1, -2)  # D[t, s] = dy_t . v_s
    diag = torch.diagonal(dmat, dim1=-2, dim2=-1)[..., None]  # D[t, t]
    uu = u.to(dt)[None, :, None, None, :]
    beta = (rc * uu * kc).sum(-1, keepdim=True)  # the bonus A[t, t]
    # dv sums over every key channel: each half of the channels (one CTA
    # each in the kernel) gives its share, A's entries over its channels and
    # its rows of G; the bonus enters the first half's.  Summed in order.
    dv = None
    for half, ch in enumerate(_HALVES):
        amat = torch.einsum("...ti,...si,...tsi->...ts", rc[..., ch], kc[..., ch], wp[..., ch])
        share = amat.transpose(-1, -2) @ gy + (kc * q)[..., ch] @ g[..., ch, :]
        if half == 0:
            share = share + beta * gy
        dv = share if dv is None else dv + share
    dr_state = p * (gy @ s0.transpose(-1, -2)) + torch.einsum("...ts,...tsi,...si->...ti", dmat, wp, kc)
    dk_in = torch.einsum("...ts,...tsi,...ti->...si", dmat, wp, rc)
    dk_end = q * (vc @ g.transpose(-1, -2))
    dr = dr_state + uu * kc * diag
    dk = dk_in + dk_end + uu * rc * diag
    du = (rc * kc * diag).sum((0, 2, 3))
    pairs = _pairs_below(torch.einsum("...ts,...tsi,...si->...tsi", dmat, wp, kc), rc, strict=True)
    start = rc * p * (gy @ s0.transpose(-1, -2))  # r_tau P_tau (S0 dy_tau)
    dlogw = (pairs + _suffix(start, inclusive=False) + _prefix_excl(kc * dk_end)
             + (p_l * (g * s0).sum(-1))[..., None, :])
    return (*(_unchunk(t, s) for t in (dr, dk, dv, dlogw)), du)


def ssd_scan_bwd_chunked_ref(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                             cm: torch.Tensor, dy: torch.Tensor, *, chunk: int = CHUNK):
    """The gradients of ``ssd_scan_ref``'s output against ``dy`` (B, S, H, 64):
    ``(dlogdec (B, S, H), ddtx (B, S, H, 64), dbm, dcm)``, with dbm and dcm
    per head, (B, S, H, N) (their sum over H is the gradient of the shared
    bm and cm); from a zero state, in float32 (float64 for float64 inputs)."""
    b, s, h, hd = dtx.shape
    n = bm.shape[-1]
    dt = torch.promote_types(dtx.dtype, torch.float32)
    ac = _chunk_rows(decay.to(dt)[..., None], chunk)  # (B, H, nc, L, 1)
    xc, gy = (_chunk_rows(t.to(dt), chunk) for t in (dtx, dy))
    bc, cc = (_chunk_rows(t.to(dt), chunk) for t in (bm, cm))  # (B, 1, nc, L, N)
    pre = _excl_cumprod(ac, -2) * ac  # prod_{start <= tau <= t}
    p_l = pre[..., -1, :]  # (B, H, nc, 1)
    suf = _excl_cumprod(ac.flip(-2), -2).flip(-2)  # prod_{s < tau < end}
    nc = xc.shape[2]
    starts = []
    state = torch.zeros((b, h, hd, n), dtype=dt, device=dtx.device)
    for c in range(nc):
        starts.append(state)
        state = p_l[:, :, c, :, None] * state + (xc[:, :, c] * suf[:, :, c]).transpose(-1, -2) @ bc[:, :, c]
    h0 = torch.stack(starts, 2)  # (B, H, nc, 64, N)
    gs = [None] * nc
    g = torch.zeros_like(state)
    for c in reversed(range(nc)):
        gs[c] = g
        g = p_l[:, :, c, :, None] * g + (gy[:, :, c] * pre[:, :, c]).transpose(-1, -2) @ cc[:, :, c]
    g = torch.stack(gs, 2)
    lm = _pair_products(ac, inclusive=True)[..., 0]  # (B, H, nc, t, s)
    le = lm * (gy @ xc.transpose(-1, -2))  # Ls * E, E[t, s] = dy_t . x_s
    cb = lm * (cc @ bc.transpose(-1, -2))  # Ls * C B^T
    dc_start = pre * (gy @ h0)
    dc = dc_start + le @ bc
    db_in = le.transpose(-1, -2) @ cc
    db_end = suf * (xc @ g)
    dx_pairs = cb.transpose(-1, -2) @ gy
    # The pairs s < t <= tau inside the chunk, M[tau, s] = Ls E (C B^T).
    inner = _pairs_below((cb * (gy @ xc.transpose(-1, -2)))[..., None], None, strict=False)
    # ddtx and dlogdec sum over every state column n: each half of the
    # columns (one CTA each in the kernel) gives its share, the pairs' terms
    # the first half's (dx's Ls (C B^T)^T dy split by d); summed in order.
    dx = dlog = None
    for half, ch in enumerate(_HALVES):
        dx_h = suf * (bc[..., ch] @ g[..., :, ch].transpose(-1, -2))
        dx_h[..., ch] = dx_h[..., ch] + dx_pairs[..., ch]
        dlog_h = ((_suffix((cc[..., ch] * dc_start[..., ch]).sum(-1, keepdim=True), inclusive=True)
                   + (inner if half == 0 else 0.0))
                  + (_prefix_excl((bc[..., ch] * db_end[..., ch]).sum(-1, keepdim=True))
                     + (p_l * (g[..., ch] * h0[..., ch]).sum((-1, -2))[..., None])[..., None, :]))
        dx = dx_h if dx is None else dx + dx_h
        dlog = dlog_h if dlog is None else dlog + dlog_h
    return (_unchunk(dlog, s)[..., 0], _unchunk(dx, s), _unchunk(db_in + db_end, s),
            _unchunk(dc, s))
