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

__all__ = ["CHUNK", "HEAD_DIM", "SUB", "ssd_scan_chunked_ref", "ssd_scan_ref",
           "wkv6_scan_chunked_ref", "wkv6_scan_ref"]

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
