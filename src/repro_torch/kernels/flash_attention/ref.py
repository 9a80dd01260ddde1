"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``).

The CPU path of ``ops.flash_attention`` and the oracle that the tests and
``chip_smoke.py`` hold the CUDA kernel against.  It materialises scores in
float32; ``q_chunk`` bounds them to ``(BH, q_chunk, S)`` at a time, so a
32k-token sequence can be checked without a 4.3 GB score matrix per head.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "max_row_error"]

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int | None = None,
    return_lse: bool = False,
):
    """q (BH, S, D), k and v (BH, S_kv, D) -> (BH, S, D) in q's dtype, with a
    float32 softmax.  S_kv may differ from S only when not causal
    (cross-attention).  With ``return_lse`` also each row's float32
    log-sum-exp of the scaled, masked scores, (BH, S)."""
    bh, s, d = q.shape
    skv = k.shape[1]
    if causal and skv != s:
        raise ValueError(f"causal attention needs as many keys as queries: S={s}, S_kv={skv}")
    chunk = s if q_chunk is None else q_chunk
    if chunk < 1:
        raise ValueError(f"q_chunk={q_chunk} must be positive")
    kt = k.float().transpose(1, 2)
    vf = v.float()
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) if return_lse else None
    for i0 in range(0, s, chunk):
        i1 = min(s, i0 + chunk)
        scores = torch.bmm(q[:, i0:i1].float(), kt) * d**-0.5
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)
            scores.masked_fill_(qpos[:, None] < kpos[None, :], NEG_INF)
        out[:, i0:i1] = torch.bmm(torch.softmax(scores, dim=-1), vf).to(q.dtype)
        if return_lse:
            lse[:, i0:i1] = torch.logsumexp(scores, dim=-1)
    return (out, lse) if return_lse else out


def max_row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``||got - want|| / ||want||`` over rows (the last axis).

    Attention averages ``v`` over ever more keys as a causal row grows, so
    its output shrinks like ``t**-0.5``: a fixed absolute limit that suits
    the first rows is larger than the late rows themselves.  Measured
    against each row's own norm, a fault confined to late rows still shows.
    """
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())
