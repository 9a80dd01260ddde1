"""Plain PyTorch versions of the recurrence kernels: per-step loops written as
the JAX package's step functions (``repro.models.rwkv.rwkv_time_mix_seq``'s
and ``repro.models.ssm.mamba_seq``'s).

The CPU path of ``ops`` and the oracle that the tests and ``chip_smoke.py``
hold the CUDA kernels against.  Each step is a handful of small launches
on the card, so at model lengths the kernels take their place there.
JAX's ``scan_chunk`` only places rematerialisation checkpoints
(``_chunked_scan``); the forward values do not depend on it, so these
loops take no chunk.
"""

from __future__ import annotations

import torch

__all__ = ["HEAD_DIM", "ssd_scan_ref", "wkv6_scan_ref"]

HEAD_DIM = 64


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
