"""Mamba2-style selective state-space block, zamba2's core layer (port of
``repro.models.ssm``).

The simplified SSD recurrence with a multi-head state:

    h_t = exp(-softplus(dt_t) * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · h_t + D * x_t

State: (batch, heads, head_dim 64, d_state).  The sequence path runs the
recurrence through ``kernels.recurrence.ops.ssd_scan_logdec``, which takes
the decay's log, softplus(dt) * A, and forms the decay from it: on the card
one hand-written kernel for the whole sequence, where JAX runs
``lax.scan``, and under autograd its backward kernel; on the CPU its plain
per-step loop.  Decode is one state update in plain
PyTorch, as JAX's is plain ``jnp``.

Under a model axis (``distributed.tensor_parallel``) the block's weights
are replicated (the rules leave them whole), so its projections are
computed whole on every model rank, as GSPMD does; the scan runs on the
rank's heads, as JAX's ``head_shard`` pins them, when the axis divides
them, and decode updates the rank's heads of ``h``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.recurrence.ops import ssd_scan_logdec
from repro_torch.models.layers import init_dense, normal

__all__ = ["CONV_K", "init_mamba", "init_mamba_state", "mamba_decode_step", "mamba_seq"]

CONV_K = 4  # the short causal depthwise conv's window
HEAD_DIM = 64


def init_mamba(gen: torch.Generator, cfg, *, d_model: int | None = None) -> dict:
    """The block's weights, named and shaped as JAX's ``init_mamba``."""
    d = d_model or cfg.d_model
    d_inner = 2 * d
    heads = d_inner // HEAD_DIM
    ds = cfg.ssm_state
    pd = cfg.param_dtype
    dev = gen.device
    return {
        # input projection -> [x (d_inner), z (d_inner), B (ds), C (ds), dt (heads)]
        "w_in": init_dense(gen, d, 2 * d_inner + 2 * ds + heads, dtype=pd)["w"],
        "w_out": init_dense(gen, d_inner, d, dtype=pd)["w"],
        "conv": normal(gen, (CONV_K, d_inner + 2 * ds), 0.1, pd),
        "a_log": torch.zeros(heads, dtype=pd, device=dev),  # A = -exp(a_log)
        "d_skip": torch.ones(heads, dtype=pd, device=dev),
        "dt_bias": torch.zeros(heads, dtype=pd, device=dev),
    }


def init_mamba_state(cfg, batch: int, *, d_model: int | None = None, dtype=torch.float32,
                     device="cpu") -> dict:
    """One layer's decode state: ``h`` (B, heads, 64, d_state) and the conv's
    last ``CONV_K - 1`` inputs, ``conv_buf`` (B, 3, d_inner + 2 d_state)."""
    d = d_model or cfg.d_model
    d_inner = 2 * d
    heads = d_inner // HEAD_DIM
    return {
        "h": torch.zeros((batch, heads, HEAD_DIM, cfg.ssm_state), dtype=dtype, device=device),
        "conv_buf": torch.zeros((batch, CONV_K - 1, d_inner + 2 * cfg.ssm_state), dtype=dtype,
                                device=device),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, ds: int):
    """x, z, B, C, dt: views of the input projection's last axis."""
    return torch.split(proj, [d_inner, d_inner, ds, ds, proj.shape[-1] - 2 * d_inner - 2 * ds],
                       dim=-1)


def _causal_conv(seq: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with window ``CONV_K``, then SiLU."""
    s = seq.shape[1]
    out = torch.zeros_like(seq)
    for i in range(CONV_K):
        shifted = F.pad(seq, (0, 0, i, 0))[:, :s]
        out = out + shifted * weights[CONV_K - 1 - i]
    return F.silu(out)


def _dt_decay(params: dict, dt: torch.Tensor):
    """softplus(dt + dt_bias) and the decay's log softplus(.) * A, float32
    (the decay is its exp)."""
    a = -torch.exp(params["a_log"].float())
    dt_act = F.softplus(dt.float() + params["dt_bias"].float())
    return dt_act, dt_act * a


def mamba_seq(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 pass.  x: (B, S, d) -> (B, S, d)."""
    bsz, s, d = x.shape
    d_inner, ds = 2 * d, cfg.ssm_state
    heads = d_inner // HEAD_DIM
    dt_ = x.dtype
    xi, z, b, c, dt = _split_proj(x @ params["w_in"].to(dt_), d_inner, ds)
    conv_out = _causal_conv(torch.cat([xi, b, c], dim=-1), params["conv"].to(dt_))
    xi, b, c = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    dt_act, log_decay = _dt_decay(params, dt)  # (B, S, heads)
    xh = xi.reshape(bsz, s, heads, HEAD_DIM).float()
    dtx = dt_act[..., None] * xh
    if tp.splits(heads):
        # the scan on the rank's heads: B and C are every head's (their
        # gradients summed over the axis), y gathered
        bc = tp.copy_to(torch.stack([b.float(), c.float()]))
        y = tp.gather(ssd_scan_logdec(tp.split(log_decay, 2), tp.split(dtx, 2), bc[0], bc[1]), 2)
    else:
        y = ssd_scan_logdec(log_decay, dtx, b.float(), c.float())  # (B, S, heads, 64)
    y = y + params["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner).to(dt_) * F.silu(z)
    return y @ params["w_out"].to(dt_)


def mamba_decode_step(params: dict, cfg, x: torch.Tensor, state: dict):
    """Single-token decode.  x: (B, 1, d); returns ``(y (B, 1, d), new_state)``,
    the new state new tensors in the old state's dtypes."""
    bsz, _, d = x.shape
    d_inner, ds = 2 * d, cfg.ssm_state
    heads = d_inner // HEAD_DIM
    dt_ = x.dtype
    xi, z, b, c, dt = _split_proj(x[:, 0] @ params["w_in"].to(dt_), d_inner, ds)
    conv_in = torch.cat([xi, b, c], dim=-1)  # (B, C)
    buf = torch.cat([state["conv_buf"].to(dt_), conv_in[:, None]], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", buf, params["conv"].to(dt_)))
    xi, b, c = torch.split(conv_out, [d_inner, ds, ds], dim=-1)
    dt_act, log_decay = _dt_decay(params, dt)  # (B, heads)
    decay = torch.exp(log_decay)
    xh = xi.reshape(bsz, heads, HEAD_DIM).float()
    h = state["h"].float()
    xl = xh
    if h.shape[1] != heads:  # the rank's heads of the state
        lo, hi = tp.local_range(heads)
        decay, dt_act, xl = decay[:, lo:hi], dt_act[:, lo:hi], xh[:, lo:hi]
    h = h * decay[..., None, None] + (dt_act[..., None] * xl)[..., None] * b.float()[:, None, None, :]
    y = torch.einsum("bhds,bs->bhd", h, c.float())
    if h.shape[1] != heads:
        y = tp.gather(y, 1)
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(dt_) * F.silu(z)
    out = (y @ params["w_out"].to(dt_))[:, None]
    return out, {"h": h.to(state["h"].dtype), "conv_buf": buf[:, 1:].to(state["conv_buf"].dtype)}
