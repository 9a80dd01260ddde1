"""RWKV-6 "Finch" block: attention-free token mixing with a data-dependent
decay (port of ``repro.models.rwkv``).

Per head (head_dim 64) the WKV state S (64 x 64) evolves as

    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with ``w_t = exp(-exp(w_base + lora_w(x_t)))``.  Token shift mixes each
projection's input with the previous token's.  The sequence path runs the
recurrence through ``kernels.recurrence.ops.wkv6_scan_logw``, which takes
log w = -exp(w_base + lora) and forms w from it: on the card one
hand-written kernel for the whole sequence, where JAX runs ``lax.scan``,
and under autograd its backward kernel; on the CPU its plain per-step
loop.  Decode is one state update in plain
PyTorch, as JAX's is plain ``jnp``.  Weights stay in ``cfg.param_dtype``
and are cast to the activations' dtype at use, as in JAX.

Under a model axis (``distributed.tensor_parallel``) the time mix's weights
are replicated (the rules leave them whole), so its projections are
computed whole on every model rank, as GSPMD does; the scan runs on the
rank's heads, as JAX's ``head_shard`` pins them, when the axis divides
them (``split``, then ``gather`` of the output).  The channel mix's ``ck``
and ``cv`` are the rank's shard of the hidden width (columns, then rows)
where the rules shard it.  Decode keeps the rank's shard of the WKV
state: its heads, or, where the heads do not divide the axis, its rows of
the key dimension, whose partial outputs are summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.recurrence.ops import wkv6_scan_logw
from repro_torch.models.layers import init_dense, normal

__all__ = [
    "HEAD_DIM",
    "LORA_R",
    "init_rwkv_block",
    "init_rwkv_state",
    "rwkv_channel_mix_seq",
    "rwkv_channel_mix_step",
    "rwkv_time_mix_seq",
    "rwkv_time_mix_step",
]

HEAD_DIM = 64
LORA_R = 32


def init_rwkv_block(gen: torch.Generator, cfg) -> dict:
    """The block's weights, named and shaped as JAX's ``init_rwkv_block``."""
    d, ff, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    dev = gen.device

    def full(value: float) -> torch.Tensor:
        return torch.full((d,), value, dtype=pd, device=dev)

    return {
        "wr": init_dense(gen, d, d, dtype=pd)["w"],
        "wk": init_dense(gen, d, d, dtype=pd)["w"],
        "wv": init_dense(gen, d, d, dtype=pd)["w"],
        "wg": init_dense(gen, d, d, dtype=pd)["w"],
        "wo": init_dense(gen, d, d, dtype=pd)["w"],
        "w_lora_a": init_dense(gen, d, LORA_R, dtype=pd)["w"],
        "w_lora_b": normal(gen, (LORA_R, d), 0.01, pd),
        "w_base": full(-6.0),
        "u_bonus": normal(gen, (d,), 0.1, pd),
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_g": full(0.5),
        "mu_w": full(0.5),
        "ck": init_dense(gen, d, ff, dtype=pd)["w"],
        "cv": init_dense(gen, ff, d, dtype=pd)["w"],
        "cr": init_dense(gen, d, d, dtype=pd)["w"],
        "mu_ck": full(0.5),
        "mu_cr": full(0.5),
        "ln_x": torch.ones(d, dtype=pd, device=dev),
    }


def init_rwkv_state(cfg, batch: int, *, dtype=torch.float32, device="cpu") -> dict:
    """One layer's decode state: ``wkv`` (B, H, 64, 64) and the last inputs of
    the time mix and the channel mix, ``x_prev_t`` and ``x_prev_c`` (B, d)."""
    d = cfg.d_model
    heads = d // HEAD_DIM
    return {
        "wkv": torch.zeros((batch, heads, HEAD_DIM, HEAD_DIM), dtype=dtype, device=device),
        "x_prev_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_prev_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor, x_prev_first=None) -> torch.Tensor:
    """x_{t-1} at every position, (B, S, d); row 0 is ``x_prev_first`` or zero."""
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x_prev_first is not None:
        shifted = shifted.clone()
        shifted[:, 0] = x_prev_first.to(x.dtype)
    return shifted


def _mix(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _projections(params: dict, x: torch.Tensor, xs: torch.Tensor):
    """r, k, v, g in x's dtype and the float32 log decay log w, each (..., d)."""
    dt = x.dtype
    r = _mix(x, xs, params["mu_r"]) @ params["wr"].to(dt)
    k = _mix(x, xs, params["mu_k"]) @ params["wk"].to(dt)
    v = _mix(x, xs, params["mu_v"]) @ params["wv"].to(dt)
    g = _mix(x, xs, params["mu_g"]) @ params["wg"].to(dt)
    wx = _mix(x, xs, params["mu_w"])
    lora = torch.tanh(wx @ params["w_lora_a"].to(dt)) @ params["w_lora_b"].to(dt)
    log_w = -torch.exp(params["w_base"].float() + lora.float())
    return r, k, v, g, log_w


def _group_norm_out(params: dict, y: torch.Tensor, g: torch.Tensor, dt: torch.dtype):
    """Per-head group norm of the float32 WKV output y (..., H, 64), the
    ``ln_x`` scale, the SiLU gate and the output projection."""
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, unbiased=False)
    y = ((y - mean) * torch.rsqrt(var + 1e-5)).flatten(-2)
    y = y.to(dt) * params["ln_x"].to(dt)
    return (y * F.silu(g)) @ params["wo"].to(dt)


def rwkv_time_mix_seq(params: dict, cfg, x: torch.Tensor, *, x_prev=None) -> torch.Tensor:
    """Full-sequence WKV.  x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    heads = d // HEAD_DIM
    r, k, v, g, log_w = _projections(params, x, _token_shift(x, x_prev))
    rh, kh, vh = (t.reshape(b, s, heads, HEAD_DIM).float() for t in (r, k, v))
    lw = log_w.reshape(b, s, heads, HEAD_DIM)
    u = params["u_bonus"].float().reshape(heads, HEAD_DIM)
    if not tp.splits(heads):
        return _group_norm_out(params, wkv6_scan_logw(rh, kh, vh, lw, u), g, x.dtype)
    # the scan on the rank's heads: one split of the four inputs, one gather of y
    rh, kh, vh, lw = tp.split(torch.stack([rh, kh, vh, lw]), 3).unbind(0)
    y = wkv6_scan_logw(rh, kh, vh, lw, tp.split(u, 0))
    return _group_norm_out(params, tp.gather(y, 2), g, x.dtype)


def _channel_mix(params: dict, cfg, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """r * (relu(k)^2 @ cv), on the rank's shard of the hidden width where
    ``ck`` holds fewer than ``cfg.d_ff`` columns."""
    dt = x.dtype
    sharded = params["ck"].shape[-1] != cfg.d_ff
    xk = _mix(x, xs, params["mu_ck"])
    k = (tp.copy_to(xk) if sharded else xk) @ params["ck"].to(dt)
    r = torch.sigmoid(_mix(x, xs, params["mu_cr"]) @ params["cr"].to(dt))
    kv = torch.relu(k).square() @ params["cv"].to(dt)
    return r * (tp.reduce_from(kv) if sharded else kv)


def rwkv_channel_mix_seq(params: dict, cfg, x: torch.Tensor, *, x_prev=None) -> torch.Tensor:
    return _channel_mix(params, cfg, x, _token_shift(x, x_prev))


def rwkv_time_mix_step(params: dict, cfg, xt: torch.Tensor, wkv_state: torch.Tensor,
                       x_prev: torch.Tensor):
    """One-token time mix.  xt: (B, d) (post-norm).  Returns ``(out, wkv',
    xt)``, the new state a new tensor in ``wkv_state``'s dtype."""
    b, d = xt.shape
    heads = d // HEAD_DIM
    r, k, v, g, log_w = _projections(params, xt, x_prev.to(xt.dtype))
    rh, kh, vh = (t.reshape(b, heads, HEAD_DIM).float() for t in (r, k, v))
    wh = torch.exp(log_w).reshape(b, heads, HEAD_DIM)
    u = params["u_bonus"].float().reshape(heads, HEAD_DIM)
    state = wkv_state.float()
    # the rank's shard of the state: its heads (dim 1) or its key rows (dim 2)
    dim = 1 if state.shape[1] != heads else 2 if state.shape[2] != HEAD_DIM else None
    if dim is not None:
        lo, hi = tp.local_range(state.shape[dim] * tp.size())
        rh, kh, wh = (t.narrow(dim, lo, hi - lo) for t in (rh, kh, wh))
        u = u.narrow(dim - 1, lo, hi - lo)
        vh = vh.narrow(1, lo, hi - lo) if dim == 1 else vh
    kv = kh[..., :, None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rh, state + u[None, :, :, None] * kv)
    s_new = wh[..., None] * state + kv
    if dim == 1:
        y = tp.gather(y, 1)
    elif dim == 2:
        y = tp.reduce_from(y)
    return _group_norm_out(params, y, g, xt.dtype), s_new.to(wkv_state.dtype), xt


def rwkv_channel_mix_step(params: dict, cfg, xt: torch.Tensor, x_prev: torch.Tensor):
    """One-token channel mix.  xt: (B, d) (post-norm).  Returns ``(out, xt)``."""
    return _channel_mix(params, cfg, xt, x_prev.to(xt.dtype)), xt
