"""Shared neural building blocks (port of ``repro.models.layers``).

Plain functions over tensors, with the JAX package's arithmetic and
dtypes, plus ``nn.Module`` holders (``RMSNorm``, ``SwiGLU``) whose
parameter names match the JAX pytree's keys.  Parameters are kept in
``cfg.param_dtype`` (float32 masters) and cast to the activations' dtype
at use, as in JAX.  Random draws take an explicit ``torch.Generator``;
they are not JAX's threefry numbers, so tests carry JAX weights over with
``repro_torch.convert.lm_params_from_numpy``.

The modules' parameters take gradients (the training path,
``model_zoo.make_train_step``); prefill and decode run under
``torch.inference_mode`` and build no graph.  ``grad_fence_bf16`` is the
identity whose backward rounds the cotangent to bf16, as JAX's custom VJP
does at every layer boundary.

JAX's ``shard_hint`` / ``head_shard`` are GSPMD's sharding hints (no-ops
outside a mesh).  Their counterpart is ``distributed.tensor_parallel``: under
a model axis the layers compute the rank's shard of their heads, hidden
width, experts or vocabulary, and the scans run on the rank's heads, as the
hints pin them; the sharded steps (``distributed.sharded_step``,
``distributed.sharded_serve``) place the weights and the rows.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp

__all__ = [
    "RMSNorm",
    "SwiGLU",
    "apply_rope",
    "grad_fence_bf16",
    "init_dense",
    "init_embedding",
    "init_swiglu",
    "normal",
    "rms_norm",
    "rope_frequencies",
    "swiglu",
]


class _GradFenceBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def grad_fence_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to bf16 and back (JAX's
    ``grad_fence_bf16``): parameter gradients still accumulate in float32."""
    return _GradFenceBf16.apply(x)


class ShapesOnly:
    """Stands for a generator on ``meta``, where ``torch.Generator`` cannot
    live: ``normal`` then gives the shape and dtype without a draw."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 on the generator's device, then
    cast; on ``meta`` (``ShapesOnly``) the shape alone."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics; the normalising multiply stays in x.dtype."""
    dt = x.dtype
    var = x.float().square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(dt)
    return x * scale * weight.to(dt)


def init_dense(gen, d_in: int, d_out: int, *, dtype=torch.float32, scale: float | None = None):
    scale = scale if scale is not None else d_in**-0.5
    return {"w": normal(gen, (d_in, d_out), scale, dtype)}


def init_embedding(gen, vocab: int, d: int, *, dtype=torch.float32):
    return {"emb": normal(gen, (vocab, d), d**-0.5, dtype)}


def init_swiglu(gen, d: int, d_ff: int, *, dtype=torch.float32):
    return {
        "w_gate": init_dense(gen, d, d_ff, dtype=dtype)["w"],
        "w_up": init_dense(gen, d, d_ff, dtype=dtype)["w"],
        "w_down": init_dense(gen, d_ff, d, dtype=dtype, scale=d_ff**-0.5)["w"],
    }


def swiglu(params, x: torch.Tensor, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  ``d_ff`` is the layer's full hidden width: when the weights
    hold fewer columns, they are the rank's shard of it (split by columns,
    then by rows), and the partial product is summed over the model axis."""
    dt = x.dtype
    sharded = d_ff is not None and params["w_gate"].shape[-1] != d_ff
    if sharded:
        x = tp.copy_to(x)
    gate = torch.nn.functional.silu(x @ params["w_gate"].to(dt))
    up = x @ params["w_up"].to(dt)
    out = (gate * up) @ params["w_down"].to(dt)
    return tp.reduce_from(out) if sharded else out


def rope_frequencies(head_dim: int, positions: torch.Tensor, theta: float = 1e4):
    """(..., head_dim/2) float32 cos/sin tables for the given positions."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (seq, head_dim/2)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    c = cos[..., :, None, :].float()  # broadcast over the heads axis
    s = sin[..., :, None, :].float()
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(dt)


class RMSNorm(nn.Module):
    """Holds the norm's ``weight``; ``eps`` comes from the config at the call."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rms_norm(x, self.weight, eps)

    def params(self) -> torch.Tensor:
        return self.weight


class SwiGLU(nn.Module):
    """Holds ``w_gate``/``w_up`` (d, d_ff) and ``w_down`` (d_ff, d)."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.w_gate = nn.Parameter(params["w_gate"])
        self.w_up = nn.Parameter(params["w_up"])
        self.w_down = nn.Parameter(params["w_down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self.params(), x)

    def params(self) -> dict[str, torch.Tensor]:
        return {"w_gate": self.w_gate, "w_up": self.w_up, "w_down": self.w_down}
