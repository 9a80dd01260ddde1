"""GQA attention for full sequences (port of ``repro.models.attention``).

``attention(params, cfg, x, impl=...)`` keeps the JAX package's rule:
``"auto"`` takes the blocked path above 2048 tokens and the dense path
below.  The dense path materialises the scores in plain torch, as XLA
computed them.  The blocked path calls ``ops.flash_attention``: on CUDA
tensors that launches the hand-written flash-attention kernel, on CPU
tensors its plain version.  This is the one place where the port's wiring
departs from the JAX package's, whose blocked path is a ``lax.scan`` over
the same online-softmax schedule as its Pallas kernel; the tests hold the
port against both.

Not in this slice: ``decode_attention``, ``compute_kv`` and the custom-VJP
backward (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, frozen, normal, rope_frequencies

__all__ = ["Attention", "NEG_INF", "attention", "init_attention", "project_qkv"]

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg) -> dict:
    """Head-structured weights: wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d)."""
    d = cfg.d_model
    hd = cfg.head_dim
    pd = cfg.param_dtype
    return {
        "wq": normal(gen, (d, cfg.num_heads, hd), d**-0.5, pd),
        "wk": normal(gen, (d, cfg.num_kv_heads, hd), d**-0.5, pd),
        "wv": normal(gen, (d, cfg.num_kv_heads, hd), d**-0.5, pd),
        "wo": normal(gen, (cfg.num_heads, hd, d), (cfg.num_heads * hd) ** -0.5, pd),
    }


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd).to(x.dtype)).view(*x.shape[:-1], heads, hd)


def _out_proj(params, out: torch.Tensor) -> torch.Tensor:
    """out: (B, S, H, hd) -> (B, S, d): einsum('bshk,hkd->bsd')."""
    heads, hd, d = params["wo"].shape
    return out.reshape(*out.shape[:-2], heads * hd) @ params["wo"].reshape(heads * hd, d).to(
        out.dtype
    )


def project_qkv(params, cfg, x: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, KV, hd), with RoPE at positions 0..S-1."""
    positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = rope_frequencies(cfg.head_dim, positions, cfg.rope_theta)
    q = apply_rope(_head_proj(x, params["wq"]), cos, sin)
    k = apply_rope(_head_proj(x, params["wk"]), cos, sin)
    return q, k, _head_proj(x, params["wv"])


def _repeat_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D)."""
    kvh = k.shape[2]
    return k if kvh == h else k.repeat_interleave(h // kvh, dim=2)


def _dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Materialising path for short sequences.  q (B,S,H,D), k/v (B,Skv,KV,D)."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = scores * d**-0.5
    if causal:
        qpos = torch.arange(s, device=q.device)
        kpos = torch.arange(skv, device=q.device)
        scores = scores.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention(params, cfg, x: torch.Tensor, *, causal: bool = True,
              impl: str | None = None) -> torch.Tensor:
    """Full-sequence attention (prefill).  x: (B, S, d_model) -> (B, S, d_model);
    the caller adds the residual."""
    q, k, v = project_qkv(params, cfg, x)
    impl = impl or cfg.attention_impl
    if impl == "auto":
        impl = "blocked" if max(q.shape[1], k.shape[1]) > 2048 else "dense"
    if impl == "dense":
        out = _dense_attention(q, k, v, causal=causal)
    elif impl == "blocked":
        out = flash_attention(q, k, v, causal=causal)
    else:
        raise ValueError(f"attention impl {impl!r}: use 'auto', 'dense' or 'blocked'")
    return _out_proj(params, out)


class Attention(nn.Module):
    """Holds ``wq``, ``wk``, ``wv`` and ``wo`` in the JAX package's head-structured shapes."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, frozen(params[name]))

    def params(self) -> dict[str, torch.Tensor]:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
