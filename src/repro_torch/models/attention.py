"""GQA attention: full sequences and KV-cache decode (port of
``repro.models.attention``).

``attention(params, cfg, x, impl=...)`` keeps the JAX package's rule:
``"auto"`` takes the blocked path above 2048 tokens and the dense path
below.  The dense path materialises the scores in plain torch, as XLA
computed them.  The blocked path calls ``ops.flash_attention``: on CUDA
tensors that launches the hand-written flash-attention kernel, on CPU
tensors its plain version.  This is the one place where the port's wiring
departs from the JAX package's, whose blocked path is a ``lax.scan`` over
the same online-softmax schedule as its Pallas kernel; the tests hold the
port against both.

``decode_attention`` is one token per sequence against a KV cache, each
sequence at its own position (continuous batching); it is a plain
PyTorch product, as JAX's is plain ``jnp``, and reaches no kernel.

Not ported: the custom-VJP backward (ROADMAP.md Queue 1 item 3) and
``decode_attention(lse_partial=True)``, whose one caller is the sharded
decode (item 10).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, frozen, normal, rope_frequencies

__all__ = [
    "Attention",
    "NEG_INF",
    "attention",
    "compute_kv",
    "decode_attention",
    "init_attention",
    "project_qkv",
]

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


def project_qkv(params, cfg, x: torch.Tensor, *, positions: torch.Tensor | None = None,
                rope: bool = True):
    """q (B, S, H, hd), k and v (B, S, KV, hd).  With ``rope``, q and k are
    rotated at ``positions`` ((S,) or per sequence (B, S); default 0..S-1)."""
    q = _head_proj(x, params["wq"])
    k = _head_proj(x, params["wk"])
    if rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_frequencies(cfg.head_dim, positions, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
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


def compute_kv(params, cfg, x: torch.Tensor, *, rope: bool = False):
    """K/V for cross-attention from encoder states, (B, S, KV, hd) each.
    ``rope`` is accepted and ignored, as in JAX."""
    return _head_proj(x, params["wk"]), _head_proj(x, params["wv"])


def decode_attention(
    params,
    cfg,
    x: torch.Tensor,  # (B, 1, d_model) current-token activations
    cache_k: torch.Tensor,  # (B, S_cache, KV, hd)
    cache_v: torch.Tensor,
    pos,  # (B,) per-sequence positions, or one for all
    *,
    update_cache: bool = True,
    lse_partial: bool = False,
    rope: bool = True,
    rope_pos=None,
):
    """Single-token decode with a KV cache and per-sequence positions:
    slots of a continuous-batching server progress independently.

    With ``update_cache`` this token's k and v are written into the caches
    IN PLACE at ``(b, pos[b])``; cache entries past ``pos[b]`` are masked,
    so a reused slot's stale rows need no clearing.  Each ``pos[b]`` must
    lie in ``[0, S_cache)``: JAX drops a write past the cache, this index
    write raises (on the card, a device-side assert).  ``rope_pos``
    decouples the rotary position from the cache and mask position.
    Scores are float32; probabilities are cast back to the activations'
    dtype, as in JAX.  Returns ``(out (B, 1, d_model), cache_k, cache_v)``.
    """
    if lse_partial:
        raise NotImplementedError(
            "decode_attention(lse_partial=True) is not ported yet: its one caller is the "
            "sharded decode (distributed/decode.py), ROADMAP.md Queue 1 item 10"
        )
    b, hd = x.shape[0], cfg.head_dim
    pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device), (b,)).long()
    rp = pos if rope_pos is None else torch.broadcast_to(
        torch.as_tensor(rope_pos, device=x.device), (b,))
    q, k_new, v_new = project_qkv(params, cfg, x, positions=rp[:, None], rope=rope)
    if update_cache:
        bidx = torch.arange(b, device=x.device)
        cache_k[bidx, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[bidx, pos] = v_new[:, 0].to(cache_v.dtype)
    skv, kvh = cache_k.shape[1], cache_k.shape[2]
    g = cfg.num_heads // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, cache_k.to(q.dtype)).float() * hd**-0.5
    valid = torch.arange(skv, device=x.device)[None, :] <= pos[:, None]  # (B, skv)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkd->bkgqd", probs, cache_v.to(q.dtype))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, cfg.num_heads, hd)
    return _out_proj(params, out), cache_k, cache_v


class Attention(nn.Module):
    """Holds ``wq``, ``wk``, ``wv`` and ``wo`` in the JAX package's head-structured shapes."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, frozen(params[name]))

    def params(self) -> dict[str, torch.Tensor]:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
