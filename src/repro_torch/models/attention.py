"""GQA attention: full sequences and KV-cache decode (port of
``repro.models.attention``).

``attention(params, cfg, x, impl=...)`` keeps the JAX package's rule:
``"auto"`` takes the blocked path above 2048 tokens and the dense path
below.  The dense path materialises the scores in plain torch, as XLA
computed them, and takes its gradients from autograd, as JAX's does.  The
blocked path calls ``ops.flash_attention``: on CUDA tensors that launches
the hand-written flash-attention kernel, on CPU tensors its plain version.
This is where the port's wiring departs from the JAX package's, whose
blocked forward is a ``lax`` loop over the same online-softmax schedule as
its Pallas kernel; the tests hold the port against both.

When gradients are needed, the blocked path is ``_BlockedAttention``, the
port of JAX's ``_blocked_attention`` custom VJP: the forward asks the kernel
for each row's log-sum-exp beside the output and saves only
``(q, k, v, out, lse)``; the backward recomputes each
``(block_q, block_kv)`` score block from them in plain PyTorch, a dq pass
and a dk/dv pass as in JAX (whose backward is plain ``jnp`` too), so no
``S x S`` matrix is ever held.

``decode_attention`` is one token per sequence against a KV cache, each
sequence at its own position (continuous batching); it is a plain
PyTorch product, as JAX's is plain ``jnp``, and reaches no kernel.

Under a model axis (``distributed.tensor_parallel``) the weights are the
rank's shards: ``wq``, ``wk``, ``wv`` on heads and ``wo`` on its head rows
where the rules shard them.  The head counts are read from the weights'
shapes, so the rank computes its heads only (the flash kernel runs on
``H/tp`` of them); the input enters the region through ``copy_to`` and the
output projection's partial sum leaves through ``reduce_from``.  When the
KV heads do not divide the axis, ``wk``/``wv`` are whole, and each rank
takes the KV heads its query heads read (``tensor_parallel.kv_for_heads``).

With ``lse_partial`` it returns a window's flash-decoding partials (the
normalised output and its log-sum-exp), which
``distributed.decode.sharded_decode_attention`` combines across the ranks
that hold the cache's sequence windows.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, normal, rope_frequencies

__all__ = [
    "Attention",
    "NEG_INF",
    "attention",
    "blocked_attention",
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
    xq = _region_input(params, cfg, x)
    q = _head_proj(xq, params["wq"])
    k = _head_proj(xq if _sharded(params["wk"], cfg.num_kv_heads) else x, params["wk"])
    if rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_frequencies(cfg.head_dim, positions, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, _head_proj(xq if _sharded(params["wv"], cfg.num_kv_heads) else x, params["wv"])


def _sharded(w: torch.Tensor, heads: int) -> bool:
    """Whether a (d, heads, hd) projection holds the rank's shard of its heads."""
    return w.shape[1] != heads


def _region_input(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the sharded heads' projections read it: through ``copy_to``
    when the rank holds a shard of the query heads."""
    return tp.copy_to(x) if _sharded(params["wq"], cfg.num_heads) else x


def _exit(params, cfg, out: torch.Tensor) -> torch.Tensor:
    """The output projection's partial sum over the rank's heads, summed."""
    return tp.reduce_from(out) if params["wo"].shape[0] != cfg.num_heads else out


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


def _block_scores(qb, kb, q0: int, k0: int, causal: bool, scale: float) -> torch.Tensor:
    """float32 scaled scores of one (query block, key block) pair, (b, h, q, t),
    with keys above the causal diagonal at ``NEG_INF``."""
    sc = torch.matmul(qb, kb.transpose(-1, -2)).float() * scale
    if causal and k0 + kb.shape[2] - 1 > q0:
        qpos = torch.arange(q0, q0 + qb.shape[2], device=qb.device)
        kpos = torch.arange(k0, k0 + kb.shape[2], device=qb.device)
        sc = sc.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    return sc


def _blocked_backward(q, k, v, out, lse, dout, *, causal: bool, block_q: int, block_kv: int):
    """dq, dk, dv of attention from the saved forward: JAX's recomputing
    backward (``_blocked_attention_bwd``) in plain PyTorch.

    q, out, dout (B, S, H, D); k, v (B, Skv, KV, D); lse (B, H, S) float32.
    Products take the inputs' dtype (probabilities and ``ds`` are rounded to
    it, as in JAX), accumulators are float32.  Key blocks wholly above the
    causal diagonal are skipped: there ``p = exp(NEG_INF - lse)`` is exactly
    0, so they add nothing.
    """
    b, s, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    bq, bkv = min(block_q, s), min(block_kv, skv)
    scale = d**-0.5
    dt = q.dtype
    qh = q.transpose(1, 2).contiguous()  # (b, h, s, d)
    kh = _repeat_kv(k, h).transpose(1, 2).contiguous()
    vh = _repeat_kv(v, h).transpose(1, 2).contiguous()
    doh = dout.to(dt).transpose(1, 2).contiguous()
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # rowsum(dout * out): (b, h, s)
    lse = lse.float()
    q_blocks = [(q0, min(s, q0 + bq)) for q0 in range(0, s, bq)]
    kv_blocks = [(k0, min(skv, k0 + bkv)) for k0 in range(0, skv, bkv)]

    def probs(q0, q1, k0, k1):
        sc = _block_scores(qh[:, :, q0:q1], kh[:, :, k0:k1], q0, k0, causal, scale)
        return torch.exp(sc - lse[:, :, q0:q1, None])

    def needed(q1, k0):
        return not (causal and k0 > q1 - 1)

    dq = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    for q0, q1 in q_blocks:  # dq: q blocks outside, key blocks inside (the forward's order)
        acc = torch.zeros((b, h, q1 - q0, d), dtype=torch.float32, device=q.device)
        for k0, k1 in kv_blocks:
            if not needed(q1, k0):
                continue
            p = probs(q0, q1, k0, k1)
            dp = torch.matmul(doh[:, :, q0:q1], vh[:, :, k0:k1].transpose(-1, -2)).float()
            ds = p * (dp - delta[:, :, q0:q1, None]) * scale
            acc += torch.matmul(ds.to(dt), kh[:, :, k0:k1]).float()
        dq[:, :, q0:q1] = acc

    dk = torch.empty((b, h, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0, k1 in kv_blocks:  # dk, dv: key blocks outside, q blocks inside
        dk_acc = torch.zeros((b, h, k1 - k0, d), dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0, q1 in q_blocks:
            if not needed(q1, k0):
                continue
            p = probs(q0, q1, k0, k1)
            dv_acc += torch.matmul(p.to(dt).transpose(-1, -2), doh[:, :, q0:q1]).float()
            dp = torch.matmul(doh[:, :, q0:q1], vh[:, :, k0:k1].transpose(-1, -2)).float()
            ds = p * (dp - delta[:, :, q0:q1, None]) * scale
            dk_acc += torch.matmul(ds.to(dt).transpose(-1, -2), qh[:, :, q0:q1]).float()
        dk[:, :, k0:k1] = dk_acc
        dv[:, :, k0:k1] = dv_acc
    # fold the repeated heads back onto their KV heads
    dk = dk.view(b, kvh, h // kvh, skv, d).sum(2).transpose(1, 2).to(k.dtype)
    dv = dv.view(b, kvh, h // kvh, skv, d).sum(2).transpose(1, 2).to(v.dtype)
    return dq.transpose(1, 2).to(dt), dk, dv


class _BlockedAttention(torch.autograd.Function):
    """Flash attention forward with a recomputing backward (JAX's
    ``_blocked_attention`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int, block_kv: int):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, block_q, block_kv = ctx.config
        dq, dk, dv = _blocked_backward(*ctx.saved_tensors, dout, causal=causal,
                                       block_q=block_q, block_kv=block_kv)
        return dq, dk, dv, None, None, None


def blocked_attention(q, k, v, causal: bool, block_q: int, block_kv: int) -> torch.Tensor:
    """Flash attention, differentiable.  q (B, S, H, D), k and v (B, S_kv, KV, D)
    (S_kv = S when causal).

    Without a gradient to take (inference mode, or no input that requires
    grad) it is ``ops.flash_attention`` itself, so the prefill's launches
    store no log-sum-exp.  Otherwise ``_BlockedAttention``, whose backward
    recomputes ``(block_q, block_kv)`` score blocks.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _BlockedAttention.apply(q, k, v, causal, block_q, block_kv)
    return flash_attention(q, k, v, causal=causal)


def attention(params, cfg, x: torch.Tensor, *, causal: bool = True,
              kv_override: tuple[torch.Tensor, torch.Tensor] | None = None, rope: bool = True,
              impl: str | None = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  x: (B, S, d_model) ->
    (B, S, d_model); the caller adds the residual.

    ``kv_override`` supplies k and v computed elsewhere, (B, S_kv, KV, hd)
    each (cross-attention, from ``compute_kv`` over the encoder's states),
    in place of x's.  ``rope=False`` rotates nothing.  The ``"auto"`` rule
    looks at the longer of S and S_kv, as JAX's does."""
    if kv_override is None:
        q, k, v = project_qkv(params, cfg, x, rope=rope)
    else:  # cross-attention: x's keys and values are not computed
        q = _head_proj(_region_input(params, cfg, x), params["wq"])
        if rope:
            cos, sin = rope_frequencies(cfg.head_dim, torch.arange(x.shape[1], device=x.device),
                                        cfg.rope_theta)
            q = apply_rope(q, cos, sin)
        k, v = kv_override
    k, v = tp.kv_for_heads(k, q.shape[2], cfg), tp.kv_for_heads(v, q.shape[2], cfg)
    impl = impl or cfg.attention_impl
    if impl == "auto":
        impl = "blocked" if max(q.shape[1], k.shape[1]) > 2048 else "dense"
    if impl == "dense":
        out = _dense_attention(q, k, v, causal=causal)
    elif impl == "blocked":
        out = blocked_attention(q, k, v, causal, cfg.attention_block_q, cfg.attention_block_kv)
    else:
        raise ValueError(f"attention impl {impl!r}: use 'auto', 'dense' or 'blocked'")
    return _exit(params, cfg, _out_proj(params, out))


def compute_kv(params, cfg, x: torch.Tensor, *, rope: bool = False):
    """K/V for cross-attention from encoder states, (B, S, KV, hd) each.
    ``rope`` is accepted and ignored, as in JAX.  On the rank's shard of
    the KV heads, ``x`` enters through ``copy_to``."""
    x = tp.copy_to(x) if _sharded(params["wk"], cfg.num_kv_heads) else x
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
    every_head: bool = False,
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
    dtype, as in JAX.  Returns ``(out (B, 1, d_model), cache_k, cache_v)``,
    or with ``lse_partial`` the normalised local output before the output
    projection (B, 1, H, hd), its float32 log-sum-exp (B, 1, H) and the
    caches: the partials the sharded decode (``distributed/decode.py``)
    combines across windows; with ``every_head``, on the rank's shard of
    the query heads, the heads are gathered over the model axis first.
    """
    b, hd = x.shape[0], cfg.head_dim
    pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device), (b,)).long()
    rp = pos if rope_pos is None else torch.broadcast_to(
        torch.as_tensor(rope_pos, device=x.device), (b,))
    q, k_new, v_new = project_qkv(params, cfg, x, positions=rp[:, None], rope=rope)
    if every_head and q.shape[2] != cfg.num_heads:
        q = tp.gather(q, 2)
    if update_cache:
        bidx = torch.arange(b, device=x.device)
        cache_k[bidx, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[bidx, pos] = v_new[:, 0].to(cache_v.dtype)
    h = q.shape[2]
    cache_kr = tp.kv_for_heads(cache_k, h, cfg)
    cache_vr = tp.kv_for_heads(cache_v, h, cfg)
    skv, kvh = cache_kr.shape[1], cache_kr.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, cache_kr.to(q.dtype)).float() * hd**-0.5
    valid = torch.arange(skv, device=x.device)[None, :] <= pos[:, None]  # (B, skv)
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    if lse_partial:
        # flash-decoding partials: the normalised local output and its lse, so
        # windows combine as sum_i exp(lse_i - M) out_i / sum_i exp(lse_i - M)
        m = scores.amax(dim=-1)
        p = torch.exp(scores - m[..., None])
        l = p.sum(dim=-1).clamp_min(1e-30)  # noqa: E741
        num = torch.einsum("bkgqt,btkd->bkgqd", p.to(q.dtype), cache_vr.to(q.dtype))
        out_local = num / l[..., None].to(num.dtype)
        lse = m + torch.log(l)
        out_local = out_local.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
        lse = lse.permute(0, 3, 1, 2).reshape(b, 1, h)
        return out_local, lse, cache_k, cache_v
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqt,btkd->bkgqd", probs, cache_vr.to(q.dtype))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    return _exit(params, cfg, _out_proj(params, out)), cache_k, cache_v


class Attention(nn.Module):
    """Holds ``wq``, ``wk``, ``wv`` and ``wo`` in the JAX package's head-structured shapes."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(params[name]))

    def params(self) -> dict[str, torch.Tensor]:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
