"""Context-parallel decode: the KV cache sharded over SEQUENCE, combined by
the log-sum-exp (port of ``repro.distributed.decode``).

When kv_heads < TP the cache cannot shard on heads; sharding its sequence
axis instead gives flash-decoding semantics: each rank attends over its
window and returns a log-sum-exp beside its normalised output, and the
windows combine exactly,

    out = sum_i exp(lse_i - M) out_i / sum_i exp(lse_i - M),   M = max_i lse_i,

by one ``all_reduce`` MAX of the (B, H) lse and one SUM of the weighted
outputs and weights, instead of gathering the (B, S, KV, D) cache.  A
window wholly after ``pos`` masks every score to ``NEG_INF``; its lse is
then about ``NEG_INF`` and its weight exactly 0.

JAX writes it with ``shard_map``; the port runs ``sharded_decode_attention``
on every rank of the group over ``seq_axis``, each rank passing its window
of the cache (a local tensor, or a ``DTensor`` sharded on the sequence).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import axis_group, axis_index
from repro_torch.models.attention import _out_proj, decode_attention, project_qkv

__all__ = ["sharded_decode_attention", "window_decode_attention"]


def sharded_decode_attention(params, cfg, mesh, x, cache_k, cache_v, pos, *,
                             seq_axis: str = "model"):
    """``decode_attention`` with the cache's sequence sharded over ``seq_axis``.

    ``x`` (B, 1, d) and ``pos`` (B,) global positions are the same on every
    rank; ``cache_k`` / ``cache_v`` are this rank's window (B, S / n, KV, hd)
    of the global cache, or ``DTensor``s of the global cache sharded on
    dimension 1.  Only the rank whose window holds ``pos[b]`` writes row
    b's new K and V (in place), rotated at the global position.  Returns
    ``(out (B, 1, d), cache_k, cache_v)``, the output on every rank."""
    from torch.distributed.tensor import DTensor

    k_l = cache_k.to_local() if isinstance(cache_k, DTensor) else cache_k
    v_l = cache_v.to_local() if isinstance(cache_v, DTensor) else cache_v
    group = axis_group(mesh, seq_axis)

    def reduce(t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=group)
        return t

    out = _windows(params, cfg, x, k_l, v_l, pos, axis_index(mesh, seq_axis), reduce)
    return out, cache_k, cache_v


def window_decode_attention(params, cfg, x, k_l, v_l, pos, *, update_cache: bool = True,
                            rope: bool = True):
    """The sharded decode's attention over a cache whose sequence the rules
    shard on the model axis (its KV heads do not divide it), inside the
    rank's ``tensor_parallel.scope``: the rank's window ``k_l`` / ``v_l``
    (B, S / tp, KV, hd), the windows combined over the axis.  Where the
    rank holds a shard of the query heads, the heads are gathered before
    the attention (every window needs every head) and the output
    projection takes the rank's heads, summed over the axis.  Without
    ``update_cache`` nothing is written and ``pos`` is the position every
    key up to which is read (the cross cache's).  Returns ``(out, k_l, v_l)``."""
    out = _windows(params, cfg, x, k_l, v_l, pos, tp.index(),
                   lambda t, op: tp.all_reduce(t, op), update_cache=update_cache, rope=rope)
    return out, k_l, v_l


def _windows(params, cfg, x, k_l, v_l, pos, window: int, reduce, *, update_cache: bool = True,
             rope: bool = True):
    """The attention output (B, 1, d) over the windows, this rank's the
    ``window``-th; ``reduce(t, op)`` reduces over the windows' ranks."""
    s_local = k_l.shape[1]
    offset = window * s_local
    b = x.shape[0]
    pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device), (b,)).long()
    in_shard = (pos >= offset) & (pos < offset + s_local)
    local_pos = torch.clamp(pos - offset, 0, s_local - 1)

    if update_cache:
        _, k_new, v_new = project_qkv(params, cfg, x, positions=pos[:, None], rope=rope)
        bidx = torch.arange(b, device=x.device)
        keep = in_shard[:, None, None]
        k_l[bidx, local_pos] = torch.where(keep, k_new[:, 0].to(k_l.dtype), k_l[bidx, local_pos])
        v_l[bidx, local_pos] = torch.where(keep, v_new[:, 0].to(v_l.dtype), v_l[bidx, local_pos])
    # this window's partials: masked at the LOCAL position, the query rotated
    # at the GLOBAL one; a window wholly after pos sees no key (-1)
    after = torch.where(pos >= offset + s_local, s_local - 1, -1)
    mask_pos = torch.where(in_shard, local_pos, after)
    num, lse, _, _ = decode_attention(params, cfg, x, k_l, v_l, mask_pos, update_cache=False,
                                      lse_partial=True, rope_pos=pos, rope=rope,
                                      every_head=True)
    lse_max = reduce(lse.clone(), dist.ReduceOp.MAX)
    w = torch.exp(lse - lse_max)
    packed = reduce(torch.cat([(num.float() * w[..., None]).reshape(-1), w.reshape(-1)]),
                    dist.ReduceOp.SUM)
    num_g = packed[:num.numel()].view(num.shape)
    den_g = packed[num.numel():].view(w.shape)
    out = num_g / torch.clamp(den_g, min=1e-30)[..., None]
    heads = params["wo"].shape[0]
    if heads != cfg.num_heads:  # the rank's heads into its shard of wo, summed
        lo = tp.index() * heads
        return tp.reduce_from(_out_proj(params, out[:, :, lo:lo + heads].to(x.dtype)))
    return _out_proj(params, out.to(x.dtype))
