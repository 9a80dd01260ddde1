"""Mixture-of-Experts layer with one-hot dispatch and combine (port of
``repro.models.moe``).

The JAX package's GShard-style layer, grouped by sequence chunk: each group
of ``T`` tokens routes every token to its ``top_k`` experts, each expert
takes at most ``C = min(T, max(1, int(capacity_factor * top_k * T / E)))``
tokens of the group, in the order of the flattened ``(token, choice)``
slots, and the overflow is dropped.  Dispatch and combine are one-hot
matrix products over ``(G, T, E, C)``, as in JAX: the port keeps them so
that the drops, the slot order and the arithmetic are JAX's, case for case.

JAX builds the one-hot tensors with ``einsum("gtke,gtkc,gtk->gtec")``; the
port scatters the ``G·T·k`` ones (dispatch) and gates (combine) straight
into ``(G, T, E, C)`` instead, so no ``(G, T, k, E, C)`` intermediate is
formed (5.4 GB a layer in float32 at 16384 tokens).  A token's ``k``
choices are distinct experts, so no two slots land on one entry.  The
products are plain PyTorch matrix products, as JAX's are plain ``einsum``:
no Pallas kernel is involved.

Under a model axis (``distributed.tensor_parallel``) the experts are the
rank's shard (``E/tp`` of them, the rules' expert parallelism): the router
and the dispatch stay replicated, so capacities and drops are JAX's, case
for case; the rank builds the one-hot tensors of its experts' slots only,
runs its experts, combines over them, and the partial sums are summed over
the axis.  The gates enter the combine through ``copy_to``, since each
rank's combine reads only its experts' gates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.layers import normal

__all__ = ["MoE", "dispatch", "experts", "init_moe", "moe_layer", "router_load_balancing_loss"]


def init_moe(gen: torch.Generator, cfg, *, d_model: int | None = None) -> dict:
    """``router`` (d, E), ``w_gate``/``w_up`` (E, d, moe_d_ff), ``w_down`` (E, moe_d_ff, d)."""
    d = d_model or cfg.d_model
    e, ff = cfg.num_experts, cfg.moe_d_ff
    pd = cfg.param_dtype
    return {
        "router": normal(gen, (d, e), d**-0.5, pd),
        "w_gate": normal(gen, (e, d, ff), d**-0.5, pd),
        "w_up": normal(gen, (e, d, ff), d**-0.5, pd),
        "w_down": normal(gen, (e, ff, d), ff**-0.5, pd),
    }


def _top_k_gating(logits: torch.Tensor, k: int):
    """Normalised top-k gates and experts.  logits: (T, E)."""
    gates = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)  # (T, k), largest first
    top_vals = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, top_vals, top_idx


def _groups(cfg, s: int) -> int:
    """Tokens per dispatch group: ``moe_group_size``, or the whole sequence
    when that does not divide it."""
    tg = min(s, cfg.moe_group_size or s)
    return tg if s % tg == 0 else s


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """``F.one_hot(idx, e)`` as one comparison: ``F.one_hot``'s own ops
    differ by device (a range check read back on the CPU, a scatter on the
    card, a comparison on ``meta``), this one is the same everywhere, so
    the dry run counts the ops the card runs."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def dispatch(params, cfg, x: torch.Tensor):
    """Route ``x`` (G, T, d).  Returns ``(disp, comb, gates, top_idx)``:
    the one-hot dispatch (G, T, E, C) in x's dtype, the combine weights of
    the same shape (gates where kept, cast to x's dtype), and the float32
    router probabilities (G·T, E) and choices (G·T, k) for the aux loss.
    When ``params`` hold the rank's shard of the experts, ``disp`` and
    ``comb`` hold their ``E/tp`` experts' slots only."""
    g, tg, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = x @ params["router"].to(x.dtype)  # (G, T, E)
    gates, top_vals, top_idx = _top_k_gating(logits.reshape(g * tg, e), k)
    top_vals = top_vals.reshape(g, tg, k)
    idx = top_idx.reshape(g, tg, k)
    capacity = min(max(1, int(cfg.capacity_factor * k * tg / e)), tg)

    # Slot of each (token, choice) in its expert's group buffer: the number of
    # earlier (token, choice) pairs, in row-major order, routed to that expert.
    onehot = _one_hot(idx, e)  # (G, T, k, E)
    flat = onehot.reshape(g, tg * k, e)
    pos = ((flat.cumsum(1) - flat).reshape(g, tg, k, e) * onehot).sum(-1)  # (G, T, k)
    keep = pos < capacity  # overflow dropped (GShard)

    e_local = params["w_gate"].shape[0]
    if e_local != e:  # the rank's experts: their slots only
        idx = idx - tp.index() * e_local
        keep = keep & (idx >= 0) & (idx < e_local)
        idx = idx.clamp(0, e_local - 1)
        top_vals = tp.copy_to(top_vals)
    where = (torch.arange(g, device=x.device)[:, None, None].expand(g, tg, k),
             torch.arange(tg, device=x.device)[None, :, None].expand(g, tg, k),
             idx, pos.clamp(max=capacity - 1))
    shape = (g, tg, e_local, capacity)
    # accumulated: a dropped slot (clamped onto slot C - 1, or onto another
    # rank's expert) adds 0 where a kept one wrote its value
    disp = x.new_zeros(shape).index_put(where, keep.to(x.dtype), accumulate=True)
    comb = torch.zeros(shape, dtype=torch.float32, device=x.device).index_put(
        where, top_vals * keep, accumulate=True).to(x.dtype)
    return disp, comb, gates, top_idx


def experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their buffers: (E, N, d) -> (E, N, d)."""
    dt = expert_in.dtype
    gate = F.silu(torch.bmm(expert_in, params["w_gate"].to(dt)))
    up = torch.bmm(expert_in, params["w_up"].to(dt))
    return torch.bmm(gate * up, params["w_down"].to(dt))


def moe_layer(params, cfg, x: torch.Tensor, *, return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d); with ``return_aux`` also the router's
    load-balancing loss.  Groups of ``moe_group_size`` tokens (JAX's rule)."""
    b, s, d = x.shape
    e = params["w_gate"].shape[0]  # the rank's experts under a model axis
    tg = _groups(cfg, s)
    g = b * (s // tg)
    xg = x.reshape(g, tg, d)
    disp, comb, gates, top_idx = dispatch(params, cfg, xg)
    sharded = e != cfg.num_experts
    c = disp.shape[-1]
    # einsum("gtec,gtd->gecd"), expert-major for the experts' batched products
    xin = tp.copy_to(xg) if sharded else xg
    expert_in = (disp.reshape(g, tg, e * c).transpose(1, 2) @ xin).view(g, e, c, d)
    out = experts(params, expert_in.transpose(0, 1).reshape(e, g * c, d))
    out = out.view(e, g, c, d).transpose(0, 1).reshape(g, e * c, d)
    y = (comb.reshape(g, tg, e * c) @ out).reshape(b, s, d)  # einsum("gtec,gecd->gtd")
    if sharded:
        y = tp.reduce_from(y)
    if return_aux:  # the replicated gates: computed once, not summed
        return y, router_load_balancing_loss(gates, top_idx, cfg.num_experts)
    return y


def router_load_balancing_loss(gates: torch.Tensor, top_idx: torch.Tensor, e: int):
    """Switch-style auxiliary loss ``E * sum_e f_e p_e``.  gates (T, E), top_idx (T, k)."""
    me = _one_hot(top_idx[:, 0], e).float().mean(0)  # fraction routed
    pe = gates.float().mean(0)
    return e * torch.sum(me * pe)


class MoE(nn.Module):
    """Holds ``router``, ``w_gate``, ``w_up`` and ``w_down`` in the JAX package's shapes."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(params[name]))

    def params(self) -> dict[str, torch.Tensor]:
        return {"router": self.router, "w_gate": self.w_gate, "w_up": self.w_up,
                "w_down": self.w_down}
