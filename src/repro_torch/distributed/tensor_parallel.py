"""Compute over the model axis: the port's counterpart of GSPMD's
partitioning of a layer whose weights the rules shard on ``model``, and of
the hints that pin a tensor's head axis there (JAX's ``shard_hint`` /
``head_shard`` in ``repro.models.layers``, ``_ubatch_constraint`` in
``repro.models.model_zoo``).

Under layout "2d" each rank of a mesh holds the model-axis shard of every
weight the rules (``distributed.sharding``) shard on ``model``, and computes
with it: the layer's shard of heads, hidden width, experts or vocabulary.
A weight the rules leave replicated on ``model`` is computed whole on every
model rank, as GSPMD does.  The model code reads the rank's place on the
axis from ``scope(axis)``, a module-level setting as the layout is (JAX's
hints could not take it as an argument either); outside a scope, or on an
axis of size 1, every function here is the identity and the unsharded path
is unchanged, bit for bit.

Megatron's operators, as ``torch.autograd.Function``s:

* ``copy_to``: identity forward, ``all_reduce`` backward; at the entry of a
  region that computes on the rank's shard (its input's gradient is partial
  on every rank);
* ``reduce_from``: ``all_reduce`` forward, identity backward; at its exit
  (the rank's partial sum, e.g. an output projection over its heads);
* ``gather``: ``all_gather`` along a dimension forward, the rank's slice
  backward (the recurrent scans' heads after the scan, a weight whose
  ``d`` the rules shard);
* ``split``: the rank's slice forward, ``all_gather`` backward (the scan's
  inputs, computed whole from replicated weights, cut to the rank's heads).

Each collective runs under ``sharding.collective_label``, so that
``perf.coll_breakdown`` reads it back from a trace.  On ``meta`` (the dry
run) no collective runs: each call appends its record (``{"kind",
"result_bytes", "axes", "group"}``, ``perf.coll_stats``'s) to the axis's
``records`` and returns a tensor of the result's shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import collective_label
from repro_torch.launch.mesh import MODEL_AXIS, axis_group, axis_index, axis_sizes

__all__ = ["ModelAxis", "all_reduce", "copy_to", "current", "gather", "index", "kv_for_heads",
           "local_range", "mask_padded_vocab", "model_axis", "reduce_from", "scope", "size",
           "split", "splits", "vocab_cross_entropy", "vocab_embed", "vocab_head", "windowed"]


@dataclasses.dataclass
class ModelAxis:
    """A rank's place on the model axis: its ``size``, the rank's ``index``,
    the process ``group`` over it (``None`` on ``meta``, where ``records``
    collects the calls instead)."""

    size: int
    index: int = 0
    group: Any = None
    records: list | None = None
    windows: frozenset = frozenset()  # decode caches whose sequence the axis shards


_AXIS: ModelAxis | None = None


def model_axis(mesh, *, coordinate=None, records: list | None = None) -> ModelAxis:
    """The model axis of ``mesh``: a ``DeviceMesh`` (its group, this rank's
    index), or a ``MeshShape`` with the rank's ``coordinate`` (the dry run;
    the calls go to ``records``)."""
    sizes = axis_sizes(mesh)
    n = sizes.shape.get(MODEL_AXIS, 1)
    if coordinate is not None or not hasattr(mesh, "get_coordinate"):
        coord = tuple(coordinate or (0,) * len(sizes.sizes))
        idx = coord[sizes.axis_names.index(MODEL_AXIS)] if MODEL_AXIS in sizes.axis_names else 0
        return ModelAxis(n, idx, None, records=[] if records is None else records)
    group = axis_group(mesh, MODEL_AXIS) if n > 1 else None
    return ModelAxis(n, axis_index(mesh, MODEL_AXIS) if n > 1 else 0, group)


@contextlib.contextmanager
def scope(axis: ModelAxis | None):
    """Compute under ``axis`` (``None``: unsharded) inside the block."""
    global _AXIS
    prev = _AXIS
    _AXIS = axis
    try:
        yield axis
    finally:
        _AXIS = prev


def current() -> ModelAxis | None:
    """The scope's axis when it splits anything (size > 1), else ``None``."""
    return _AXIS if _AXIS is not None and _AXIS.size > 1 else None


def size() -> int:
    ax = current()
    return ax.size if ax else 1


def index() -> int:
    ax = current()
    return ax.index if ax else 0


def splits(n: int) -> bool:
    """Whether the rules shard a dimension of ``n`` on the model axis (JAX's
    ``_model_ok``): the axis is larger than 1 and divides it."""
    return size() > 1 and n % size() == 0


def local_range(n: int) -> tuple[int, int]:
    """The rank's ``[start, stop)`` of a dimension of ``n`` split on the axis."""
    step = n // size()
    return index() * step, (index() + 1) * step


# -- the collectives ---------------------------------------------------------------


def _record(ax: ModelAxis, kind: str, t: torch.Tensor) -> None:
    if ax.records is not None:
        ax.records.append({"kind": kind, "result_bytes": float(t.numel() * t.element_size()),
                           "axes": (MODEL_AXIS,), "group": ax.size})


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    ax = current()
    out = x.contiguous().clone()
    if ax.group is None:
        _record(ax, "all-reduce", out)
        return out
    with torch.profiler.record_function(collective_label("all-reduce", (MODEL_AXIS,), ax.size)):
        dist.all_reduce(out, op=op, group=ax.group)
    return out


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    ax = current()
    x = x.contiguous()
    if ax.group is None:
        shape = list(x.shape)
        shape[dim] *= ax.size
        out = x.new_empty(shape)
        _record(ax, "all-gather", out)
        return out
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    with torch.profiler.record_function(collective_label("all-gather", (MODEL_AXIS,), ax.size)):
        dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    start, stop = local_range(x.shape[dim])
    return x.narrow(dim, start, stop - start).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _slice(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim), None


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced by ``op`` over the model axis, a new tensor, outside the
    graph (the decode's window combine)."""
    return _all_reduce(x, op) if current() else x


def windowed(key: str) -> bool:
    """Whether the rank holds a window of the sequence of the decode state's
    cache ``key`` (the rules shard its sequence on the axis)."""
    ax = current()
    return ax is not None and key in ax.windows


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """Identity; its backward sums the gradient over the model axis."""
    return _CopyTo.apply(x) if current() else x


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model axis; its backward is the identity."""
    return _ReduceFrom.apply(x) if current() else x


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' pieces of ``x`` joined along ``dim``; its backward
    takes the rank's slice."""
    return _Gather.apply(x, dim) if current() else x


def split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The rank's slice of ``x`` along ``dim``; its backward gathers."""
    return _Split.apply(x, dim) if current() else x


# -- attention's heads -----------------------------------------------------------


def kv_for_heads(k: torch.Tensor, heads: int, cfg) -> torch.Tensor:
    """The KV heads that the rank's ``heads`` query heads read, from ``k``
    (B, S, KV, D).  When the rules shard the query heads but not the KV
    heads (KV does not divide the axis), ``k`` holds all KV heads, whole:
    query head ``i`` of ``[r·H/tp, (r+1)·H/tp)`` reads KV head ``i // (H/KV)``.
    The result's heads divide ``heads``; its backward sums the KV heads'
    gradients over the model axis (every rank read them whole)."""
    kvh = k.shape[2]
    if heads == cfg.num_heads or kvh != cfg.num_kv_heads:
        return k  # unsharded, or both sharded (the rank's KV heads are its queries')
    g = cfg.num_heads // cfg.num_kv_heads
    start = index() * heads
    k = copy_to(k)
    if heads % g == 0 or g % heads == 0:  # whole groups, or part of one
        first, last = start // g, (start + heads - 1) // g
        return k[:, :, first:last + 1]
    idx = torch.arange(start, start + heads, device=k.device) // g
    return k.index_select(2, idx)


# -- the vocabulary ---------------------------------------------------------------


def vocab_embed(emb: torch.Tensor, ids: torch.Tensor, cfg) -> torch.Tensor:
    """``emb[ids]`` from the rank's shard of the embedding (padded_vocab, d):
    on a vocabulary shard, the ids outside it masked, looked up and summed
    over the axis; on a shard of ``d`` (the rules' fallback), the columns
    gathered."""
    if emb.shape[0] != cfg.padded_vocab:
        start = index() * emb.shape[0]
        local = ids - start
        inside = (local >= 0) & (local < emb.shape[0])
        rows = emb[torch.where(inside, local, 0)]
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from(rows)
    if emb.shape[1] != cfg.d_model:
        return gather(emb[ids], -1)
    return emb[ids]


def vocab_head(x: torch.Tensor, head: torch.Tensor, cfg) -> torch.Tensor:
    """``x @ head.T``: the logits of the rank's vocabulary shard (the head's
    rows), or, on a shard of ``d``, the head gathered and the logits whole."""
    if head.shape[0] != cfg.padded_vocab:
        return copy_to(x) @ head.to(x.dtype).T
    if head.shape[1] != cfg.d_model:
        head = gather(head, -1)
    return x @ head.to(x.dtype).T


def mask_padded_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    """Subtract 1e9 from the padded vocabulary's logits, in place, at global
    vocabulary indices (the rank's shard starts at ``index() * V_local``)."""
    v_local = logits.shape[-1]
    start = index() * v_local if v_local != cfg.padded_vocab else 0
    first = min(max(cfg.vocab_size - start, 0), v_local)
    logits[..., first:] -= 1e9
    return logits


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                        z_loss: float = 1e-4) -> torch.Tensor:
    """``cross_entropy_loss`` over vocabulary-sharded logits (B, S, V/tp), in
    float32: the max (one ``all_reduce`` MAX, outside the graph), then the sum
    of exponentials and the picked logit (one ``all_reduce`` SUM of both) over
    the axis.  Labels of -100 are ignored; the loss is the same on every
    model rank."""
    logits = logits.float()
    v_local = logits.shape[-1]
    start = index() * v_local
    m = _all_reduce(logits.detach().amax(-1), dist.ReduceOp.MAX)
    valid = labels >= 0
    local = labels - start
    inside = valid & (local >= 0) & (local < v_local)
    picked = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = torch.where(inside, picked, 0.0)
    sumexp = torch.exp(logits - m[..., None]).sum(-1)
    sumexp, picked = reduce_from(torch.stack([sumexp, picked])).unbind(0)
    lse = m + torch.log(sumexp)
    total = torch.where(valid, lse - picked + z_loss * lse.square(), 0.0).sum()
    return total / valid.sum().clamp_min(1)
