"""The sharded prefill and decode: the port's counterparts of JAX's
``jax.jit(make_prefill_fn(cfg), in_shardings=(p_shard, b_shard))`` and of
its decode jit, ``in_shardings=(p_shard, b_shard, s_shard)``
(``repro.launch.dryrun``'s serving cells).

As in the sharded train step (``distributed.sharded_step``), pjit's
partitioning is written out on every rank of a mesh whose weights and decode
state are ``DTensor``s (``sharding.shard_state``):

* **Placement.**  The bf16 weights are placed by ``param_shardings`` with
  JAX's serving rule: FSDP over the data axes only when a bf16
  tensor-parallel shard passes ``SERVE_FSDP_BYTES`` (``serve_param_shardings``),
  so most configs keep their weights whole on the data axes.  The decode
  state is placed by ``decode_state_shardings``: the batch over the data
  axes, a cache's KV heads over ``model`` where they divide it, else its
  sequence; a recurrent state's heads (or an RWKV state's key rows).
* **The rank's work.**  The rank gathers its weights over the data axes
  (where FSDP shards them) and runs the unsharded model code on its data
  shard's rows under its ``tensor_parallel.scope``: every layer computes
  its model-axis shard, the rank's query heads meet its KV heads of the
  cache, a cache sharded on its sequence is attended window by window
  (``distributed.decode.window_decode_attention``, the heads gathered
  first: each window needs every head, where GSPMD may choose otherwise),
  and the recurrent layers update the rank's heads of their state.
* **Logits** come back as the rank's vocabulary shard of its rows'
  logits, ``(rows, V / tp)``; ``gather_logits`` gives them whole,
  ``(B, V)``, on every rank.

``rank_prefill`` and ``rank_decode`` are one rank's bodies, which the dry run
(``launch.dryrun``) runs on ``meta`` with a recording model axis: the calls
it records are the rank's collectives (``launch.dryrun.rank_collectives``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharded_step import (
    _local,
    data_group_axes,
    tp_axes,
)
from repro_torch.distributed.sharding import (
    collective_label,
    gather_tensors,
    param_shardings,
    placements,
    spec_leaves,
)
from repro_torch.launch.mesh import MODEL_AXIS, axis_group, axis_index, axis_sizes
from repro_torch.models.model_zoo import on_device
from repro_torch.models.transformer import Transformer, decode_step, forward_params
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CACHES", "SERVE_FSDP_BYTES", "gather_logits", "rank_decode", "rank_prefill",
           "serve_param_shardings", "sharded_decode", "sharded_prefill", "windowed_caches"]

SERVE_FSDP_BYTES = 12 * 2**30  # JAX's serving threshold (src/repro/launch/dryrun.py:94)
CACHES = ("k", "v", "cross_k", "cross_v", "shared_k", "shared_v")


def serve_param_shardings(params, cfg, mesh):
    """JAX's serving placement of bf16 weights: ``param_shardings`` with FSDP
    over the data axes only when a bf16 shard of the model axis passes
    ``SERVE_FSDP_BYTES``."""
    fsdp = cfg.param_count() * 2 / axis_sizes(mesh).shape[MODEL_AXIS] > SERVE_FSDP_BYTES
    return param_shardings(params, cfg, mesh, fsdp=fsdp)


def windowed_caches(state_specs) -> frozenset:
    """The caches of a decode state whose sequence (dimension 2 of the
    stacked (L, B, S, KV, hd) cache) the specs shard on ``model``."""
    return frozenset(key for key in CACHES if key in state_specs
                     and state_specs[key][2] == MODEL_AXIS)


def _rows(batch: dict, data_idx: int, data_size: int) -> dict:
    """The data shard's rows of a global batch."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // data_size
        out[k] = v[data_idx * per:(data_idx + 1) * per]
    return out


def rank_prefill(cfg, tree: dict, batch: dict) -> torch.Tensor:
    """One rank's prefill, inside its ``tensor_parallel.scope``: ``tree`` the
    model shards of the weights, ``batch`` its rows.  The last position's
    logits of its vocabulary shard, ``(rows, V / tp)``."""
    with torch.inference_mode():
        return forward_params(tree, cfg, batch)[:, -1].clone()


def rank_decode(cfg, tree: dict, tokens: torch.Tensor, state: dict):
    """One rank's decode step, inside its ``tensor_parallel.scope`` (whose
    ``windows`` name the caches held as sequence windows): ``tree`` the
    model shards of the weights, ``tokens`` and ``state`` its shards,
    updated in place.  Returns the logits of its vocabulary shard,
    ``(rows, V / tp)``, float32."""
    with torch.inference_mode():
        logits, _ = decode_step(Transformer(cfg, tree), cfg, tokens, state)
    return logits


class _Rank:
    """What a serving rank reads of its mesh: its data group and model axis."""

    def __init__(self, mesh, param_specs, data):
        self.mesh = mesh
        self.specs = spec_leaves(param_specs)
        self.data = tuple(data)
        sizes = axis_sizes(mesh)
        self.d_size = math.prod(sizes.shape[a] for a in self.data)
        self.d_idx = axis_index(mesh, self.data) if self.data else 0
        self.model = tp_axes(mesh, self.data)
        self.axis = tp.model_axis(mesh) if self.model else None

    def weights(self, params) -> dict:
        """The model shards of ``params`` (a tree of ``DTensor``s), gathered
        over the data axes where FSDP shards them."""
        leaves = tree_leaves(params)
        for leaf, spec in zip(leaves, self.specs):
            if list(getattr(leaf, "placements", ())) != placements(spec, self.mesh):
                raise ValueError(f"a weight is placed {getattr(leaf, 'placements', None)}, its "
                                 f"spec {spec} says {placements(spec, self.mesh)}: "
                                 "shard_state it with these specs")
        it = iter(gather_tensors(leaves, axes=tuple(a for a in self.mesh.mesh_dim_names
                                                    if a not in self.model)))
        return tree_map(lambda _: next(it), params)


def sharded_prefill(cfg, mesh, param_specs, batch_specs):
    """``prefill(params, batch) -> logits`` on every rank of ``mesh``:
    ``params`` the bf16 weights placed by ``param_specs`` (``DTensor``s),
    ``batch`` the global batch (numpy or tensors), the same on every rank.
    Returns the rank's rows' next-token logits on its vocabulary shard,
    ``(B / data, V / tp)``; ``gather_logits`` gives them whole."""
    rank = _Rank(mesh, param_specs, data_group_axes(batch_specs))

    def prefill(params, batch: dict) -> torch.Tensor:
        tree = rank.weights(params)
        dev = tree_leaves(tree)[0].device
        rows = _rows(on_device(batch, dev), rank.d_idx, rank.d_size)
        with tp.scope(rank.axis):
            return rank_prefill(cfg, tree, rows)

    return prefill


def sharded_decode(cfg, mesh, param_specs, token_spec, state_specs):
    """``serve_step(params, tokens, state) -> (logits, state)`` on every rank
    of ``mesh``: ``params`` as ``sharded_prefill`` takes them, ``tokens`` the
    global (B,) ids, ``state`` the decode state placed by ``state_specs``
    (``decode_state_shardings``; ``DTensor``s), whose shards are updated in
    place.  Returns the rank's rows' logits on its vocabulary shard."""
    rank = _Rank(mesh, param_specs, data_group_axes({"tokens": token_spec}))
    windows = windowed_caches(state_specs)
    axis = dataclasses.replace(rank.axis, windows=windows) if rank.axis else None

    def serve_step(params, tokens, state: dict):
        tree = rank.weights(params)
        dev = tree_leaves(tree)[0].device
        toks = _rows({"t": on_device({"t": tokens}, dev)["t"]}, rank.d_idx, rank.d_size)["t"]
        local = {k: _local(v) for k, v in state.items()}
        with tp.scope(axis):
            logits = rank_decode(cfg, tree, toks, local)
        return logits, state

    return serve_step


def gather_logits(logits: torch.Tensor, mesh, data_axes) -> torch.Tensor:
    """The whole ``(B, V)`` logits on every rank from each rank's
    ``(B / data, V / tp)`` shard: one ``all_gather`` over the mesh."""
    names = tuple(mesh.mesh_dim_names)
    group = axis_group(mesh, names)
    n = dist.get_world_size(group)
    parts = [torch.empty_like(logits) for _ in range(n)]
    with torch.profiler.record_function(collective_label("all-gather", names, n)):
        dist.all_gather(parts, logits.contiguous(), group=group)
    sizes = axis_sizes(mesh)
    d_size = math.prod(sizes.shape[a] for a in data_axes)
    tp_size = sizes.shape.get(MODEL_AXIS, 1) if MODEL_AXIS not in data_axes else 1
    rows, cols = logits.shape[0], logits.shape[1]
    out = logits.new_empty((rows * d_size, cols * tp_size))
    for g, part in enumerate(parts):
        coord = tuple(int(c) for c in (mesh.mesh == dist.get_global_rank(group, g)).nonzero()[0])
        d_idx = 0
        for a in data_axes:
            k = names.index(a)
            d_idx = d_idx * sizes.sizes[k] + coord[k]
        m_idx = coord[names.index(MODEL_AXIS)] if tp_size > 1 else 0
        out[d_idx * rows:(d_idx + 1) * rows, m_idx * cols:(m_idx + 1) * cols] = part
    return out
