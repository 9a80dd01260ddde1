"""The sharded train step: the port's counterpart of
``jax.jit(make_train_step(...), in_shardings=(ssh, bsh), out_shardings=(ssh, None))``.

It has no module of its own in the JAX package: there, pjit (JAX's library)
partitions the unsharded step by the shardings of its inputs.  The port
writes the partitioned step out, on every rank of a mesh whose state
leaves are ``DTensor``s (``sharding.shard_state``), and its result is the
unsharded ``model_zoo.make_train_step``'s up to the order of summation:

* **Gather, then compute on the data shard.**  Each rank casts its weight
  shards (tensors of 2 or more dimensions to ``cfg.dtype``, as the
  unsharded step's default does before its microbatches) and gathers the
  full weights once a step (``sharding.gather_tensors``), as FSDP does.
  Microbatch i is the global batch's rows ``[i·B/n, (i+1)·B/n)``, JAX's
  reshape to (n, B/n); the rank takes its data group's slice of them.  The
  loss, the microbatch loop and its float32 means are the unsharded step's
  (``model_zoo.microbatch_grads``), given the rank's rows and loss scale.
* **The loss is the global one.**  ``cross_entropy_loss`` divides by the
  count of valid labels; each rank's microbatch loss is scaled by its own
  count over the microbatch's global count, which every rank reads from the
  global batch before the forward, so labels of -100 give the same step.
* **Sum over the data axes only.**  The float32 gradients of every
  microbatch and the loss are summed in one ``all_reduce`` over the data
  group: the axes that shard the batch's first dimension under
  ``batch_shardings`` (the data axes under "2d", every axis under
  "dp_only").  Ranks that differ only on ``model`` compute the same shard
  and are not summed; the model axis shards storage only (no
  tensor-parallel compute yet).
* **Clip by the full norm, update the local shard.**  Every rank holds the
  summed gradients whole, so the optimiser's compressor, when set, acts on
  them as in the unsharded step, and global-norm clipping reads the same
  norm everywhere.  Each rank then updates only its shards of the
  parameters, ``m`` and ``v``, in place: the state returned has the
  shardings it was given.

A non-finite loss raises ``FloatingPointError`` on every rank, after the
sum and before any update.  Moments sharded otherwise than their parameter
(``train_state_shardings(zero1=True)``) are refused: this step updates a
parameter's shard with the moments of the same elements.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (
    dtensor_slices,
    gather_tensors,
    placements,
    spec_leaves,
)
from repro_torch.launch.mesh import axis_group, axis_index, axis_sizes
from repro_torch.models.model_zoo import (
    check_finite,
    compute_weight,
    make_loss_fn,
    microbatch_grads,
    on_device,
    sgd_update,
)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["data_group_axes", "sharded_train_step"]


def data_group_axes(batch_shardings) -> tuple[str, ...]:
    """The mesh axes that shard the batch's first dimension (the same for
    every batch leaf)."""
    firsts = {spec[0] if len(spec) else None for spec in spec_leaves(batch_shardings)}
    if len(firsts) != 1:
        raise ValueError(f"the batch's leaves shard their first dimension differently: {firsts}")
    (first,) = firsts
    return (first,) if isinstance(first, str) else tuple(first or ())


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def sharded_train_step(cfg, optimizer, mesh, state_shardings, batch_shardings, *,
                       num_microbatches: int = 1):
    """``(state, batch) -> (state, metrics)`` on every rank of ``mesh``.

    ``state`` is ``sharding.shard_state(init_adamw_state(model),
    state_shardings, mesh)`` (or its SGD form ``{"params", "lr"}`` with
    ``optimizer=None``), its leaves ``DTensor``s placed by
    ``state_shardings``; ``batch`` is the global batch (numpy or tensors),
    the same on every rank.  Metrics are the unsharded step's, the same on
    every rank."""
    from torch.distributed.tensor import DTensor

    n = num_microbatches
    if n < 1:
        raise ValueError(f"num_microbatches={n} must be >= 1")
    loss_fn = make_loss_fn(cfg)
    data = data_group_axes(batch_shardings)
    sizes = axis_sizes(mesh)
    d_size = math.prod(sizes.shape[a] for a in data)
    d_idx = axis_index(mesh, data) if data else 0
    group = axis_group(mesh, data) if d_size > 1 else None
    coord = tuple(mesh.get_coordinate())
    checked = []

    def check(state: dict) -> None:
        """Each leaf is placed as its spec says; moments as their parameter."""
        for key in ("params", "m", "v"):
            if key not in state:
                continue
            for leaf, spec in zip(tree_leaves(state[key]), spec_leaves(state_shardings[key])):
                if not isinstance(leaf, DTensor):
                    raise ValueError(f"state[{key!r}] holds a full tensor: shard_state it first")
                if list(leaf.placements) != placements(spec, mesh):
                    raise ValueError(f"state[{key!r}]: a leaf is placed {leaf.placements}, its "
                                     f"spec {spec} says {placements(spec, mesh)}")
            if key != "params" and spec_leaves(state_shardings[key]) != spec_leaves(
                    state_shardings["params"]):
                raise ValueError(f"state[{key!r}] is sharded otherwise than the parameters "
                                 "(zero1): the sharded step updates a parameter's shard with "
                                 "the moments of the same elements")
        checked.append(True)

    def gather_weights(shards: list) -> list[torch.Tensor]:
        cast = [DTensor.from_local(compute_weight(dt.to_local(), cfg), dt.device_mesh,
                                   dt.placements, run_check=False, shape=dt.shape,
                                   stride=dt.stride()) for dt in shards]
        return [w.detach().requires_grad_() for w in gather_tensors(cast)]

    def train_step(state: dict, batch: dict):
        if not checked:
            check(state)
        ptree = state["params"]
        shards = tree_leaves(ptree)
        weights = gather_weights(shards)
        it = iter(weights)
        tree = tree_map(lambda _: next(it), ptree)
        dev = weights[0].device
        batch = on_device(batch, dev)
        rows = next(iter(batch.values())).shape[0]
        if rows % (n * d_size):
            raise ValueError(f"a batch of {rows} rows does not split into {n} microbatches over "
                             f"a data group of {d_size}")
        per_ub, per_rank = rows // n, rows // (n * d_size)

        def select(i):
            """The rank's rows of microbatch i, its loss scaled by its share of
            the microbatch's valid labels."""
            start = i * per_ub + d_idx * per_rank
            mb = {k: v[start:start + per_rank] for k, v in batch.items()}
            valid = (batch["labels"][i * per_ub:(i + 1) * per_ub] >= 0).sum().clamp_min(1)
            return mb, (mb["labels"] >= 0).sum() / valid

        # the gradients' and the loss's means, summed over the data group in one buffer
        flat = torch.zeros(sum(w.numel() for w in weights) + 1, dtype=torch.float32, device=dev)
        acc, at = [], 0
        for w in weights:
            acc.append(flat[at:at + w.numel()].view(w.shape))
            at += w.numel()
        loss, _ = microbatch_grads(loss_fn, tree, batch, n, select=select, into=acc)
        flat[-1] = loss
        del tree, weights
        if group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        loss = flat[-1].clone()
        check_finite(loss)
        it = iter(acc)
        grads = tree_map(lambda _: next(it), ptree)

        if optimizer is None:
            sgd_update(state, [dt.to_local() for dt in shards],
                       [g[dtensor_slices(dt, coord)] for dt, g in zip(shards, acc)])
            return state, {"loss": loss}
        if optimizer.compressor is not None:
            grads, state = _compress(optimizer.compressor, grads, state)
        gnorm = global_norm(grads)
        local_grads = tree_map(lambda g, dt: g[dtensor_slices(dt, coord)], grads, ptree)
        local_state = {"params": tree_map(_local, ptree), "m": tree_map(_local, state["m"]),
                       "v": tree_map(_local, state["v"]), "step": _local(state["step"]),
                       "lr": _local(state["lr"])}
        _, metrics = optimizer.apply_gradients(local_state, local_grads, grad_norm=gnorm)
        return state, dict(metrics, loss=loss)

    return train_step


def _compress(compressor, grads, state: dict):
    """The compressor over the summed gradients, whole; its buffer must be
    replicated (``train_state_shardings`` replicates it), or is made here."""
    from torch.distributed.tensor import DTensor, Replicate

    key = compressor.ef_key
    view = {"params": grads}
    if key in state:
        for leaf in tree_leaves(state[key]):
            if isinstance(leaf, DTensor) and any(not isinstance(p, Replicate)
                                                 for p in leaf.placements):
                raise ValueError(f"state[{key!r}] must be replicated: the compressor reads the "
                                 "whole summed gradient")
        view[key] = tree_map(_local, state[key])
    grads, view = compressor.compress_tree(grads, view)
    if key not in state:
        state[key] = view[key]
    return grads, state
