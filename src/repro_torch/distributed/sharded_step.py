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

**Its collectives in closed form.** ``gather_collectives`` and
``step_collectives`` give the calls a step makes, as records for
``perf.coll_stats`` (``{"kind", "result_bytes", "group", "axes"}``), from
the shardings and a mesh's axis sizes alone (a ``MeshShape`` will do): one
``all_gather`` per bucket of ``sharding.gather_tensors`` (the leaves that
share their sharded axes and their dtype after the cast), its result the
bucket's whole tensors, and one ``all_reduce`` of the float32 gradients and
the loss over the data group.  The dry run prices a production cell with
them; on a group, each call runs inside a ``torch.profiler`` label naming
its kind, mesh axes and group size (``sharding.collective_label``), which
``perf.coll_breakdown`` reads back from a trace.

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
    P,
    collective_label,
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
from repro_torch.tree import param_tree, tree_leaves, tree_map

__all__ = ["data_group_axes", "gather_collectives", "rank_train_step", "sharded_train_step",
           "step_collectives"]


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

    def reduce(flat: torch.Tensor) -> None:
        with torch.profiler.record_function(collective_label("all-reduce", data, d_size)):
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)

    def train_step(state: dict, batch: dict):
        if not checked:
            check(state)
        shards = tree_leaves(state["params"])

        def gather(cast: list) -> list[torch.Tensor]:
            return gather_tensors([DTensor.from_local(c, dt.device_mesh, dt.placements,
                                                      run_check=False, shape=dt.shape,
                                                      stride=dt.stride())
                                   for c, dt in zip(cast, shards)])

        local = {key: tree_map(_local, state[key]) for key in _LOCAL_KEYS if key in state}
        metrics = rank_train_step(cfg, optimizer, loss_fn, state, local, batch, n=n,
                                  d_size=d_size, d_idx=d_idx, gather=gather,
                                  slices=[dtensor_slices(dt, coord) for dt in shards],
                                  reduce=reduce if group is not None else None)
        return state, metrics

    return train_step


_LOCAL_KEYS = ("params", "m", "v", "step", "lr")


def rank_train_step(cfg, optimizer, loss_fn, state: dict, local: dict, batch: dict, *, n: int,
                    d_size: int, d_idx: int, gather, slices: list, reduce=None,
                    indices=None) -> dict:
    """One rank's ``sharded_train_step`` from its own tensors on: the step
    runs it on a group, the dry run (``launch.dryrun``) on ``meta``, with
    the gather, the sum and the rows as their arguments.  Returns the
    metrics.

    ``state`` is the step's state: its ``params`` give the tree's
    structure, and the compressor's buffer is read and set there.
    ``local`` holds the rank's own tensors of ``params`` (a tree), ``m``,
    ``v``, ``step`` and ``lr``, which the update changes in place.
    ``gather(cast)`` returns the whole weights, in ``tree_leaves``' order,
    from the rank's shards cast by ``compute_weight``; ``slices[j]`` is the
    rank's slice of leaf j's whole tensor; ``reduce(flat)`` sums the
    float32 gradients and the loss over the data group in place (``None``:
    a group of one).  ``batch`` is the global batch, of which the rank takes
    row block ``d_idx`` of ``d_size`` in every microbatch; ``indices`` are
    the microbatches run (``microbatch_grads``)."""
    shards = tree_leaves(local["params"])
    weights = [w.detach().requires_grad_()
               for w in gather([compute_weight(s, cfg) for s in shards])]
    ptree = state["params"]
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
    loss, _ = microbatch_grads(loss_fn, tree, batch, n, select=select, into=acc,
                               indices=indices)
    flat[-1] = loss
    del tree, weights
    if reduce is not None:
        reduce(flat)
    loss = flat[-1].clone()
    if loss.device.type != "meta":  # a meta tensor holds no value to check
        check_finite(loss)

    if optimizer is None:
        sgd_update(state, shards, [g[sl] for g, sl in zip(acc, slices)])
        return {"loss": loss}
    it = iter(acc)
    grads = tree_map(lambda _: next(it), ptree)
    if optimizer.compressor is not None:
        grads, state = _compress(optimizer.compressor, grads, state)
    gnorm = global_norm(grads)
    it = iter(slices)
    local_grads = tree_map(lambda g: g[next(it)], grads)
    _, metrics = optimizer.apply_gradients(local, local_grads, grad_norm=gnorm)
    return dict(metrics, loss=loss)


def gather_collectives(leaves, specs, mesh) -> list[dict]:
    """The ``all_gather`` calls of ``sharding.gather_tensors`` over tensors of
    these ``(shape, dtype)`` ``leaves`` placed by ``specs``: one call per
    bucket of leaves that share their sharded mesh axes (in the mesh's
    order) and dtype, in the order of each bucket's first leaf; its result
    is the bucket's whole tensors.  Unsharded leaves are copied, not
    gathered."""
    sizes = axis_sizes(mesh)
    buckets: dict[tuple, int] = {}
    for (shape, dtype), spec in zip(leaves, specs):
        used = set(P(*spec).axes())
        axes = tuple(a for a in sizes.axis_names if a in used)
        if not axes:
            continue
        key = (axes, dtype)
        buckets[key] = buckets.get(key, 0) + math.prod(shape) * dtype.itemsize
    return [{"kind": "all-gather", "result_bytes": float(nbytes), "axes": axes,
             "group": math.prod(sizes.shape[a] for a in axes)}
            for (axes, _), nbytes in buckets.items()]


def step_collectives(cfg, params, param_specs, mesh, batch_shardings) -> list[dict]:
    """The collectives one ``sharded_train_step`` call makes on every rank,
    in closed form: the gather of the weights, cast as the step casts them
    (``compute_weight``), and the ``all_reduce`` of their float32 gradients
    and the loss over the data group (none on a group of one).  ``params``
    is a model or its parameter tree (only shapes and dtypes are read:
    ``meta`` tensors or the step's ``DTensor`` shards will do),
    ``param_specs`` its specs."""
    sizes = axis_sizes(mesh)
    # compute_weight's cast: tensors of 2 or more dimensions to cfg.dtype
    leaves = [(tuple(p.shape), cfg.dtype if p.dim() >= 2 else p.dtype)
              for p in tree_leaves(param_tree(params))]
    records = gather_collectives(leaves, spec_leaves(param_specs), sizes)
    data = data_group_axes(batch_shardings)
    d_size = math.prod(sizes.shape[a] for a in data)
    if d_size > 1:
        numel = sum(math.prod(shape) for shape, _ in leaves) + 1
        records.append({"kind": "all-reduce", "result_bytes": float(numel * 4), "axes": data,
                        "group": d_size})
    return records


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
