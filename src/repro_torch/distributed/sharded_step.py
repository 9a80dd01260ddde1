"""The sharded train step: the port's counterpart of
``jax.jit(make_train_step(...), in_shardings=(ssh, bsh), out_shardings=(ssh, None))``.

It has no module of its own in the JAX package: there, pjit (JAX's library)
partitions the unsharded step by the shardings of its inputs.  The port
writes the partitioned step out, on every rank of a mesh whose state
leaves are ``DTensor``s (``sharding.shard_state``), and its result is the
unsharded ``model_zoo.make_train_step``'s up to the order of summation:

* **Gather over the data axes, compute on the model shard.**  Each rank
  casts its weight shards (tensors of 2 or more dimensions to
  ``cfg.dtype``, as the unsharded step's default does before its
  microbatches) and gathers them over the data axes once a step
  (``sharding.gather_tensors(..., axes=)``), as FSDP does.  Under layout
  "2d" the model-axis shards stay on the rank, and every layer computes the
  share JAX's partitioned program gives the device
  (``distributed.tensor_parallel``): heads, hidden width and vocabulary
  split by tensor parallelism, experts by expert parallelism, a weight the
  rules replicate computed whole.  Under "dp_only" the model axis is a data
  axis and the weights are gathered whole.  Microbatch i is the global
  batch's rows ``[i·B/n, (i+1)·B/n)``, JAX's reshape to (n, B/n); the rank
  takes its data group's slice of them.  The loss, the microbatch loop and
  its float32 means are the unsharded step's (``model_zoo.microbatch_grads``),
  given the rank's rows and loss scale.
* **The loss is the global one.**  ``cross_entropy_loss`` divides by the
  count of valid labels; each rank's microbatch loss is scaled by its own
  count over the microbatch's global count, which every rank reads from the
  global batch before the forward, so labels of -100 give the same step.
  On a vocabulary shard the loss is the vocabulary-parallel one, the same
  on every model rank.
* **Sum over the data axes only, into the parameter's sharding.**  The
  float32 gradients (the rank's model shard of each leaf) of every
  microbatch are summed over the data group: the axes that shard the
  batch's first dimension under ``batch_shardings``.  A leaf that FSDP
  shards over exactly those axes takes a ``reduce_scatter`` (one call for
  all of them), which leaves the rank its shard; the others and the loss
  take one ``all_reduce``.  With the optimiser's compressor, every leaf takes
  the ``all_reduce`` instead and the model shards are gathered whole
  (``all_gather`` over ``model``), since the compressor reads the whole
  summed gradient (its scale is a leaf's maximum); its buffer is
  replicated.
* **Clip by the full norm, update the local shard.**  Global-norm clipping
  reads the squares of every rank's shards summed over the mesh (one
  ``all_reduce`` of a scalar), each leaf counted once.  Each rank then
  updates only its shards of the parameters, ``m`` and ``v``, in place:
  the state returned has the shardings it was given.

**Its collectives.**  On a group each call runs inside a ``torch.profiler``
label naming its kind, mesh axes and group size (``sharding.collective_label``),
which ``perf.coll_breakdown`` reads back from a trace.  On ``meta``
(``RankComm`` with no mesh, ``tensor_parallel.model_axis(records=)``) the
same body records the calls instead of making them, as records for
``perf.coll_stats`` (``{"kind", "result_bytes", "group", "axes"}``): the dry
run prices a cell with them (``launch.dryrun.rank_collectives``).

A non-finite loss raises ``FloatingPointError`` on every rank, after the
sum and before any update.  Moments sharded otherwise than their parameter
(``train_state_shardings(zero1=True)``) are refused: this step updates a
parameter's shard with the moments of the same elements.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.layout import get_layout
from repro_torch.distributed.sharding import (
    P,
    collective_label,
    gather_tensors,
    local_slices,
    placements,
    spec_leaves,
)
from repro_torch.launch.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_sizes,
    rank_coordinate,
)
from repro_torch.models.model_zoo import (
    check_finite,
    compute_weight,
    make_loss_fn,
    microbatch_grads,
    on_device,
    sgd_update,
)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["RankComm", "data_group_axes", "gather_collectives", "rank_train_step",
           "sharded_train_step", "tp_axes"]


def data_group_axes(batch_shardings) -> tuple[str, ...]:
    """The mesh axes that shard the batch's first dimension (the same for
    every batch leaf)."""
    firsts = {spec[0] if len(spec) else None for spec in spec_leaves(batch_shardings)}
    if len(firsts) != 1:
        raise ValueError(f"the batch's leaves shard their first dimension differently: {firsts}")
    (first,) = firsts
    return (first,) if isinstance(first, str) else tuple(first or ())


def tp_axes(mesh, data) -> tuple[str, ...]:
    """The axes the layers compute over: ``model`` under layout "2d" (where
    it is not a data axis), none under "dp_only"."""
    names = axis_sizes(mesh).axis_names
    two_d = get_layout() == "2d" and MODEL_AXIS in names and MODEL_AXIS not in data
    return (MODEL_AXIS,) if two_d else ()


def _keep(spec, axes) -> P:
    """``spec`` with only the mesh ``axes`` kept."""
    return P(*(tuple(a for a in P(e).axes() if a in axes) for e in spec))


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


class RankComm:
    """One rank's collectives in the step, over the leaves of ``shapes``
    (full shapes) placed by ``specs``: run on a ``DeviceMesh`` (``mesh``),
    or, on ``meta`` (``mesh=None``), recorded into ``records`` as the calls
    would be made, with tensors of their results' shapes.

    A leaf's model shard (``model_shapes``) is its slice on the model axis
    alone; the gather over the data axes gives it, the update reads the
    rank's shard of it under the whole spec.  ``compressed``: the gradients
    are summed whole over the data group (no reduce-scatter) and gathered
    over the model axis for the optimiser's compressor."""

    def __init__(self, sizes, specs, shapes, data, *, coordinate, mesh=None, compressed=False):
        self.sizes = axis_sizes(sizes)
        self.specs, self.shapes = list(specs), [tuple(s) for s in shapes]
        self.data, self.mesh = tuple(data), mesh
        self.coord = tuple(coordinate)
        self.model = tp_axes(self.sizes, self.data)
        self.d_size = math.prod(self.sizes.shape[a] for a in self.data)
        self.compressed = compressed
        self.records: list[dict] = []
        self.model_shapes = [self._shape(_keep(sp, self.model), sh)
                             for sp, sh in zip(self.specs, self.shapes)]

    def _shape(self, spec, shape) -> tuple[int, ...]:
        return tuple(sl.stop - sl.start
                     for sl in local_slices(spec, shape, self.sizes, self.coord))

    def _group(self, axes):
        return axis_group(self.mesh, axes) if self.mesh is not None else None

    def _call(self, kind: str, axes, result: torch.Tensor, fn=None) -> None:
        n = math.prod(self.sizes.shape[a] for a in axes)
        if self.mesh is None:
            self.records.append({"kind": kind, "axes": tuple(axes), "group": n,
                                 "result_bytes": float(result.numel() * result.element_size())})
            return
        with torch.profiler.record_function(collective_label(kind, axes, n)):
            fn(self._group(axes))

    def _scattered(self, j: int) -> bool:
        """Whether leaf j's gradient is reduce-scattered: FSDP shards it over
        exactly the data group's axes."""
        axes = set(_keep(self.specs[j], self.data).axes())
        return (not self.compressed and self.d_size > 1 and axes == set(self.data)
                and set(P(*self.specs[j]).axes()) <= set(self.data) | set(self.model))

    def gather(self, cast: list, shards: list | None) -> list[torch.Tensor]:
        """The model shards of the weights from the rank's cast shards
        (``shards``: the state's ``DTensor``s, whose placements the cast
        takes; ``None`` on meta)."""
        if self.mesh is None:
            for rec in gather_collectives([(sh, c.dtype) for sh, c in
                                           zip(self.model_shapes, cast)],
                                          [_keep(sp, self.data) for sp in self.specs],
                                          self.sizes):
                self.records.append(rec)
            return [c if tuple(c.shape) == sh else torch.empty(sh, dtype=c.dtype, device="meta")
                    for c, sh in zip(cast, self.model_shapes)]
        from torch.distributed.tensor import DTensor

        dts = [DTensor.from_local(c, dt.device_mesh, dt.placements, run_check=False,
                                  shape=dt.shape, stride=dt.stride())
               for c, dt in zip(cast, shards)]
        return gather_tensors(dts, axes=tuple(a for a in self.sizes.axis_names
                                              if a not in self.model))

    def reduce(self, acc: list[torch.Tensor], loss: torch.Tensor):
        """The data group's sums of the rank's float32 gradients ``acc``
        (model shards) and its loss: each gradient in its leaf's sharding
        (or, with the compressor, the model shard), and the loss."""
        n, data = self.d_size, self.data
        scat = [j for j in range(len(acc)) if self._scattered(j)]
        rest = [j for j in range(len(acc)) if j not in set(scat)]
        out: list[torch.Tensor | None] = [None] * len(acc)
        flat = torch.cat([acc[j].reshape(-1) for j in rest] + [loss.reshape(1).float()])
        if n > 1:
            self._call("all-reduce", data, flat,
                       lambda g: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=g))
        at = 0
        for j in rest:
            out[j] = flat[at:at + acc[j].numel()].view(acc[j].shape)
            at += acc[j].numel()
        loss = flat[-1].clone()
        if scat:
            out = self._reduce_scatter(acc, scat, out)
        if not self.compressed:  # the rank's shard under the leaf's data axes
            return [g if j in set(scat) else self._slice_data(j, g)
                    for j, g in enumerate(out)], loss
        return out, loss

    def _slice_data(self, j: int, g: torch.Tensor) -> torch.Tensor:
        """The rank's shard of leaf j from its model shard ``g``."""
        rest = tuple(a for a in self.sizes.axis_names if a not in self.model)
        return g[local_slices(_keep(self.specs[j], rest), g.shape, self.sizes, self.coord)]

    def _members(self):
        """The mesh coordinates of the data group's members, in its rank order."""
        if self.mesh is None:
            return [self.coord] * self.d_size
        group = self._group(self.data)
        return [rank_coordinate(self.mesh, dist.get_global_rank(group, g))
                for g in range(self.d_size)]

    def _reduce_scatter(self, acc, scat, out):
        pieces = []
        for c in self._members():
            for j in scat:
                sl = local_slices(_keep(self.specs[j], self.data), acc[j].shape, self.sizes, c)
                pieces.append(acc[j][sl].reshape(-1))
        inp = torch.cat(pieces)
        res = inp.new_empty(inp.numel() // self.d_size)
        self._call("reduce-scatter", self.data, res,
                   lambda g: _reduce_scatter_tensor(res, inp, g))
        at = 0
        for j in scat:
            shape = self._shape(P(*self.specs[j]), self.shapes[j])
            k = math.prod(shape)
            out[j] = res[at:at + k].view(shape)
            at += k
        return out

    def norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradients whose rank's shards are ``grads``
        (each in its leaf's sharding): every rank's squares, each leaf's
        counted once, summed over the mesh."""
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for j, g in enumerate(grads):
            pieces = math.prod(self.sizes.shape[a] for a in P(*self.specs[j]).axes())
            total = total + torch.sum(torch.square(g.float())) * (pieces / self.sizes.size)
        if self.sizes.size > 1:
            total = total.reshape(1).clone()
            self._call("all-reduce", self.sizes.axis_names, total,
                       lambda g: dist.all_reduce(total, op=dist.ReduceOp.SUM, group=g))
            total = total[0]
        return torch.sqrt(total)

    def whole(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The whole summed gradients from their model shards (the compressor's)."""
        if not self.model or self.sizes.shape[MODEL_AXIS] == 1:
            return grads
        out = []
        for j, g in enumerate(grads):
            dims = [i for i, e in enumerate(self.specs[j]) if MODEL_AXIS in P(e).axes()]
            if not dims:
                out.append(g)
                continue
            (dim,) = dims
            full = list(g.shape)
            full[dim] = self.shapes[j][dim]
            res = g.new_empty(full)
            if self.mesh is None:
                self._call("all-gather", self.model, res)
            else:
                parts = [torch.empty_like(g) for _ in range(self.sizes.shape[MODEL_AXIS])]
                self._call("all-gather", self.model, res,
                           lambda grp: dist.all_gather(parts, g.contiguous(), group=grp))
                res = torch.cat(parts, dim=dim)
            out.append(res)
        return out

    def mine(self, j: int, whole: torch.Tensor) -> torch.Tensor:
        """The rank's shard of leaf j's whole tensor."""
        return whole[local_slices(P(*self.specs[j]), whole.shape, self.sizes, self.coord)]


def _reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, op=dist.ReduceOp.SUM, group=group)


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
    coord = tuple(mesh.get_coordinate())
    axis = tp.model_axis(mesh) if tp_axes(mesh, data) else None
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

    def train_step(state: dict, batch: dict):
        if not checked:
            check(state)
        shards = tree_leaves(state["params"])
        comm = RankComm(sizes, spec_leaves(state_shardings["params"]),
                        [dt.shape for dt in shards], data, coordinate=coord, mesh=mesh,
                        compressed=optimizer is not None and optimizer.compressor is not None)
        local = {key: tree_map(_local, state[key]) for key in _LOCAL_KEYS if key in state}
        with tp.scope(axis):
            metrics = rank_train_step(cfg, optimizer, loss_fn, state, local, batch, n=n,
                                      d_size=d_size, d_idx=d_idx, comm=comm, shards=shards)
        return state, metrics

    return train_step


_LOCAL_KEYS = ("params", "m", "v", "step", "lr")


def rank_train_step(cfg, optimizer, loss_fn, state: dict, local: dict, batch: dict, *, n: int,
                    d_size: int, d_idx: int, comm: RankComm, shards: list | None = None,
                    indices=None) -> dict:
    """One rank's ``sharded_train_step`` from its own tensors on, inside the
    rank's ``tensor_parallel.scope``: the step runs it on a group, the dry
    run (``launch.dryrun``) on ``meta`` with a recording ``comm``.  Returns
    the metrics.

    ``state`` is the step's state: its ``params`` give the tree's
    structure, and the compressor's buffer is read and set there.
    ``local`` holds the rank's own tensors of ``params`` (a tree), ``m``,
    ``v``, ``step`` and ``lr``, which the update changes in place.
    ``comm`` makes the collectives (``RankComm``: the gather of the model
    shards over the data axes, the gradients' sums, the norm); ``shards``
    are the state's ``DTensor``s on a group.  ``batch`` is the global batch,
    of which the rank takes row block ``d_idx`` of ``d_size`` in every
    microbatch; ``indices`` are the microbatches run (``microbatch_grads``)."""
    mine = tree_leaves(local["params"])
    weights = [w.detach().requires_grad_()
               for w in comm.gather([compute_weight(s, cfg) for s in mine], shards)]
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

    # the float32 gradients of the model shards, summed over the microbatches
    flat = torch.zeros(sum(w.numel() for w in weights), dtype=torch.float32, device=dev)
    acc, at = [], 0
    for w in weights:
        acc.append(flat[at:at + w.numel()].view(w.shape))
        at += w.numel()
    loss, _ = microbatch_grads(loss_fn, tree, batch, n, select=select, into=acc,
                               indices=indices)
    del tree, weights
    grads, loss = comm.reduce(acc, loss)
    del acc, flat
    if loss.device.type != "meta":  # a meta tensor holds no value to check
        check_finite(loss)

    if optimizer is None:
        sgd_update(state, mine, grads)
        return {"loss": loss}
    if optimizer.compressor is not None:
        whole = comm.whole(grads)
        it = iter(whole)
        gtree, state = _compress(optimizer.compressor, tree_map(lambda _: next(it), ptree),
                                 state)
        grads = [comm.mine(j, g) for j, g in enumerate(tree_leaves(gtree))]
    gnorm = comm.norm(grads)
    it = iter(grads)
    local_grads = tree_map(lambda _: next(it), ptree)
    _, metrics = optimizer.apply_gradients(local, local_grads, grad_norm=gnorm)
    return dict(metrics, loss=loss)


def gather_collectives(leaves, specs, mesh) -> list[dict]:
    """The ``all_gather`` calls of ``sharding.gather_tensors`` over tensors of
    these ``(shape, dtype)`` ``leaves`` placed by ``specs``: one call per
    bucket of leaves that share their sharded mesh axes (in the mesh's
    order) and dtype, in the order of each bucket's first leaf; its result
    is the bucket's tensors gathered (the sharded step passes the model
    shards' shapes and the specs' data axes).  Unsharded leaves are copied,
    not gathered."""
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
