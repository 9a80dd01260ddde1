"""Sharding rules: DP over (pod, data), TP/EP over model, SP for decode caches
(port of ``repro.distributed.sharding``), and the port's way of putting a
state on a mesh.

**The rules** are JAX's, rule for rule: name-based over the parameter
tree, a dimension sharded on ``model`` only when the axis size divides it,
FSDP of the largest remaining divisible dimension over the data axes.
They take a ``Transformer``, a tree of tensors or ``model_zoo.input_specs``'
meta tensors, a mesh (``launch.mesh.MeshShape``, a ``DeviceMesh``) and
return one ``PartitionSpec`` per leaf, in the tree's structure.  The port's
``PartitionSpec`` is a tuple with one entry per tensor dimension: ``None``,
an axis name, or a tuple of names (the first major), normalised as JAX
normalises its own (a 1-tuple is the name, an empty tuple ``None``), so
two specs compare equal with ``==``.

JAX stacks each layer stack on a leading axis (``layers/attn/wq`` is (L, d,
H, hd)); the port holds a list of per-layer dicts.  Each rule is applied to
the stacked shape under JAX's path, the FSDP pick counting L among its
candidates, and the stack's entry is then dropped; a rule that would shard
the stack axis raises (none does for the ten configs on the meshes the
tests hold).

**ZeRO-1** (``train_state_shardings(zero1=True)``) departs from JAX on
purpose: JAX's ``_zero1_shardings`` adds the data axes to the first free
divisible dimension of every moment, also where FSDP has already put them
on the leaf, and every config then raises ``DuplicateSpecError``.  The
port adds them, on the first free dimension they divide (the dimension
JAX's loop picks), only to a leaf that does not carry them yet; the others
keep their parameter spec.

**Placing a state.** ``placements(spec, mesh)`` gives the spec's
``torch.distributed.tensor`` placements, one per mesh dimension (several
axes on one tensor dimension in mesh order, the first major, as
``DTensor`` nests them).  ``shard_state(tree, shardings, mesh)`` is
``jax.device_put(x, sharding)``: each rank keeps its slice of each leaf as a
``DTensor``, with no collective.  ``gather_state(tree)`` gives the full
tensors back on every rank, by ``all_gather`` over the ranks that hold a
leaf's pieces (leaves of one group and dtype in one call), a collective
that works on gloo with CUDA tensors; uneven shards are refused.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.layout import get_layout
from repro_torch.launch.mesh import (
    MeshShape,
    axis_group,
    axis_sizes,
    data_axes,
    rank_coordinate,
)

__all__ = [
    "P",
    "PartitionSpec",
    "batch_shardings",
    "collective_label",
    "decode_state_shardings",
    "gather_state",
    "gather_tensors",
    "is_sharded",
    "local_slices",
    "param_shardings",
    "placements",
    "shard_state",
    "shard_tensor",
    "spec_leaves",
    "train_state_shardings",
]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None``, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            elif e is not None and not isinstance(e, str):
                raise TypeError(f"spec entry {e!r}: use None, an axis name or a tuple of names")
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> list[str]:
        """Every axis name in the spec, in order."""
        out = []
        for e in self:
            out.extend((e,) if isinstance(e, str) else (e or ()))
        return out


P = PartitionSpec


# -- walking the port's trees under JAX's paths ----------------------------


def _is_model(x) -> bool:
    return hasattr(x, "params") and hasattr(x, "cfg")


def _walk(tree, fn: Callable, path: tuple = (), stack: int | None = None):
    """``fn(path, shape, stack)`` for each leaf, in ``tree``'s structure.
    ``path`` is JAX's (list indices left out), ``shape`` the stacked shape
    (the list's length first) inside a layer stack, ``stack`` that length.
    A stack's entries share one walk of its first layer."""
    if _is_model(tree):
        return _walk(tree.params(), fn, path, stack)
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),), stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if stack is not None:
            raise ValueError(f"{'/'.join(path)}: a layer stack inside a layer stack")
        if not tree:
            return type(tree)()
        first = _walk(tree[0], fn, path, len(tree))
        return type(tree)(_copy(first) for _ in tree)
    shape = tuple(getattr(tree, "shape", ()))
    if stack is not None:
        shape = (stack,) + shape
    return fn("/".join(path), shape, stack)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


def _unstack(path: str, spec: list, stack: int | None) -> PartitionSpec:
    spec = P(*spec)
    if stack is None:
        return spec
    if spec[0] is not None:
        raise ValueError(f"{path}: the rule shards the layer-stack axis ({spec[0]!r}), which the "
                         "port holds as a list of per-layer tensors")
    return P(*spec[1:])


def _size(mesh: MeshShape, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in axes)


# -- the rules ---------------------------------------------------------------


def _leaf_spec(path: str, shape: tuple, cfg, mesh: MeshShape) -> tuple:
    """Trailing-dims spec for one parameter leaf of the stacked ``shape``:
    head/vocab sharding on ``model``, else replicated (JAX's order)."""
    tp = mesh.shape["model"]
    nd = len(shape)

    def ok(dim: int) -> bool:
        return dim % tp == 0

    def pad(spec: tuple) -> tuple:
        return (None,) * (nd - len(spec)) + spec

    if path.endswith("emb"):
        if ok(shape[0]):
            return ("model", None)
        if ok(shape[1]):
            return (None, "model")
        return (None, None)
    if "/attn/" in path or path.startswith("attn/"):
        if path.endswith("wq") or path.endswith("wk") or path.endswith("wv"):
            return pad((None, "model", None)) if ok(shape[-2]) else pad((None, None, None))
        if path.endswith("wo"):
            return pad(("model", None, None)) if ok(shape[-3]) else pad((None, None, None))
    if path.endswith("w_gate") or path.endswith("w_up"):
        if nd >= 3 and cfg.is_moe and "ffn" in path:
            return pad(("model", None, None))
        return pad((None, "model" if ok(shape[-1]) else None))
    if path.endswith("w_down"):
        if nd >= 3 and cfg.is_moe and "ffn" in path:
            return pad(("model", None, None))
        return pad(("model" if ok(shape[-2]) else None, None))
    if path.endswith("router"):
        return pad((None, None))
    if path.endswith("/ck"):
        return pad((None, "model" if ok(shape[-1]) else None))
    if path.endswith("/cv"):
        return pad(("model" if ok(shape[-2]) else None, None))
    return (None,) * nd


def _param_rule(cfg, mesh: MeshShape, fsdp: bool, layout: str):
    """The stacked spec (a list) of one parameter leaf: JAX's ``assign``."""
    dp = tuple(mesh.axis_names) if layout == "dp_only" else data_axes(mesh)
    dp_size = _size(mesh, dp)

    def assign(path: str, shape: tuple) -> list:
        nd = len(shape)
        if layout == "dp_only":
            spec = [None] * nd
        else:
            spec = list(_leaf_spec(path, shape, cfg, mesh))
            spec += [None] * (nd - len(spec))
        if fsdp and nd >= 2:
            cands = [(shape[i], i) for i in range(nd)
                     if spec[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size]
            if cands:
                _, i = max(cands)
                spec[i] = dp
        return spec

    return assign


def param_shardings(params, cfg, mesh, *, fsdp: bool = True, layout: str | None = None):
    """A ``PartitionSpec`` per parameter leaf, in ``params``' tree structure
    (a ``Transformer`` gives its ``params()`` tree).

    layout "2d" (default): TP/EP rules over 'model' + FSDP of the largest
    remaining divisible dim over (pod, data).  layout "dp_only": no tensor
    parallelism; FSDP over ALL mesh axes."""
    mesh = axis_sizes(mesh)
    rule = _param_rule(cfg, mesh, fsdp, layout or get_layout())
    return _walk(params, lambda path, shape, stack: _unstack(path, rule(path, shape), stack))


def batch_shardings(batch, cfg, mesh, *, layout: str | None = None):
    """Inputs: batch dim over the layout's data axes when divisible.

    dp_only tries all axes first, then the data axes; else replicated."""
    mesh = axis_sizes(mesh)
    layout = layout or get_layout()
    candidates = ([tuple(mesh.axis_names), data_axes(mesh)] if layout == "dp_only"
                  else [data_axes(mesh)])

    def assign(path: str, shape: tuple, stack) -> PartitionSpec:
        if not shape:
            return P()
        for dp in candidates:
            if shape[0] % _size(mesh, dp) == 0:
                return P(dp, *((None,) * (len(shape) - 1)))
        return P(*((None,) * len(shape)))

    return _walk(batch, assign)


def decode_state_shardings(state, cfg, mesh):
    """KV caches / SSM states: batch over (pod, data) when divisible; KV heads
    over model when divisible, else the cache's SEQUENCE over model (the
    lse-combine of ``distributed.decode`` makes that exact)."""
    mesh = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_size = _size(mesh, dp)
    tp = mesh.shape["model"]

    def assign(path: str, shape: tuple, stack) -> PartitionSpec:
        nd = len(shape)
        if nd == 0:
            return P()
        if path in ("k", "v", "cross_k", "cross_v") or path.startswith("shared_"):
            b, s, kv = shape[1], shape[2], shape[3]
            bspec = dp if b % dp_size == 0 else None
            if kv % tp == 0:
                return P(None, bspec, None, "model", None)
            if s % tp == 0:
                return P(None, bspec, "model", None, None)
            return P(None, bspec, None, None, None)
        if path == "wkv":
            b, h, hdk = shape[1], shape[2], shape[3]
            bspec = dp if b % dp_size == 0 else None
            if h % tp == 0:
                return P(None, bspec, "model", None, None)
            if hdk % tp == 0:
                return P(None, bspec, None, "model", None)
            return P(None, bspec, None, None, None)
        if path == "h":
            b, nh = shape[1], shape[2]
            bspec = dp if b % dp_size == 0 else None
            return P(None, bspec, "model" if nh % tp == 0 else None, None, None)
        if path in ("conv_buf", "x_prev_t", "x_prev_c"):
            bspec = dp if shape[1] % dp_size == 0 else None
            return P(None, bspec, *((None,) * (nd - 2)))
        if shape[0] % dp_size == 0:
            return P(dp, *((None,) * (nd - 1)))
        return P(*((None,) * nd))

    return _walk(state, assign)


def _replicated(tree):
    return _walk(tree, lambda path, shape, stack: _unstack(path, [None] * len(shape), stack))


def train_state_shardings(state, cfg, mesh, *, zero1: bool = False):
    """Train state = {params, m, v, scalars, ...}: params-like leaves take the
    parameter rules, everything else is replicated.  ``zero1`` also shards
    the moments over the data axes where they do not carry them yet (the
    port's departure from JAX, whose rule raises: see the module's notes)."""
    out: dict[str, Any] = {"params": param_shardings(state["params"], cfg, mesh)}
    for key, sub in state.items():
        if key == "params":
            continue
        if key in ("m", "v"):
            out[key] = _zero1_shardings(sub, cfg, mesh) if zero1 else param_shardings(sub, cfg,
                                                                                        mesh)
        else:
            out[key] = _replicated(sub)
    return out


def _zero1_shardings(params, cfg, mesh):
    mesh = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_size = _size(mesh, dp)
    rule = _param_rule(cfg, mesh, True, get_layout())

    def assign(path: str, shape: tuple, stack) -> PartitionSpec:
        spec = rule(path, shape)
        if not set(P(*spec).axes()) & set(dp):
            for i in range(len(shape)):
                if spec[i] is None and shape[i] % dp_size == 0:
                    spec[i] = dp
                    break
        return _unstack(path, spec, stack)

    return _walk(params, assign)


# -- placing a state on a mesh ------------------------------------------------


def _mesh_axes_of(spec: PartitionSpec, names: tuple[str, ...]) -> dict[int, list[str]]:
    """tensor dim -> the axes sharding it; checks each axis is used once, in
    mesh order within a dimension, and that every axis is the mesh's."""
    seen: set[str] = set()
    out = {}
    for i, e in enumerate(spec):
        axes = [e] if isinstance(e, str) else list(e or ())
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not in the mesh's axes {names}")
            if a in seen:
                raise ValueError(f"{spec} maps mesh axis {a!r} to more than one dimension")
            seen.add(a)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"{spec}: the axes {axes} of one dimension must follow the mesh's "
                             f"order {names}")
        if axes:
            out[i] = axes
    return out


def placements(spec: PartitionSpec, mesh) -> list:
    """The spec's ``DTensor`` placements, one per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_sizes(mesh).axis_names
    by_axis = {a: i for i, axes in _mesh_axes_of(P(*spec), names).items() for a in axes}
    return [Shard(by_axis[a]) if a in by_axis else Replicate() for a in names]


def local_slices(spec: PartitionSpec, shape, mesh, coordinate) -> tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the rank at mesh ``coordinate``
    holds under ``spec`` (an even split; uneven ones are refused)."""
    sizes = axis_sizes(mesh)
    names = sizes.axis_names
    if len(spec) != len(shape):
        raise ValueError(f"{spec} has {len(spec)} entries for a tensor of shape {tuple(shape)}")
    by_dim = _mesh_axes_of(P(*spec), names)
    out = []
    for i, n in enumerate(shape):
        axes = by_dim.get(i, [])
        count, idx = 1, 0
        for a in axes:
            k = names.index(a)
            count *= sizes.sizes[k]
            idx = idx * sizes.sizes[k] + coordinate[k]
        if n % count:
            raise ValueError(f"dimension {i} of {tuple(shape)} ({n}) does not split evenly over "
                             f"{axes} ({count}); the port refuses uneven shards")
        step = n // count
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def spec_leaves(tree) -> list[PartitionSpec]:
    """The ``PartitionSpec``s of a tree of them, in ``tree.tree_leaves``' order
    (a spec is a tuple, which ``tree_leaves`` would walk into)."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in spec_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in spec_leaves(item)]
    raise TypeError(f"not a PartitionSpec: {tree!r}")


def is_sharded(tree) -> bool:
    """Whether any leaf of ``tree`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor

    found = []
    _walk_leaves(tree, lambda x: found.append(isinstance(x, DTensor)))
    return any(found)


def _walk_leaves(tree, fn):
    if _is_model(tree):
        return _walk_leaves(tree.params(), fn)
    if isinstance(tree, dict):
        return {k: _walk_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_leaves(v, fn) for v in tree)
    return fn(tree)


def _zip_specs(tree, shardings, fn, where: str = ""):
    """``fn(leaf, spec)`` over ``tree`` and the matching ``shardings``."""
    if _is_model(tree):
        return _zip_specs(tree.params(), shardings, fn, where)
    if isinstance(tree, dict):
        return {k: _zip_specs(v, shardings[k], fn, f"{where}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(shardings):
            raise ValueError(f"{where}: {len(tree)} entries, {len(shardings)} specs")
        return type(tree)(_zip_specs(v, s, fn, f"{where}/{i}")
                          for i, (v, s) in enumerate(zip(tree, shardings)))
    return fn(tree, shardings)


def shard_tensor(full: torch.Tensor, spec: PartitionSpec, mesh, *, device=None):
    """A ``DTensor`` on ``mesh`` holding this rank's slice of ``full`` under
    ``spec``, copied (on ``device``, default ``full``'s)."""
    from torch.distributed.tensor import DTensor

    coord = tuple(mesh.get_coordinate())
    local = full.detach()[local_slices(spec, full.shape, mesh, coord)]
    local = local.to(device or full.device, copy=True).contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=_contiguous_stride(full.shape))


def shard_state(tree, shardings, mesh):
    """``tree`` with each tensor leaf replaced by a ``DTensor`` on ``mesh``
    holding this rank's slice under its spec (a copy: the full tensor is
    not kept).  A ``Transformer`` becomes its ``params()`` tree.  Every rank
    must pass the same full values; no collective runs."""
    from torch.distributed.tensor import DTensor

    def put(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if isinstance(leaf, DTensor):
            raise ValueError("shard_state takes full tensors; gather_state a sharded one first")
        return shard_tensor(leaf, spec, mesh)

    return _zip_specs(tree, shardings, put)


def collective_label(kind: str, axes, group: int) -> str:
    """The ``torch.profiler`` label around one collective call: its kind (JAX's
    name), the mesh axes of its group and the group's size, which gloo's own
    trace events do not carry (``perf.coll_breakdown`` reads it back)."""
    return f"repro_torch.{kind}[{','.join(axes)}|{int(group)}]"


def _dtensor_spec(dt, keep=None) -> PartitionSpec:
    """``dt``'s placements as a spec, keeping only the axes in ``keep``."""
    from torch.distributed.tensor import Shard

    names = tuple(dt.device_mesh.mesh_dim_names)
    entries: list[list[str]] = [[] for _ in dt.shape]
    for k, p in enumerate(dt.placements):
        if isinstance(p, Shard) and (keep is None or names[k] in keep):
            entries[p.dim].append(names[k])
    return P(*entries)


def gather_tensors(dts: list, axes=None) -> list[torch.Tensor]:
    """Tensors of ``dts`` gathered over the mesh ``axes`` (default every
    axis: the full tensors), on every rank: one ``all_gather`` per group of
    leaves that share the gathered axes and a dtype.  A leaf stays sharded
    on its other axes (the sharded step gathers over the data axes and
    keeps the model axis's shards); an axis gathered and one kept may not
    shard one dimension."""
    buckets: dict[tuple, list[int]] = {}
    for j, dt in enumerate(dts):
        names = tuple(dt.device_mesh.mesh_dim_names)
        used = set(_dtensor_spec(dt).axes())
        gathered = tuple(a for a in names if a in used and (axes is None or a in axes))
        buckets.setdefault((id(dt.device_mesh), gathered, dt.dtype), []).append(j)
    out: list[torch.Tensor | None] = [None] * len(dts)
    for (_, gathered, dtype), idx in buckets.items():
        mesh = dts[idx[0]].device_mesh
        locals_ = [dts[j].to_local() for j in idx]
        if not gathered:
            for j, loc in zip(idx, locals_):
                out[j] = loc.clone()
            continue
        coord = tuple(mesh.get_coordinate())
        kept = [_dtensor_spec(dts[j], set(mesh.mesh_dim_names) - set(gathered)) for j in idx]
        part = [_dtensor_spec(dts[j], set(gathered)) for j in idx]
        for k_spec, g_spec in zip(kept, part):
            if any(a is not None and b is not None for a, b in zip(k_spec, g_spec)):
                raise ValueError(f"a dimension sharded on gathered and kept axes: {k_spec}, "
                                 f"{g_spec}")
        shapes = [tuple(sl.stop - sl.start for sl in local_slices(k_spec, dts[j].shape, mesh,
                                                                  coord))
                  for j, k_spec in zip(idx, kept)]
        flat = torch.cat([loc.reshape(-1) for loc in locals_])
        group = axis_group(mesh, gathered)
        n = dist.get_world_size(group)
        pieces = [torch.empty_like(flat) for _ in range(n)]
        with torch.profiler.record_function(collective_label("all-gather", gathered, n)):
            dist.all_gather(pieces, flat, group=group)
        fulls = [torch.empty(shape, dtype=dtype, device=flat.device) for shape in shapes]
        for g, piece in enumerate(pieces):
            c = rank_coordinate(mesh, dist.get_global_rank(group, g))
            at = 0
            for loc, full, g_spec in zip(locals_, fulls, part):
                full[local_slices(g_spec, full.shape, mesh, c)] = \
                    piece[at:at + loc.numel()].view(loc.shape)
                at += loc.numel()
        for j, full in zip(idx, fulls):
            out[j] = full
    return out


def gather_state(tree):
    """``tree`` with every ``DTensor`` leaf replaced by its full tensor, on
    every rank (collective: every rank calls it on the same tree)."""
    from torch.distributed.tensor import DTensor

    dts: list = []
    _walk_leaves(tree, lambda x: dts.append(x) if isinstance(x, DTensor) else None)
    fulls = iter(gather_tensors(dts))
    return _walk_leaves(tree, lambda x: next(fulls) if isinstance(x, DTensor) else x)
