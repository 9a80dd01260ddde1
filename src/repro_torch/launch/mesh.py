"""Meshes (port of ``repro.launch.mesh``), and the port's counterparts of
the two mesh types JAX takes from its library.

* ``make_mesh(shape, axes)`` is ``jax.make_mesh``: a
  ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
  process group that ``distributed.spawn`` started, one rank per device,
  ranks laid out row-major over the axes (the last axis minor).
* ``MeshShape(shape, axes)`` is ``jax.sharding.AbstractMesh``: axis names
  and sizes, no processes.  The sharding rules read only these, so they
  run, and are tested, without a group.
* ``make_production_mesh`` builds JAX's production meshes, (16, 16) and
  (2, 16, 16), and needs a group of 256 or 512 ranks.
* ``axis_group(mesh, axes)`` is the process group over ``axes`` that holds
  this rank (``psum(..., axes)`` inside ``shard_map``), and
  ``axis_index(mesh, axes)`` this rank's index in it (``axis_index``),
  the first axis major, as JAX orders a tuple of axes.

Built as functions, so importing this module touches no process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["MODEL_AXIS", "MeshShape", "axis_group", "axis_index", "axis_sizes", "data_axes",
           "make_mesh", "make_production_mesh", "rank_coordinate"]

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without processes.  ``mesh.shape[name]``
    and ``mesh.axis_names`` read as on a JAX mesh."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"shape {self.sizes} and axes {self.axis_names} differ in length")
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch / gradient reduction (pod composes with data)."""
    return tuple(a for a in axis_sizes(mesh).axis_names if a in ("pod", "data"))


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over this process group,
    which must hold exactly ``prod(shape)`` ranks (start it with
    ``distributed.spawn``).  ``device`` is the ranks' device type (default
    the GPU; raises without one)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh({shape}) needs a process group of {math.prod(shape)} "
                           "ranks: start one with repro_torch.distributed.spawn")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks; the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """JAX's production mesh: (16, 16) over (data, model), or (2, 16, 16) over
    (pod, data, model); the process group must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(f"the production mesh {shape} needs a process group of {need} ranks, "
                           f"one per device; this process has "
                           f"{'none' if have is None else f'one of {have}'}")
    return make_mesh(shape, axes, device=device)


def _coordinate(mesh) -> tuple[int, ...]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(coord)


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (a name or a tuple, the first major)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    coord = _coordinate(mesh)
    idx = 0
    for a in axes:
        k = names.index(a)
        idx = idx * mesh.shape[k] + coord[k]
    return idx


_GROUPS: dict[tuple, object] = {}


def axis_group(mesh, axes):
    """The process group over ``axes`` that holds this rank.  Every rank must
    ask for the same axes in the same order (it is made the first time,
    collectively, one ``new_group`` per group of the partition)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} is not in the mesh's axes {names}")
    layout = mesh.mesh
    key = (id(dist.group.WORLD), tuple(layout.flatten().tolist()), tuple(layout.shape), names,
           axes)
    if key not in _GROUPS:
        if tuple(sorted(axes, key=names.index)) == names and layout.numel() == dist.get_world_size():
            _GROUPS[key] = dist.group.WORLD
        else:
            dims = [names.index(a) for a in axes]
            rest = [k for k in range(len(names)) if k not in dims]
            ranks = layout.permute(rest + dims).reshape(-1, math.prod(layout.shape[k] for k in dims))
            mine = None
            for row in ranks.tolist():  # every rank makes every group, in one order
                group = dist.new_group(row)
                if dist.get_rank() in row:
                    mine = group
            _GROUPS[key] = mine
    return _GROUPS[key]


def rank_coordinate(mesh, rank: int) -> tuple[int, ...]:
    """The mesh coordinate of global rank ``rank``."""
    hit = (mesh.mesh == rank).nonzero()
    if hit.shape[0] != 1:
        raise ValueError(f"rank {rank} is not in the mesh")
    return tuple(int(c) for c in hit[0])
