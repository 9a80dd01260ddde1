"""Checkpoints: ``shards.npz`` + ``manifest.json``, published by atomic rename
(port of ``repro.runtime.checkpoint``).

The on-disk format is the JAX package's, so a checkpoint written by either
package restores in the other: the directory ``<step:010d>`` is staged as
``<step:010d>.tmp`` and renamed with ``os.replace``; the manifest, written
last, names every leaf by its pytree path (``params/layers/attn/wq``, ...)
with its shape, dtype and npz key; the layer stack is stacked on a leading
axis on save, as JAX holds it, and split into the port's per-layer tensors
on restore.  ``CheckpointManager`` keeps the newest ``keep``.

A state is a nested dict of tensors, lists of per-layer dicts (stacked) and
``Transformer``s (saved as their ``params()`` tree).  Restoring builds new
tensors, each on its target leaf's device; a ``Transformer`` in the target
comes back as a new ``Transformer`` of the same config.

Sharded states (``DTensor`` leaves, ``distributed.sharding.shard_state``):
every rank calls ``save_checkpoint``; each leaf is gathered whole, rank 0
writes the same format, and the others wait at a barrier.  The elastic
restore, ``restore_checkpoint(shardings=, mesh=)``, lands each leaf with
its target spec on ``mesh``, whatever mesh wrote it (the file holds whole
arrays, also when JAX wrote it from a sharded state): each rank reads the
file and keeps its slice, with no collective; a ``Transformer`` in the
target then comes back as its ``params()`` tree.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import tree_to_numpy
from repro_torch.distributed.sharding import gather_state, is_sharded, shard_tensor
from repro_torch.models.transformer import Transformer

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]

_MANIFEST = "manifest.json"


def _flatten(tree, prefix: tuple = ()) -> dict[str, np.ndarray]:
    """name -> numpy array of a tree in the JAX layout, dict keys sorted
    (JAX's order)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], prefix + (str(key),)))
        return out
    return {"/".join(prefix): tree}


def save_checkpoint(directory: str | Path, step: int, state: Any, *,
                    extra_metadata: dict | None = None) -> Path:
    """Write ``<directory>/<step>`` atomically.  Returns the final path.  A
    sharded state is a collective: every rank calls it, rank 0 writes."""
    directory = Path(directory)
    final = directory / f"{step:010d}"
    if is_sharded(state):
        state = gather_state(state)
        if dist.get_rank() == 0:
            _write(directory, final, step, state, extra_metadata)
        dist.barrier()
        return final
    _write(directory, final, step, state, extra_metadata)
    return final


def _write(directory: Path, final: Path, step: int, state: Any,
           extra_metadata: dict | None) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: dict[str, Any] = {
        "step": int(step),
        "created": time.time(),
        "format": "repro-ckpt-v1",
        "leaves": {},
        "metadata": extra_metadata or {},
    }
    arrays = {}
    for name, arr in _flatten(tree_to_numpy(state)).items():
        key = name.replace("/", "__")
        arrays[key] = arr
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                                    "file": "shards.npz", "key": key}
    np.savez(tmp / "shards.npz", **arrays)
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish


def _complete_steps(directory: Path) -> list[int]:
    steps = []
    for p in directory.iterdir():
        if p.is_dir() and not p.name.endswith(".tmp") and (p / _MANIFEST).exists():
            try:
                steps.append(int(p.name))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def _build(target, prefix: tuple, index: tuple, leaf_array, shardings=None, mesh=None):
    """A new tree of ``target``'s structure from the checkpoint's arrays; with
    ``shardings``, each leaf a ``DTensor`` of this rank's slice on ``mesh``."""
    if isinstance(target, Transformer):
        tree = _build(target.params(), prefix, index, leaf_array, shardings, mesh)
        return tree if shardings is not None else Transformer(target.cfg, tree)
    if isinstance(target, dict):
        return {k: _build(v, prefix + (str(k),), index, leaf_array,
                          None if shardings is None else shardings[k], mesh)
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_build(item, prefix, index + (i,), leaf_array,
                                   None if shardings is None else shardings[i], mesh)
                            for i, item in enumerate(target))
    name = "/".join(prefix)
    arr = leaf_array(name)[index]
    want = tuple(target.shape) if hasattr(target, "shape") else arr.shape
    if tuple(arr.shape) != want:
        raise ValueError(f"{name}: checkpoint shape {arr.shape} != {want}")
    device = target.device if isinstance(target, torch.Tensor) else "cpu"
    if shardings is not None:
        return shard_tensor(torch.from_numpy(np.asarray(arr)), shardings, mesh, device=device)
    return torch.from_numpy(np.array(arr)).to(device)


def restore_checkpoint(directory: str | Path, target: Any, *, step: int | None = None,
                       shardings: Any = None, mesh=None) -> tuple[Any, dict]:
    """Restore into the structure of ``target``; returns ``(state, metadata)``.
    Each leaf lands on the device of ``target``'s leaf; with ``shardings``
    (``PartitionSpec``s in the target's structure, a ``Transformer``'s as
    its ``params()`` tree: ``train_state_shardings``), as a ``DTensor`` of
    this rank's slice on ``mesh``, whatever mesh wrote the checkpoint."""
    if shardings is not None and mesh is None:
        raise ValueError("restore_checkpoint(shardings=) needs the target mesh (mesh=)")
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = directory / f"{step:010d}"
    manifest = json.loads((path / _MANIFEST).read_text())
    with np.load(path / "shards.npz") as z:
        def leaf_array(name: str) -> np.ndarray:
            meta = manifest["leaves"].get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            return z[meta["key"]]

        state = _build(target, (), (), _cached(leaf_array), shardings, mesh)
    return state, manifest["metadata"]


def _cached(fn):
    """Read each npz member once, though a stacked leaf is split many times."""
    seen: dict[str, np.ndarray] = {}

    def get(name: str) -> np.ndarray:
        if name not in seen:
            seen[name] = fn(name)
        return seen[name]

    return get


@dataclasses.dataclass
class CheckpointManager:
    """Rolling checkpoints with keep-N retention and resume helpers."""

    directory: str | Path
    keep: int = 3
    save_every: int = 100

    def maybe_save(self, step: int, state, *, metadata: dict | None = None) -> bool:
        if step % self.save_every != 0:
            return False
        save_checkpoint(self.directory, step, state, extra_metadata=metadata)
        if not is_sharded(state) or dist.get_rank() == 0:  # the writer collects
            self._gc()
        return True

    def _gc(self):
        directory = Path(self.directory)
        for s in _complete_steps(directory)[: -self.keep]:
            shutil.rmtree(directory / f"{s:010d}", ignore_errors=True)

    def restore_latest(self, target, *, shardings=None, mesh=None):
        return restore_checkpoint(self.directory, target, shardings=shardings, mesh=mesh)
