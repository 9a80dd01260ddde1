"""Global parallelism-layout policy (port of ``repro.distributed.layout``).

"2d"      — batch over (pod, data); TP/EP over model (default).
"dp_only" — batch over ALL mesh axes; weights FSDP-sharded over all axes,
            no tensor parallelism.

The policy is consulted by the sharding rules (``distributed.sharding``)
and by the sharded train step's choice of data group, through a
module-level setting scoped by ``layout_scope``, as in the JAX package,
whose in-model sharding constraints could not take it as an argument.
"""

from __future__ import annotations

import contextlib

__all__ = ["batch_axis_tries", "get_layout", "layout_scope", "pick_layout", "set_layout"]

_LAYOUT = "2d"


def get_layout() -> str:
    return _LAYOUT


def set_layout(layout: str) -> None:
    global _LAYOUT
    if layout not in ("2d", "dp_only"):
        raise ValueError(f"layout {layout!r}: use '2d' or 'dp_only'")
    _LAYOUT = layout


@contextlib.contextmanager
def layout_scope(layout: str):
    prev = get_layout()
    set_layout(layout)
    try:
        yield
    finally:
        set_layout(prev)


def pick_layout(cfg, kind: str, *, dp_threshold: float = 0.0) -> str:
    """Policy: 2D everywhere; ``dp_only`` for a train run of a model with
    fewer than ``dp_threshold`` parameters (JAX's rule, kept selectable)."""
    if kind == "train" and cfg.param_count() < dp_threshold:
        return "dp_only"
    return "2d"


def batch_axis_tries(ndim_batch_first: bool = True) -> list[tuple[str, ...]]:
    """Candidate mesh-axis tuples for the batch dim, best first."""
    if get_layout() == "dp_only":
        return [("pod", "data", "model"), ("data", "model"), ("pod", "data"), ("data",)]
    return [("pod", "data"), ("data",)]
