"""Input shapes of the LM family (copy of ``repro.configs.shapes``)."""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg) -> dict[str, "ShapeSpec | str"]:
    """{shape_name: ShapeSpec or skip-reason string} for one architecture."""
    out: dict[str, object] = {}
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            out[name] = "SKIP: pure full-attention arch; long_500k requires sub-quadratic attention"
        else:
            out[name] = spec
    return out
