"""Sweepable design-space axes over the paper's configuration dataclasses.

Copy of ``repro.dse.sweep`` for the PyTorch port (numpy, held equal to
the original by ``tests/test_torch_dse.py``).

A ``SweepSpec`` is a grid (cartesian product) of parameter overrides
applied on top of a base configuration (``MemoryTechSpec``/``TpuSpec`` +
``AcceleratorConfig``/``CacheConfig`` + ``SystemConstants`` + rank).  Each
grid cell materializes as a frozen ``SweepPoint`` — a fully-resolved
configuration the evaluator can price (DESIGN.md §8).

Axes are named in ``SWEEP_AXES``; each maps to a (layer, field) pair and
is applied with ``dataclasses.replace`` so the base specs stay immutable.
The paper's own E-SRAM/O-SRAM comparison is the trivial two-point sweep
returned by ``paper_pair``.

Hierarchy levels are sweepable too (DESIGN.md §9): ``level_axis_points``
varies one field of one ``MemoryLevel`` (cache depth ×, HBM bandwidth ×),
and ``add_level_point``/``drop_level_point`` produce structural variants
(insert or remove a level) as explicit sweep points.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Mapping, Sequence

from repro_torch.core.accelerator import PAPER_ACCEL, AcceleratorConfig
from repro_torch.core.hierarchy import (
    MemoryHierarchy,
    MemoryLevel,
    PhotonicImcSpec,
    resolve_hierarchy,
)
from repro_torch.core.memory_tech import (
    E_SRAM,
    O_SRAM,
    PAPER_SYSTEM,
    MemoryTechSpec,
    SystemConstants,
    TpuSpec,
)
from repro_torch.data.frostt import PAPER_RANK
from repro_torch.model.controller import POLICIES, ControllerConfig, paper_controller
from repro_torch.reorder import ORDERINGS

__all__ = [
    "SWEEP_AXES",
    "DEFAULT_AXIS_VALUES",
    "SweepPoint",
    "SweepSpec",
    "paper_pair",
    "tech_comparison",
    "level_axis_points",
    "add_level_point",
    "drop_level_point",
]

# axis name -> (layer, dataclass field).  Layers: "tech" (MemoryTechSpec),
# "tpu" (TpuSpec), "cache" (AcceleratorConfig.cache), "accel"
# (AcceleratorConfig), "system" (SystemConstants), "controller"
# (repro_torch.model.ControllerConfig — prices points through the cycle-level
# simulator, DESIGN.md §14), "run" (evaluation parameters, i.e. rank).
SWEEP_AXES: dict[str, tuple[str, str]] = {
    "frequency": ("tech", "frequency_hz"),
    "wavelengths": ("tech", "wavelengths"),
    "port_width": ("tech", "port_width_bits"),
    "ports_per_block": ("tech", "ports_per_block"),
    "cache_lines": ("cache", "num_lines"),
    "line_bytes": ("cache", "line_bytes"),
    "associativity": ("cache", "associativity"),
    "n_caches": ("accel", "n_caches"),
    "n_pe": ("accel", "n_pe"),
    "pipelines": ("accel", "pipelines_per_pe"),
    "dram_channels": ("system", "dram_channels"),
    "f_electrical": ("system", "f_electrical"),
    "rank": ("run", "rank"),
    # Nonzero execution-order strategy (repro_torch.reorder, DESIGN.md §10).
    # Only the exact-trace hit-rate method can see it — Che's IRM is
    # order-blind — so sweep it with hit_rate_method="trace"/"auto".
    "ordering": ("run", "ordering"),
    # TPU-v5e-class memory-system axes (base_tech must be a TpuSpec).
    "hbm_bw": ("tpu", "hbm_bw"),
    "vmem_bytes": ("tpu", "vmem_bytes"),
    "peak_flops": ("tpu", "peak_bf16_flops"),
    # Memory-controller axes (repro_torch.model.controller, DESIGN.md §14).
    # Naming any of these switches the point to cycle-level pricing: the
    # evaluator replays the exact request trace through the banked event
    # loop instead of the closed-form Eq-1 rates, so these require the
    # exact-trace path (an executable tensor + an fpga-family base).
    "n_banks": ("controller", "n_banks"),
    "bank_policy": ("controller", "bank_conflict_policy"),
    "prefetch_depth": ("controller", "prefetch_depth"),
    "reorder_buffer": ("controller", "reorder_buffer_depth"),
}

# Default value grids used by benchmarks/dse_sweep.py when the caller
# names an axis without giving explicit values.  Base-point values are
# included so every sweep contains the paper configuration itself.
DEFAULT_AXIS_VALUES: dict[str, tuple[Any, ...]] = {
    "frequency": (1e9, 5e9, 10e9, 20e9, 40e9),
    "wavelengths": (1, 2, 4, 5, 8, 16),
    "port_width": (16, 32, 64),
    "ports_per_block": (1, 2, 4),
    "cache_lines": (1024, 2048, 4096, 8192, 16384),
    "line_bytes": (32, 64, 128),
    "associativity": (1, 2, 4, 8),
    "n_caches": (1, 3, 6),
    "n_pe": (2, 4, 8),
    "pipelines": (40, 80, 160),
    "dram_channels": (2, 4, 8),
    "f_electrical": (250e6, 500e6, 1e9),
    "rank": (8, 16, 32),
    "ordering": ORDERINGS,
    "hbm_bw": (409.5e9, 819e9, 1638e9),
    "vmem_bytes": (64 * 2**20, 128 * 2**20, 256 * 2**20),
    "peak_flops": (98.5e12, 197e12, 394e12),
    "n_banks": (1, 4, 12, 24),
    "bank_policy": POLICIES,
    "prefetch_depth": (0, 1, 2, 4),
    "reorder_buffer": (1, 8, 32, 128),
}


def _fmt_value(v: Any) -> str:
    if isinstance(v, float) and v >= 1e6:
        return f"{v/1e9:g}GHz" if v >= 1e9 else f"{v/1e6:g}MHz"
    return f"{v:g}" if isinstance(v, float) else str(v)


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One fully-resolved configuration of the design space.

    ``tech`` is anything ``repro_torch.core.hierarchy.resolve_hierarchy``
    accepts: a ``MemoryTechSpec`` (FPGA memory technologies), a
    ``TpuSpec``, a ``PhotonicImcSpec``, or an explicit
    ``MemoryHierarchy``.  The evaluator prices every point through the
    same multi-level engine — there is no per-technology dispatch.
    """

    label: str
    tech: MemoryTechSpec | TpuSpec | PhotonicImcSpec | MemoryHierarchy
    accel: AcceleratorConfig = PAPER_ACCEL
    system: SystemConstants = PAPER_SYSTEM
    rank: int = PAPER_RANK
    # Nonzero execution-order strategy (repro_torch.reorder, DESIGN.md §10);
    # consumed by the evaluator's trace hit-rate method.
    ordering: str = "lex"
    # When set, the evaluator prices this point through the cycle-level
    # controller simulator (repro_torch.model.controller, DESIGN.md §14)
    # instead of the closed-form Eq-1 engine.  Needs an executable
    # tensor and an fpga-family hierarchy.
    controller: ControllerConfig | None = None
    overrides: tuple[tuple[str, Any], ...] = ()

    def hierarchy(self) -> MemoryHierarchy:
        return resolve_hierarchy(self.tech, accel=self.accel, system=self.system)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Grid of overrides over a base configuration.

    ``axes`` maps axis names (keys of ``SWEEP_AXES``) to value sequences;
    ``points()`` yields the cartesian product.  Axis order follows the
    mapping's insertion order, so the first axis varies slowest.
    """

    axes: Mapping[str, Sequence[Any]]
    base_tech: MemoryTechSpec | TpuSpec = O_SRAM
    base_accel: AcceleratorConfig = PAPER_ACCEL
    base_system: SystemConstants = PAPER_SYSTEM
    rank: int = PAPER_RANK
    ordering: str = "lex"

    def __post_init__(self):
        unknown = [a for a in self.axes if a not in SWEEP_AXES]
        if unknown:
            raise ValueError(
                f"unknown sweep axes {unknown}; known: {sorted(SWEEP_AXES)}"
            )
        for axis in self.axes:
            layer, _ = SWEEP_AXES[axis]
            # Accel/cache/system layers only exist in the FPGA stack; a
            # TpuSpec base would silently ignore them (tpu_hierarchy reads
            # neither), so reject anything but "run" for non-FPGA bases.
            if layer != "run" and not isinstance(self.base_tech, MemoryTechSpec):
                if layer != "tpu":
                    raise ValueError(
                        f"axis {axis!r} ({layer} layer) does not affect a "
                        f"{type(self.base_tech).__name__} base"
                    )
            if layer == "tpu" and not isinstance(self.base_tech, TpuSpec):
                raise ValueError(
                    f"axis {axis!r} needs a TpuSpec base, got "
                    f"{type(self.base_tech).__name__}"
                )
        bad = [
            v
            for v in tuple(self.axes.get("ordering", ())) + (self.ordering,)
            if v not in ORDERINGS
        ]
        if bad:
            raise ValueError(
                f"unknown ordering strategies {bad}; known: {list(ORDERINGS)}"
            )
        bad_pol = [
            v for v in self.axes.get("bank_policy", ()) if v not in POLICIES
        ]
        if bad_pol:
            raise ValueError(
                f"unknown bank policies {bad_pol}; known: {list(POLICIES)}"
            )

    def num_points(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def points(self) -> list[SweepPoint]:
        names = list(self.axes)
        out = []
        for combo in itertools.product(*(self.axes[a] for a in names)):
            overrides = tuple(zip(names, combo))
            tech, accel, system, rank, ordering, controller = self._apply(overrides)
            label = f"{self.base_tech.name}[" + ",".join(
                f"{a}={_fmt_value(v)}" for a, v in overrides
            ) + "]"
            out.append(
                SweepPoint(
                    label=label,
                    tech=tech,
                    accel=accel,
                    system=system,
                    rank=rank,
                    ordering=ordering,
                    controller=controller,
                    overrides=overrides,
                )
            )
        return out

    def _apply(
        self, overrides: tuple[tuple[str, Any], ...]
    ) -> tuple[
        MemoryTechSpec | TpuSpec,
        AcceleratorConfig,
        SystemConstants,
        int,
        str,
        ControllerConfig | None,
    ]:
        tech_kw: dict[str, Any] = {}
        cache_kw: dict[str, Any] = {}
        accel_kw: dict[str, Any] = {}
        system_kw: dict[str, Any] = {}
        ctrl_kw: dict[str, Any] = {}
        rank = self.rank
        ordering = self.ordering
        for axis, value in overrides:
            layer, field = SWEEP_AXES[axis]
            if layer in ("tech", "tpu"):
                tech_kw[field] = value
            elif layer == "cache":
                cache_kw[field] = value
            elif layer == "accel":
                accel_kw[field] = value
            elif layer == "system":
                system_kw[field] = value
            elif layer == "controller":
                ctrl_kw[field] = value
            elif field == "ordering":  # run layer
                ordering = str(value)
            else:  # run: rank
                rank = int(value)
        tech = dataclasses.replace(self.base_tech, **tech_kw) if tech_kw else self.base_tech
        accel = self.base_accel
        if cache_kw:
            accel_kw["cache"] = dataclasses.replace(accel.cache, **cache_kw)
        if accel_kw:
            accel = dataclasses.replace(accel, **accel_kw)
        system = (
            dataclasses.replace(self.base_system, **system_kw)
            if system_kw
            else self.base_system
        )
        # Controller axes start from the paper controller of the point's
        # (possibly accel-overridden) configuration, so e.g. sweeping
        # prefetch_depth alone keeps n_banks = n_pe * n_caches.
        controller = (
            dataclasses.replace(paper_controller(accel), **ctrl_kw)
            if ctrl_kw
            else None
        )
        return tech, accel, system, rank, ordering, controller


def paper_pair(
    *,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    rank: int = PAPER_RANK,
) -> list[SweepPoint]:
    """The paper's E-SRAM/O-SRAM comparison as the trivial 2-point sweep."""
    return [
        SweepPoint(label=E_SRAM.name, tech=E_SRAM, accel=accel, system=system, rank=rank),
        SweepPoint(label=O_SRAM.name, tech=O_SRAM, accel=accel, system=system, rank=rank),
    ]


def tech_comparison(
    techs: Sequence[MemoryTechSpec | TpuSpec | PhotonicImcSpec | MemoryHierarchy],
    *,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    rank: int = PAPER_RANK,
) -> list[SweepPoint]:
    """A list-sweep over arbitrary technology specs (any hierarchy kind)."""
    return [
        SweepPoint(label=t.name, tech=t, accel=accel, system=system, rank=rank)
        for t in techs
    ]


# --------------------------------------------------------------------------
# Hierarchy-level axes (DESIGN.md §9)
# --------------------------------------------------------------------------


def level_axis_points(
    base: MemoryHierarchy,
    *,
    level: str,
    field: str,
    values: Sequence[Any],
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    rank: int = PAPER_RANK,
) -> list[SweepPoint]:
    """Sweep one field of one hierarchy level (e.g. HBM bandwidth x2,
    VMEM capacity x4) as explicit sweep points over a base stack."""
    out = []
    for v in values:
        hier = base.replace_level(level, **{field: v})
        out.append(
            SweepPoint(
                label=f"{base.name}[{level}.{field}={_fmt_value(v)}]",
                tech=hier,
                accel=accel,
                system=system,
                rank=rank,
                overrides=((f"{level}.{field}", v),),
            )
        )
    return out


def add_level_point(
    base: MemoryHierarchy,
    level: MemoryLevel,
    index: int,
    *,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    rank: int = PAPER_RANK,
) -> SweepPoint:
    """A sweep point with an extra level inserted at ``index``."""
    hier = base.with_level(level, index)
    return SweepPoint(
        label=f"{base.name}[+{level.name}]",
        tech=hier,
        accel=accel,
        system=system,
        rank=rank,
        overrides=(("add_level", level.name),),
    )


def drop_level_point(
    base: MemoryHierarchy,
    level_name: str,
    *,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    rank: int = PAPER_RANK,
) -> SweepPoint:
    """A sweep point with one level removed from the stack."""
    hier = base.without_level(level_name)
    return SweepPoint(
        label=f"{base.name}[-{level_name}]",
        tech=hier,
        accel=accel,
        system=system,
        rank=rank,
        overrides=(("drop_level", level_name),),
    )
