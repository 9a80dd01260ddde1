"""Copy of ``repro.core.perf_model`` for the PyTorch port (numpy only, held
equal to the original by ``tests/test_torch_perf_model.py``).

The paper's performance + energy model (Eqs 1-3) -> Figs 7 & 8, Tables III & IV.

Top-level API:
  * ``speedup_table()``   — per (tensor, mode) O-SRAM/E-SRAM speedup (Fig 7)
  * ``energy_table()``    — per tensor energy-savings ratio (Fig 8)
  * ``area_table()``      — Table IV
  * ``energy_constants()``— Table III passthrough (benchmarks/table3)
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.accelerator import (
    PAPER_ACCEL,
    AcceleratorConfig,
    ModeTime,
    mode_execution_time,
)
from repro_torch.core.hierarchy import fpga_hierarchy, hierarchy_energy, level_power_w
from repro_torch.core.memory_tech import (
    E_SRAM,
    O_SRAM,
    PAPER_SYSTEM,
    MemoryTechSpec,
    SystemConstants,
)
from repro_torch.data.frostt import FROSTT_TENSORS, PAPER_RANK, FrosttTensor

__all__ = [
    "ModeResult",
    "TensorEnergy",
    "run_mode",
    "total_energy",
    "speedup_table",
    "energy_table",
    "area_table",
    "energy_constants",
    "sram_power_w",
]


def sram_power_w(
    tech: MemoryTechSpec,
    *,
    active_bytes_per_cycle: float,
    system: SystemConstants = PAPER_SYSTEM,
) -> tuple[float, float]:
    """Paper Eq (3): (static_W, switching_W) for the on-chip memory system.

    Static power charges the full provisioned capacity (54 MB, §V-A);
    switching charges the actively accessed bits per electrical cycle.
    The formula itself lives in ``repro.core.hierarchy.level_power_w`` so
    every stack instance shares it.
    """
    return level_power_w(
        provisioned_bytes=system.onchip_bytes,
        static_pj_per_bit_cycle=tech.static_pj_per_bit_cycle,
        switching_pj_per_bit=tech.switching_pj_per_bit,
        active_bytes_per_cycle=active_bytes_per_cycle,
        f_clock=system.f_electrical,
    )


@dataclasses.dataclass(frozen=True)
class ModeResult:
    tensor: str
    mode: int
    t_esram: ModeTime
    t_osram: ModeTime

    @property
    def speedup(self) -> float:
        return self.t_esram.seconds / self.t_osram.seconds


def run_mode(
    tensor: FrosttTensor,
    mode: int,
    *,
    rank: int = PAPER_RANK,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
) -> ModeResult:
    t_e = mode_execution_time(tensor, mode, E_SRAM, rank=rank, accel=accel, system=system)
    t_o = mode_execution_time(tensor, mode, O_SRAM, rank=rank, accel=accel, system=system)
    return ModeResult(tensor=tensor.name, mode=mode, t_esram=t_e, t_osram=t_o)


def speedup_table(
    tensors: dict[str, FrosttTensor] | None = None,
    *,
    rank: int = PAPER_RANK,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
) -> dict[str, list[ModeResult]]:
    """Fig 7: per-mode speedup from replacing E-SRAM with O-SRAM."""
    tensors = tensors or FROSTT_TENSORS
    return {
        name: [
            run_mode(t, m, rank=rank, accel=accel, system=system)
            for m in range(t.nmodes)
        ]
        for name, t in tensors.items()
    }


@dataclasses.dataclass(frozen=True)
class TensorEnergy:
    tensor: str
    e_esram_j: float
    e_osram_j: float
    breakdown_esram: dict
    breakdown_osram: dict

    @property
    def savings(self) -> float:
        return self.e_esram_j / self.e_osram_j


def total_energy(
    tensor: FrosttTensor,
    tech: MemoryTechSpec,
    *,
    rank: int = PAPER_RANK,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    mode_times: tuple[ModeTime, ...] | None = None,
) -> tuple[float, dict]:
    """Paper Eq (2): E = P_compute*t + E_DRAM + P_SRAM*n_SRAM*t (all modes).

    Delegates to the hierarchy energy engine over the paper's 2-level FPGA
    stack (DESIGN.md §9).  ``mode_times`` lets callers
    (repro.dse.evaluator) inject per-mode execution times computed with
    memoized hit rates; when omitted they are recomputed here, which
    yields bit-identical results.
    """
    hier = fpga_hierarchy(tech, accel=accel, system=system)
    if mode_times is None:
        mode_times = tuple(
            mode_execution_time(tensor, m, tech, rank=rank, accel=accel, system=system)
            for m in range(tensor.nmodes)
        )
    total, breakdown = hierarchy_energy(hier, tensor, mode_times)
    assert total is not None
    return total, breakdown


def energy_table(
    tensors: dict[str, FrosttTensor] | None = None,
    *,
    rank: int = PAPER_RANK,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
) -> dict[str, TensorEnergy]:
    """Fig 8: energy savings of the O-SRAM FPGA over the E-SRAM FPGA."""
    tensors = tensors or FROSTT_TENSORS
    out = {}
    for name, t in tensors.items():
        e_e, brk_e = total_energy(t, E_SRAM, rank=rank, accel=accel, system=system)
        e_o, brk_o = total_energy(t, O_SRAM, rank=rank, accel=accel, system=system)
        out[name] = TensorEnergy(
            tensor=name,
            e_esram_j=e_e,
            e_osram_j=e_o,
            breakdown_esram=brk_e,
            breakdown_osram=brk_o,
        )
    return out


def area_table(system: SystemConstants = PAPER_SYSTEM) -> dict[str, dict[str, float]]:
    """Table IV (mm^2)."""
    return {
        "E-SRAM system": {
            "on_chip_memory": E_SRAM.area_mm2,
            "pes": system.pe_area_mm2,
            "total": E_SRAM.area_mm2 + system.pe_area_mm2,
        },
        "O-SRAM system": {
            "on_chip_memory": O_SRAM.area_mm2,
            "pes": system.pe_area_mm2,
            "total": O_SRAM.area_mm2 + system.pe_area_mm2,
        },
    }


def energy_constants() -> dict[str, dict[str, float]]:
    """Table III (pJ/cycle per bit at 500 MHz)."""
    return {
        "static": {
            "electrical": E_SRAM.static_pj_per_bit_cycle,
            "optical": O_SRAM.static_pj_per_bit_cycle,
        },
        "switching": {
            "electrical": E_SRAM.switching_pj_per_bit,
            "optical": O_SRAM.switching_pj_per_bit,
        },
    }
