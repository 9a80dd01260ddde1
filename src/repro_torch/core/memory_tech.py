"""Copy of ``repro.core.memory_tech`` for the PyTorch port (numpy only, held
equal to the original by ``tests/test_torch_perf_model.py``).

Memory-technology specifications — paper §II/§III + Tables III & IV.

``MemoryTechSpec`` is the unifying abstraction of this repo (DESIGN.md §2):
the paper's E-SRAM and O-SRAM are two instances, and the TPU-v5e memory
system (HBM / VMEM / ICI) is a third, consumed by the same roofline engine
(repro.perf) that the paper-reproduction model (repro.core.perf_model)
uses.  Eq (1) of the paper is ``MemoryTechSpec.b_process``.

All paper constants are cited inline.  Constants the paper does NOT give
(compute power, DRAM interface energy) are derived from public part data
and marked CALIBRATED; tests/test_perf_model.py shows the reproduced
speedup/energy bands are robust to +-50% on each of them.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "MemoryTechSpec",
    "E_SRAM",
    "O_SRAM",
    "SystemConstants",
    "PAPER_SYSTEM",
    "TPU_V5E",
    "TpuSpec",
]


@dataclasses.dataclass(frozen=True)
class MemoryTechSpec:
    """One on-chip memory technology.

    frequency_hz      : native operating frequency (O-SRAM: 20 GHz, §II).
    wavelengths       : concurrent WDM wavelengths (lambda in Eq 1; 1 for electrical).
    port_width_bits   : z in Eq 1 (32-bit read/write ports, §III-A).
    ports_per_block   : physical port pairs per block (E-SRAM BRAM: 2).
    block_kbits       : capacity of one block (O-SRAM: 32 Kb = 1024 x 32b, §III-A).
    static_pj_per_bit_cycle / switching_pj_per_bit : Table III (at 500 MHz).
    area_mm2          : Table IV on-chip memory area for the 54 MB system.
    """

    name: str
    frequency_hz: float
    wavelengths: int
    port_width_bits: int
    ports_per_block: int
    block_kbits: int
    static_pj_per_bit_cycle: float
    switching_pj_per_bit: float
    area_mm2: float
    # Phased (serial tag->single-way data) cache access: affordable only
    # with large frequency headroom over the electrical mesh.  O-SRAM's
    # 40x headroom makes it free; E-SRAM at mesh frequency must read all
    # associativity ways in parallel (paper Fig. 5/6 pulls m ways at once).
    phased_access: bool = False

    def b_process(self, f_electrical: float) -> float:
        """Paper Eq (1): bits per electrical cycle one port set can deliver."""
        return self.wavelengths * self.frequency_hz * self.port_width_bits / f_electrical

    def effective_ports(self, f_electrical: float) -> float:
        """Concurrent 32-bit words per electrical cycle per block.

        O-SRAM: 1 port-pair x 5 wavelengths x (20 GHz / 500 MHz) = 200 —
        the paper's '200 parallel read-write ports' (§III-A).
        E-SRAM: 2 ports x 1 x (500 MHz / 500 MHz) = 2.
        """
        return (
            self.ports_per_block
            * self.wavelengths
            * (self.frequency_hz / f_electrical)
        )

    def block_bandwidth_bytes(self, f_electrical: float) -> float:
        """Deliverable bytes/s of one block when paired with f_electrical compute."""
        return self.effective_ports(f_electrical) * (self.port_width_bits / 8) * f_electrical


# --- Paper Table III (per-bit energies, pJ per cycle, FPGA at 500 MHz) ----
# --- Paper Table IV (areas for the 54 MB on-chip memory system) -----------
E_SRAM = MemoryTechSpec(
    name="E-SRAM",
    frequency_hz=500e6,  # electrical BRAM/URAM clocked with the fabric
    wavelengths=1,
    port_width_bits=32,
    ports_per_block=2,  # dual-port BRAM
    block_kbits=36,  # Xilinx BRAM36
    static_pj_per_bit_cycle=1.175e-6,  # Table III
    switching_pj_per_bit=4.68,  # Table III
    area_mm2=43.2,  # Table IV
)

O_SRAM = MemoryTechSpec(
    name="O-SRAM",
    frequency_hz=20e9,  # §II: operates at 20 GHz
    wavelengths=5,  # §II: typically 5 wavelengths (WDM)
    port_width_bits=32,
    ports_per_block=1,  # one waveguide pair; concurrency comes from WDM+freq
    block_kbits=32,  # §III-A: 32 Kb per O-SRAM, 1024 x 32b lines
    static_pj_per_bit_cycle=4.17e-6,  # Table III (static is HIGHER for optical)
    switching_pj_per_bit=1.04,  # Table III (4.5x lower than electrical)
    area_mm2=103.7e4,  # Table IV (wafer-scale)
    phased_access=True,
)


@dataclasses.dataclass(frozen=True)
class SystemConstants:
    """Platform constants of §V-A (Alveo-U250-class wafer-scale FPGA).

    Entries marked CALIBRATED are not specified by the paper and are derived
    from public data sheets; sensitivity is covered in tests.
    """

    f_electrical: float = 500e6  # §V-A compute mesh frequency
    onchip_bytes: int = 54 * 2**20  # §V-A: 54 MB of on-chip memory
    dram_channels: int = 4  # U250: 4 x DDR4 DIMM channels
    dram_bw_per_channel: float = 19.2e9  # DDR4-2400 peak
    dram_efficiency: float = 0.85  # CALIBRATED: DMA-streamed access derate
    dram_pj_per_byte: float = 20.0  # CALIBRATED: DDR4 device+PHY energy
    compute_power_w: float = 2.0  # CALIBRATED: 320 FMA pipelines @ 12nm/500MHz
    pe_area_mm2: float = 202.2  # Table IV
    lut_count: int = 6433_000  # §V-A
    ff_count: int = 8474_000  # §V-A
    dsp_count: int = 31_000  # §V-A

    @property
    def dram_bw(self) -> float:
        return self.dram_channels * self.dram_bw_per_channel * self.dram_efficiency


PAPER_SYSTEM = SystemConstants()


# --- TPU v5e-class record: data the model prices, not the port's card -----
@dataclasses.dataclass(frozen=True)
class TpuSpec:
    name: str = "tpu-v5e-class"
    peak_bf16_flops: float = 197e12  # per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_bw_per_link: float = 50e9  # bytes/s per link (one direction)
    ici_links: int = 4  # 2D torus: 4 links/chip (x+, x-, y+, y-)
    hbm_bytes: int = 16 * 2**30
    vmem_bytes: int = 128 * 2**20


TPU_V5E = TpuSpec()
