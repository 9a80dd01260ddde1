"""Copy of ``repro.core.accelerator`` for the PyTorch port (numpy only, held
equal to the original by ``tests/test_torch_perf_model.py``).

spMTTKRP accelerator configuration (paper §IV, Table I).

The per-mode execution-time model lives in ``repro.core.hierarchy``
(DESIGN.md §3): the paper's accelerator is priced as the 2-level
``fpga_hierarchy`` instance — cache subsystem over DDR4 — by the generic
multi-level engine.  ``mode_execution_time`` here is the historical entry
point, kept as a thin adapter; ``ModeTime``, ``split_capacity_hit_rates``
and ``dram_traffic_per_nnz`` re-export from the hierarchy module so the
formula cannot drift between technologies (DESIGN.md §2).

Speedup(O/E) per mode reproduces Fig. 7's 1.1x-2.9x band: cache-bound
tensors (NELL-2, PATENTS) accelerate, DRAM-bound ones (NELL-1, DELICIOUS)
do not — the paper's headline qualitative result.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.cache_sim import CacheConfig
from repro_torch.core.hierarchy import (
    ModeTime,
    dram_traffic_per_nnz,
    fpga_hierarchy,
    hierarchy_mode_time,
    split_capacity_hit_rates,
)
from repro_torch.core.memory_tech import (
    PAPER_SYSTEM,
    MemoryTechSpec,
    SystemConstants,
)
from repro_torch.data.frostt import FrosttTensor

__all__ = [
    "AcceleratorConfig",
    "ModeTime",
    "split_capacity_hit_rates",
    "input_hit_rates",
    "dram_traffic_per_nnz",
    "mode_execution_time",
    "PAPER_ACCEL",
]


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Paper Table I."""

    n_pe: int = 4  # Number of PEs (= number of DRAM channels)
    pipelines_per_pe: int = 80  # Parallel pipelines
    psum_buffer_elems: int = 1024  # Partial Matrix Buffer size
    n_caches: int = 3  # Cache subsystem: number of caches
    cache: CacheConfig = CacheConfig(num_lines=4096, line_bytes=64, associativity=4)
    n_dma: int = 6  # DMA buffers
    dma_buffer_bytes: int = 64 * 1024
    value_bytes: int = 4
    index_bytes: int = 4
    # E-SRAM cache request occupancy in electrical cycles: a 64 B line
    # through banked BRAM ports (CALIBRATED: 3 cycles/request base) plus a
    # miss penalty (tag re-probe + fill, dual-pipeline partially overlapped).
    base_request_occupancy: float = 3.5
    miss_occupancy: float = 5.0
    tag_bits: int = 32
    lru_bits: int = 64

    def onchip_bytes_used(self, rank: int) -> int:
        """Total on-chip memory the design instantiates (for Eq 2/3 energy)."""
        cache_total = self.n_caches * self.cache.capacity_bytes
        tag_total = self.n_caches * self.cache.num_lines * 8  # tag+LRU+state
        psum = self.pipelines_per_pe * self.psum_buffer_elems * self.value_bytes
        dma = self.n_dma * self.dma_buffer_bytes
        return self.n_pe * (cache_total + tag_total + psum + dma)


PAPER_ACCEL = AcceleratorConfig()


def input_hit_rates(
    tensor: FrosttTensor, mode: int, accel: AcceleratorConfig, rank: int
) -> tuple[float, ...]:
    """Hit rate per non-output factor via Che/LRU (full-size analytical path).

    The result depends only on the cache geometry (n_caches x capacity),
    the tensor and the rank — NOT on the memory technology — which is what
    makes it memoizable across sweep points (repro.dse.evaluator,
    DESIGN.md §8).
    """
    return split_capacity_hit_rates(
        tensor,
        mode,
        capacity_bytes=accel.n_caches * accel.cache.capacity_bytes,
        rank=rank,
    )


def mode_execution_time(
    tensor: FrosttTensor,
    mode: int,
    tech: MemoryTechSpec,
    *,
    rank: int = 16,
    accel: AcceleratorConfig = PAPER_ACCEL,
    system: SystemConstants = PAPER_SYSTEM,
    hit_rates: tuple[float, ...] | None = None,
) -> ModeTime:
    """Price one (tensor, mode, technology) cell via the memory hierarchy.

    Builds the paper's 2-level FPGA stack for ``tech`` and hands it to the
    generic engine; bit-identical to the historical flat model
    (tests/test_hierarchy.py pins this against golden fixtures).
    """
    hier = fpga_hierarchy(tech, accel=accel, system=system)
    mt = hierarchy_mode_time(hier, tensor, mode, rank=rank, hit_rates=hit_rates)
    assert isinstance(mt, ModeTime)
    return mt
