"""Port of ``repro.perf.roofline``: the three-term roofline of a dry-run
cell, priced at the H100's peaks, and the analytic MTTKRP model.

    compute term    = flops a rank / the card's dense bf16 peak
    memory term     = bytes a rank / the card's HBM rate
    collective term = ring bytes a rank / one link's rate

JAX's cells read XLA's compiled HLO; the port's read ``perf.op_cost``'s
count of the ATen ops one rank's eager step dispatches, and the
collectives its sharded step issues (``perf.coll_stats``).  Every term is
priced at ``H100_SXM``, never at ``TPU_V5E``.  The collective term divides
by the one NVLink rate, as JAX's divides by ``ici_bw_per_link``: that is
the rate between two cards of one 8-card node, and optimistic for groups
that span nodes (the production meshes' 256 and 512 ranks do).

``mttkrp_tpu_roofline`` prices one spMTTKRP mode on the ``TPU_V5E``
record's memory system (VMEM as the factor-row cache, HBM as the
streaming store) with the paper's traffic model, so that a TPU-v5e-class
chip can stand as a third memory technology beside E-SRAM and O-SRAM.  It
is a model of that record, not a measurement of any card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hierarchy import (
    TpuModeTime,
    hierarchy_mode_time,
    tpu_hierarchy,
)
from repro_torch.core.memory_tech import TPU_V5E, TpuSpec
from repro_torch.data.frostt import FrosttTensor
from repro_torch.perf.coll_stats import CollectiveStats

__all__ = ["CardSpec", "H100_SXM", "RooflineCell", "TpuModeTime", "model_flops_for",
           "mttkrp_tpu_roofline", "roofline_from_stats"]


@dataclasses.dataclass(frozen=True)
class CardSpec:
    """One card's peaks, each with its source."""

    name: str
    peak_bf16_flops: float  # dense, on the tensor cores
    hbm_bw: float  # bytes/s
    hbm_bytes: float  # device memory
    link_bw: float  # bytes/s one direction, card to card
    sources: tuple[str, ...] = ()


H100_SXM = CardSpec(
    name="NVIDIA H100 SXM5 80GB",
    peak_bf16_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    link_bw=450e9,
    sources=(
        "peak_bf16_flops: NVIDIA H100 data sheet, SXM, BF16 Tensor Core 1979 TFLOPS with "
        "sparsity, half of it dense",
        "hbm_bw: the same data sheet, SXM, GPU memory bandwidth 3.35 TB/s",
        "hbm_bytes: the same data sheet, SXM, GPU memory 80 GB",
        "link_bw: the same data sheet, SXM, NVLink 900 GB/s, half of it a direction",
    ),
)


@dataclasses.dataclass
class RooflineCell:
    """One dry-run cell.  The field names are JAX's: ``hlo_flops`` and
    ``hlo_bytes`` hold the port's op count a rank (``perf.op_cost``),
    ``ici_bytes_per_chip`` its ring bytes a rank."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # a rank's flops
    hlo_bytes: float  # a rank's bytes read and written
    collective_bytes: float  # result bytes of the rank's collectives
    ici_bytes_per_chip: float
    model_flops: float  # 6*N*D (dense) / 6*N_active*D (MoE), global
    peak_bytes_per_chip: float = 0.0  # modelled peak of live bytes a rank

    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self, hw: CardSpec = H100_SXM) -> "RooflineCell":
        self.compute_s = self.hlo_flops / hw.peak_bf16_flops
        self.memory_s = self.hlo_bytes / hw.hbm_bw
        self.collective_s = self.ici_bytes_per_chip / hw.link_bw
        return self

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time (perfect overlap = max of terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops (global): remat and redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-optimistic step time."""
        denom = self.step_time_s * self.chips * H100_SXM.peak_bf16_flops
        return self.model_flops / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_roofline": self.mfu,
            "hbm_gb_per_chip": self.peak_bytes_per_chip / 2**30,
            "card": H100_SXM.name,
        }


def mttkrp_tpu_roofline(
    tensor: FrosttTensor,
    mode: int,
    *,
    rank: int = 16,
    hw: TpuSpec = TPU_V5E,
) -> TpuModeTime:
    """Price one spMTTKRP mode on a TPU-class record with the paper's
    traffic model: the ``tpu_hierarchy`` instance of the paper's 2-level
    stack (VMEM as the factor-row cache, its capacity split across the N-1
    input factors with Che/LRU reuse; HBM as the backing store; peak FLOP/s
    as the PE mesh), priced by the seconds-domain roofline engine."""
    mt = hierarchy_mode_time(tpu_hierarchy(hw), tensor, mode, rank=rank)
    if not isinstance(mt, TpuModeTime):
        raise TypeError(f"the TPU hierarchy priced as {type(mt).__name__}, not TpuModeTime")
    return mt


def model_flops_for(cfg, shape_spec) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference; N = active params."""
    n = cfg.active_param_count()
    if shape_spec.kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n * tokens
    if shape_spec.kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape_spec.global_batch


def roofline_from_stats(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    coll: CollectiveStats,
    model_flops: float,
    peak_bytes: float = 0.0,
) -> RooflineCell:
    """A cell from a rank's ``{"flops", "bytes accessed"}`` and its
    collectives, priced at ``H100_SXM``."""
    cell = RooflineCell(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        collective_bytes=coll.total_result_bytes,
        ici_bytes_per_chip=coll.ici_bytes_per_chip,
        model_flops=model_flops,
        peak_bytes_per_chip=peak_bytes,
    )
    return cell.finalize()
