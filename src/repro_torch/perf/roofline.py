"""The analytic part of ``repro.perf.roofline``, copied for the PyTorch port.

``mttkrp_tpu_roofline`` prices one spMTTKRP mode on the ``TPU_V5E``
record's memory system (VMEM as the factor-row cache, HBM as the
streaming store) with the paper's traffic model, so that a TPU-v5e-class
chip can stand as a third memory technology beside E-SRAM and O-SRAM.  It
is a model of that record, not a measurement of any card.  The HLO cells
of the original (``RooflineCell``, ``roofline_from_stats``,
``model_flops_for``) read compiled-program statistics and are not ported.
"""

from __future__ import annotations

from repro_torch.core.hierarchy import (
    TpuModeTime,
    hierarchy_mode_time,
    tpu_hierarchy,
)
from repro_torch.core.memory_tech import TPU_V5E, TpuSpec
from repro_torch.data.frostt import FrosttTensor

__all__ = ["TpuModeTime", "mttkrp_tpu_roofline"]


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
