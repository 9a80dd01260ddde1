"""The recurrence scans over the models' layout, dispatched by device.

``wkv6_scan(r, k, v, w, u)`` and ``ssd_scan(decay, dtx, bm, cm)`` take the
layouts of ``models.rwkv`` and ``models.ssm`` (see ``kernel.py``) and return
``(B, S, H, 64)`` float32.  CUDA tensors launch the hand-written kernel,
which raises on anything it does not take; CPU tensors run the plain
per-step loop (``ref.py``).  JAX's ``scan_chunk`` changes nothing in the
forward values and is not an argument here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.recurrence.kernel import (
    check_ssd_inputs,
    check_wkv_inputs,
    ssd_scan_cuda,
    wkv6_scan_cuda,
)
from repro_torch.kernels.recurrence.ref import ssd_scan_ref, wkv6_scan_ref

__all__ = ["ssd_scan", "wkv6_scan"]


def _device_type(t: torch.Tensor, fn: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn} runs on 'cuda' or 'cpu' tensors, got {t.device}")
    return t.device.type


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
    """The WKV-6 recurrence from a zero state: y (B, S, H, 64) float32."""
    if _device_type(r, "wkv6_scan") == "cuda":
        return wkv6_scan_cuda(r, k, v, w, u)
    check_wkv_inputs(r, k, v, w, u)
    return wkv6_scan_ref(r, k, v, w, u)


def ssd_scan(decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor) -> torch.Tensor:
    """The Mamba2 state recurrence from a zero state: y (B, S, H, 64) float32."""
    if _device_type(dtx, "ssd_scan") == "cuda":
        return ssd_scan_cuda(decay, dtx, bm, cm)
    check_ssd_inputs(decay, dtx, bm, cm)
    return ssd_scan_ref(decay, dtx, bm, cm)
