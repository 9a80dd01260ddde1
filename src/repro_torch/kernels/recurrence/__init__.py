"""The RWKV-6 and Mamba2 recurrence scans: CUDA kernels (forward and backward),
plain versions and dispatch."""

from repro_torch.kernels.recurrence.kernel import (
    ssd_scan_bwd_cuda,
    ssd_scan_cuda,
    wkv6_scan_bwd_cuda,
    wkv6_scan_cuda,
)
from repro_torch.kernels.recurrence.ops import ssd_scan_logdec, wkv6_scan_logw
from repro_torch.kernels.recurrence.ref import ssd_scan_ref, wkv6_scan_ref

__all__ = ["ssd_scan_bwd_cuda", "ssd_scan_cuda", "ssd_scan_logdec", "ssd_scan_ref",
           "wkv6_scan_bwd_cuda", "wkv6_scan_cuda", "wkv6_scan_logw", "wkv6_scan_ref"]
