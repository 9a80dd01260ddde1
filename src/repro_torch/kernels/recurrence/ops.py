"""The recurrence scans over the models' layout, dispatched by device.

``wkv6_scan_logw(r, k, v, log_w, u)`` and ``ssd_scan_logdec(log_decay,
dtx, bm, cm)`` take the layouts of ``models.rwkv`` and ``models.ssm`` (see
``kernel.py``) with the decays given by their logs, and return ``(B, S, H,
64)`` float32, differentiable in every input.  Each forms the decay as
``exp(log)``, as the models computed it, so the forward values are the
same; its gradient is taken in the log, where it needs no division by a
decay (a decay of exactly 0 gives a gradient of 0, as JAX's chain rule
through ``exp`` does).  CUDA tensors launch the hand-written kernels, which
raise on anything they do not take: the forward kernel alone, or, where a
gradient is wanted, an ``autograd.Function`` pairing it with its backward
kernel.  ``meta`` tensors take the same route to the kernels' custom ops,
whose fake implementations give the shapes and whose flop formulas the dry
run reads (``kernel.py``).  CPU tensors run the plain per-step loop
(``ref.py``), which autograd differentiates.  JAX's ``scan_chunk`` changes
nothing in the forward values and is not an argument here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.recurrence.kernel import (
    check_ssd_inputs,
    check_wkv_inputs,
    ssd_scan_bwd_cuda,
    ssd_scan_cuda,
    wkv6_scan_bwd_cuda,
    wkv6_scan_cuda,
)
from repro_torch.kernels.recurrence.ref import ssd_scan_ref, wkv6_scan_ref

__all__ = ["ssd_scan_logdec", "wkv6_scan_logw"]


def _device_type(t: torch.Tensor, fn: str) -> str:
    if t.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"{fn} runs on 'cuda', 'meta' or 'cpu' tensors, got {t.device}")
    return t.device.type


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Wkv6Scan(torch.autograd.Function):
    """The WKV-6 kernel and its backward kernel, over log w."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u):
        w = torch.exp(log_w)
        ctx.save_for_backward(r, k, v, w, u)
        return wkv6_scan_cuda(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy):
        return wkv6_scan_bwd_cuda(*ctx.saved_tensors, dy.float().contiguous())


class _SsdScan(torch.autograd.Function):
    """The SSD kernel and its backward kernel, over log decay; the per-head
    gradients of the shared bm and cm summed over the heads."""

    @staticmethod
    def forward(ctx, log_decay, dtx, bm, cm):
        decay = torch.exp(log_decay)
        ctx.save_for_backward(decay, dtx, bm, cm)
        return ssd_scan_cuda(decay, dtx, bm, cm)

    @staticmethod
    def backward(ctx, dy):
        dlog, ddtx, dbm_h, dcm_h = ssd_scan_bwd_cuda(*ctx.saved_tensors,
                                                     dy.float().contiguous())
        return dlog, ddtx, dbm_h.sum(2), dcm_h.sum(2)


def wkv6_scan_logw(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """The WKV-6 recurrence from a zero state with w = exp(log_w): y (B, S,
    H, 64) float32, differentiable in r, k, v, log_w and u."""
    dev = _device_type(r, "wkv6_scan_logw")
    if dev != "cpu":
        if _needs_grad(r, k, v, log_w, u):
            return _Wkv6Scan.apply(r, k, v, log_w, u)
        return wkv6_scan_cuda(r, k, v, torch.exp(log_w), u)
    w = torch.exp(log_w)
    check_wkv_inputs(r, k, v, w, u)
    return wkv6_scan_ref(r, k, v, w, u)


def ssd_scan_logdec(log_decay: torch.Tensor, dtx: torch.Tensor, bm: torch.Tensor,
                    cm: torch.Tensor) -> torch.Tensor:
    """The Mamba2 state recurrence from a zero state with decay =
    exp(log_decay): y (B, S, H, 64) float32, differentiable in every input."""
    dev = _device_type(dtx, "ssd_scan_logdec")
    if dev != "cpu":
        if _needs_grad(log_decay, dtx, bm, cm):
            return _SsdScan.apply(log_decay, dtx, bm, cm)
        return ssd_scan_cuda(torch.exp(log_decay), dtx, bm, cm)
    decay = torch.exp(log_decay)
    check_ssd_inputs(decay, dtx, bm, cm)
    return ssd_scan_ref(decay, dtx, bm, cm)
