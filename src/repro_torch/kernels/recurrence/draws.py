"""Input draws for holding the recurrence kernels against their plain loops.

One definition of the cases both ``chip_smoke.py`` (phase 17 (a)) and
``tests/test_torch_recurrence_cuda.py`` draw, on any device, from a seed:

- ``wkv_inputs``: r, k, v, w (B, S, H, 64) and u (H, 64);
- ``ssd_inputs``: decay (B, S, H), dtx (B, S, H, 64), b and c (B, S, 64).

``strided`` makes the tensors column slices of one fused projection (the
models' views); ``misaligned`` makes them such slices starting one float
into the projection, so no base is on 16 bytes.  ``decay`` picks the regime
(``DECAYS``): "model" draws as the models do, "strong" puts exact zeros
among ~1e-60s (w = exp(-exp(x)) with x up to 5; a Mamba decay of 0),
"unit" decays nothing, "spike" puts one near-zero decay in a run of mild
ones.
"""

from __future__ import annotations

import torch

__all__ = ["DECAYS", "decays", "ssd_inputs", "wkv_inputs"]

DECAYS = ("model", "strong", "unit", "spike")


def decays(kind: str, x: torch.Tensor, decay: str) -> torch.Tensor:
    """WKV-6's w (``kind`` "wkv6", from normal x) or the SSD decay (from
    uniform x in [0, 1)) in one of ``DECAYS``."""
    if decay not in DECAYS:
        raise ValueError(f"decay must be one of {DECAYS}; got {decay!r}")
    if decay == "unit":
        return torch.ones_like(x)
    if decay == "spike":
        out = torch.full_like(x, 0.97)
        out[:, x.shape[1] // 3] = 1e-30
        return out
    if kind == "wkv6":
        if decay == "strong":
            return torch.exp(-torch.exp(x.clamp(max=2.0) * 2.5))  # x up to 5: some exactly 0
        return torch.exp(-torch.exp(x.clamp(max=0.5) - 3.0))
    if decay == "strong":
        return torch.where(x > 0.8, torch.zeros_like(x), torch.exp(-60.0 * x))
    return torch.exp(-2.0 * x)


def wkv_inputs(b: int, s: int, h: int, dev, *, strided: bool, seed: int, decay: str = "model",
               misaligned: bool = False):
    """r, k, v, w (B, S, H, 64) and u (H, 64), float32 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    off = 1 if misaligned else 0
    if strided or misaligned:  # r, k, v, w as column slices of one fused projection
        fused = torch.randn((b, s, 4 * h * 64 + 32 + off), generator=gen, device=dev)
        r, k, v, w = (fused[..., off + i * h * 64:off + (i + 1) * h * 64].view(b, s, h, 64)
                      for i in range(4))
    else:
        r, k, v, w = (torch.randn((b, s, h, 64), generator=gen, device=dev) for _ in range(4))
    w = decays("wkv6", w, decay)
    u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
    return r, k, v, w, u


def ssd_inputs(b: int, s: int, h: int, dev, *, strided: bool, seed: int, decay: str = "model",
               misaligned: bool = False):
    """decay (B, S, H), dtx (B, S, H, 64), b and c (B, S, 64), float32 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    off = 1 if misaligned else 0
    if strided or misaligned:  # dtx, b, c as slices of one conv output
        conv = torch.randn((b, s, h * 64 + 2 * 64 + off), generator=gen, device=dev)
        dtx = conv[..., off:off + h * 64].view(b, s, h, 64)
        bm, cm = conv[..., off + h * 64:off + h * 64 + 64], conv[..., off + h * 64 + 64:]
    else:
        dtx = torch.randn((b, s, h, 64), generator=gen, device=dev)
        bm, cm = (torch.randn((b, s, 64), generator=gen, device=dev) for _ in range(2))
    dec = decays("ssd", torch.rand((b, s, h), generator=gen, device=dev), decay)
    return dec, dtx, bm, cm
