"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  When no
CUDA device is present the default raises instead of quietly running on
the CPU: a CPU run must be asked for by name.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is requested but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        # One name per card, so per-device memos see "cuda" and "cuda:0" as one.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
