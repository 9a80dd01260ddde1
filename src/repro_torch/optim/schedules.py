"""LR schedules: multipliers of the base lr, as functions of the step (port of
``repro.optim.schedules``).  The step is a tensor (or a number); the
multiplier is a float32 tensor on its device."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine"]


def constant():
    return lambda step: torch.ones((), dtype=torch.float32, device=torch.as_tensor(step).device)


def warmup_cosine(warmup_steps: int, total_steps: int, *, min_ratio: float = 0.1):
    """Linear warm-up to 1 over ``warmup_steps``, then a cosine down to
    ``min_ratio`` at ``total_steps``, flat after it."""
    def f(step):
        step = torch.as_tensor(step).float()
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return f
