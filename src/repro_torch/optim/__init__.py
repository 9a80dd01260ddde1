"""Optimisers, schedules and gradient compression (port of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, global_norm, init_adamw_state
from repro_torch.optim.grad_compress import Int8ErrorFeedback, dequantize_int8, quantize_int8
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = ["AdamW", "Int8ErrorFeedback", "constant", "dequantize_int8", "global_norm",
           "init_adamw_state", "quantize_int8", "warmup_cosine"]
