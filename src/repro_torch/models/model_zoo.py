"""Model zoo front end: step functions per architecture (port of
``repro.models.model_zoo``; the prefill and decode steps).

Not in this slice (ROADMAP.md, Queue 1): ``make_loss_fn``/``make_train_step``
(item 3) and ``input_specs``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    Transformer,
    check_supported,
    decode_step,
    forward,
    init_decode_state,
    init_model,
)

__all__ = ["init_decode_state", "init_model", "make_decode_fn", "make_prefill_fn"]


def make_prefill_fn(cfg: ModelConfig, *, device="cuda"):
    """``prefill(model, batch) -> (B, padded_vocab)`` next-token logits.

    Runs ``forward`` under ``torch.inference_mode`` on ``device`` (default
    the GPU; raises without one) and returns a copy of the last position's
    logits, so the full ``(B, S, padded_vocab)`` logits are freed on return.
    """
    check_supported(cfg)
    dev = resolve_device(device)

    def prefill(model: Transformer, batch: dict) -> torch.Tensor:
        if model.embed.device != dev:
            raise ValueError(f"model weights are on {model.embed.device}, prefill runs on {dev}")
        with torch.inference_mode():
            return forward(model, cfg, batch)[:, -1].clone()

    return prefill


def make_decode_fn(cfg: ModelConfig, *, device="cuda"):
    """``serve_step(model, tokens, state) -> (logits (B, padded_vocab), state)``:
    ``decode_step`` under ``torch.inference_mode`` on ``device`` (default
    the GPU; raises without one).  The state is updated in place."""
    check_supported(cfg)
    dev = resolve_device(device)

    def serve_step(model: Transformer, tokens, state: dict):
        if model.embed.device != dev:
            raise ValueError(f"model weights are on {model.embed.device}, decode runs on {dev}")
        with torch.inference_mode():
            return decode_step(model, cfg, tokens, state)

    return serve_step
