"""Architecture registry (copy of ``repro.configs.registry``).

``get_config`` and ``reduced_config`` give field for field the JAX
package's configs, with torch dtypes.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHITECTURES", "get_config", "reduced_config"]

ARCHITECTURES: dict[str, str] = {
    # arch id -> module under repro_torch.configs
    "yi-34b": "yi_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "granite-20b": "granite_20b",
    "internlm2-1.8b": "internlm2_1_8b",
    "internvl2-26b": "internvl2_26b",
    "rwkv6-3b": "rwkv6_3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-base": "whisper_base",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHITECTURES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str, **overrides) -> ModelConfig:
    """Same-family tiny config for CPU tests (few layers, small width, few
    experts, tiny vocab)."""
    cfg = get_config(arch)
    d_model = 128
    num_heads = max(2, min(4, cfg.num_heads))
    head_dim = d_model // num_heads
    if cfg.rwkv:
        d_model, num_heads, head_dim = 128, 2, 64  # rwkv requires 64-dim heads
    kv = max(1, min(cfg.num_kv_heads, num_heads))
    changes = dict(
        num_layers=min(3, cfg.num_layers) if not cfg.shared_attn_every else 4,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.is_moe else 0,
        num_prefix_embeds=8 if cfg.frontend == "vision_stub" else 0,
        encoder_layers=min(2, cfg.encoder_layers),
        max_target_len=16 if cfg.is_encoder_decoder else cfg.max_target_len,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        attention_block_q=64,
        attention_block_kv=64,
    )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
