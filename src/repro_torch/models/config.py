"""Unified model configuration (copy of ``repro.models.config``).

The same fields, defaults and derived properties as the JAX package's
``ModelConfig``, with torch dtypes: ``dtype=torch.bfloat16`` (compute) and
``param_dtype=torch.float32`` (master weights).  ``attention_block_q`` and
``attention_block_kv`` are the blocks of the blocked attention's
recomputing backward, as in JAX; the forward kernel picks its own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff is the dense fallback)
    capacity_factor: float = 1.25
    moe_group_size: int = 1024  # dispatch-group length; must divide seq_len
    # --- SSM / RWKV ----------------------------------------------------------
    ssm_state: int = 0  # Mamba2 state size
    rwkv: bool = False  # RWKV6 "Finch" token mix instead of attention
    scan_chunk: int = 128  # recurrent-scan chunk length
    # --- hybrid (zamba2): one shared attention block every k core layers ----
    shared_attn_every: int = 0
    # --- encoder-decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_target_len: int = 448  # whisper decoder positions
    # --- modality frontend stub (vlm / audio): precomputed embeddings -------
    frontend: Optional[str] = None  # "vision_stub" | "audio_stub"
    num_prefix_embeds: int = 0  # vlm: patch embeddings prepended to text
    # --- misc ----------------------------------------------------------------
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # attention impl: "dense" (materialize scores), "blocked" (the flash
    # kernel) or "auto" (blocked above 2048 tokens)
    attention_impl: str = "auto"
    attention_block_q: int = 512
    attention_block_kv: int = 1024
    remat_policy: str = "full"  # full | dots | none

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits table height padded to 256.  Token ids stay
        < vocab_size; padded logits are masked to -1e9."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.rwkv or (self.family == "ssm" and not self.rwkv)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid") or self.rwkv

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer weights)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.rwkv:
            per_layer = 4 * d * d + 3 * d * ff // 1  # time-mix + channel-mix
        elif self.family in ("ssm", "hybrid") and not self.rwkv:
            # mamba2 block: in_proj d->(4d+2*ds+nh) + out_proj 2d->d
            d_inner = 2 * d
            nheads = d_inner // 64
            per_layer = d * (2 * d_inner + 2 * self.ssm_state + nheads) + d_inner * d
            if self.shared_attn_every:
                # ONE shared attn+mlp block amortized over the stack
                shared = (
                    d * (self.num_heads + 2 * self.num_kv_heads) * hd
                    + self.num_heads * hd * d
                    + 3 * d * ff
                )
                per_layer += shared // max(self.num_layers, 1)
        else:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            per_layer = q + kv + o
            if self.is_moe:
                per_layer += self.num_experts * 3 * d * self.moe_d_ff
            else:
                per_layer += 3 * d * ff
        total = emb + self.num_layers * per_layer
        if self.is_encoder_decoder:
            total += self.encoder_layers * (4 * d * d + 3 * d * ff) + per_layer // 2
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        hd = self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        per_layer = q + kv + o + self.top_k * 3 * d * self.moe_d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + self.num_layers * per_layer)
