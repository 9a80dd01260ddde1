"""qwen3-moe-235b-a22b — 128 experts top-8 MoE [hf:Qwen/Qwen3-30B-A3B family]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    head_dim=128,
)
