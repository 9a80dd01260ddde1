"""zamba2-1.2b — hybrid: Mamba2 backbone + ONE shared attention block
applied periodically [arXiv:2411.15242]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # shared block is full MHA
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    shared_attn_every=6,
)
