"""yi-34b — dense llama-arch GQA LM [arXiv:2403.04652; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
)
