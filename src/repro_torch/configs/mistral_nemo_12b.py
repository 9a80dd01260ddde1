"""mistral-nemo-12b — dense GQA LM, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,  # Nemo uses head_dim 128 (d_model/num_heads = 160 is NOT used)
    rope_theta=1e6,
)
