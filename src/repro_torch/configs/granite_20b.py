"""granite-20b — dense llama-arch MQA code LM [arXiv:2405.04324; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
)
