"""whisper-base — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs() supplies precomputed frame embeddings) [arXiv:2212.04356]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=6,
    frontend="audio_stub",
    max_target_len=448,
)
