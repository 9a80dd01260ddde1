"""internvl2-26b — VLM: InternViT frontend (STUB) + InternLM2 backbone
[arXiv:2404.16821; hf].  Per assignment, the vision frontend is a stub:
input_specs() supplies precomputed patch embeddings prepended to text."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_stub",
    num_prefix_embeds=1024,  # ViT patch embeddings per image
)
