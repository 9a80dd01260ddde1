from repro_torch.configs.registry import ARCHITECTURES, get_config, reduced_config

__all__ = ["ARCHITECTURES", "get_config", "reduced_config"]
