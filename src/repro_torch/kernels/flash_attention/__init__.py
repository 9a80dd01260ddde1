"""Flash attention: the CUDA kernel, its plain PyTorch version and dispatch."""

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref, max_row_error

__all__ = ["attention_ref", "flash_attention", "flash_attention_cuda", "flash_attention_plain",
           "max_row_error"]
