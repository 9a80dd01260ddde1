"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper GPUs.

The JAX package (``src/repro``) is the reference; this package mirrors its
module layout (``repro/<path>.py`` <-> ``repro_torch/<path>.py``) and is
held against it by ``tests/test_torch_*.py``.  It imports ``torch`` and
``numpy`` only.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; nothing falls back to the CPU on its own.  On CUDA
tensors every MTTKRP goes through the hand-written kernel in
``kernels/mttkrp/csrc/mttkrp.cu``; on CPU tensors the same functions run
the kernel's plain PyTorch version.
"""

from repro_torch.device import resolve_device
