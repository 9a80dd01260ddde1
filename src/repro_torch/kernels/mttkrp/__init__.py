"""Sparse MTTKRP: the CUDA kernel, its plain PyTorch version and dispatch."""

from repro_torch.kernels.mttkrp.kernel import mttkrp_cuda
from repro_torch.kernels.mttkrp.ops import (
    PlanBuffers,
    get_plan,
    mttkrp_from_plan,
    mttkrp_kernel,
    plan_device_buffers,
    tensor_device_operands,
)
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
