"""The CUDA MTTKRP kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernel is built with nvcc
on first use); skipped elsewhere.  Imports no JAX, so it runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_cuda.py

Tolerances: 1e-4 for float32 factors, 3e-2 for bfloat16 (the kernel's
shared-memory atomics sum in a run-dependent order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sparse_tensor import SparseTensor, build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _factors(shape, rank, device, *, batch=None, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [
        torch.from_numpy(rng.standard_normal(lead + (s, rank)).astype(np.float32))
        .to(device=device, dtype=dtype)
        .contiguous()
        for s in shape
    ]


def _compare(t, rank, device, *, tile_nnz=64, rows_per_block=32, batch=None,
             dtype=torch.float32, tol=1e-4):
    facs = _factors(t.shape, rank, device, batch=batch, dtype=dtype)
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rows_per_block)
        bufs = tops.plan_device_buffers(plan, device)
        before = tkernel.mttkrp_cuda.launches
        got = tkernel.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
        torch.cuda.synchronize()
        assert tkernel.mttkrp_cuda.launches == before + 1
        want = mttkrp_plan_ref(bufs, facs, mode, t.shape[mode])
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("rank", [1, 16, 128])
def test_kernel_matches_plain_version(cuda, rank):
    _compare(random_sparse_tensor((70, 33, 41), 2000, seed=3, zipf_a=0.8), rank, cuda)


def test_kernel_edge_geometry(cuda):
    idx = np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32)
    _compare(SparseTensor(idx, np.array([1.0, 2.0, 3.0], np.float32), (300, 4, 4)), 8, cuda,
             rows_per_block=64)
    _compare(SparseTensor(np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32),
                          (11, 6, 9)), 8, cuda)
    _compare(random_sparse_tensor((40, 30, 20), 5, seed=13), 16, cuda, tile_nnz=256)
    _compare(random_sparse_tensor((20, 15, 10, 8), 300, seed=4), 8, cuda)
    _compare(random_sparse_tensor((9, 8, 7, 6, 5), 300, seed=5), 8, cuda)


def test_kernel_bf16_and_batched(cuda):
    t = random_sparse_tensor((60, 50, 40), 3000, seed=6, zipf_a=0.9)
    _compare(t, 16, cuda, dtype=torch.bfloat16, tol=3e-2)
    _compare(t, 16, cuda, batch=4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = random_sparse_tensor((30, 20, 10), 200, seed=7)
    bufs = tops.plan_device_buffers(build_mttkrp_plan(t, 0, tile_nnz=32, rows_per_block=16), cuda)
    facs = _factors(t.shape, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.mttkrp_cuda(bufs, [facs[0], facs[1], facs[2].t().contiguous().t()], 0, 30)
    with pytest.raises(TypeError):
        tkernel.mttkrp_cuda(bufs, [f.double() for f in facs], 0, 30)
    with pytest.raises(ValueError, match="rows"):
        tkernel.mttkrp_cuda(bufs, [facs[0], facs[1][:5].contiguous(), facs[2]], 0, 30)
