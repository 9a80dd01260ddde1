"""The split MTTKRP kernel's contracts in the kernel itself, on the card.

Runs the kernel's audit build (``kernel.mttkrp_cuda_audit``: the same
source compiled with ``-DMTTKRP_AUDIT``) and asserts what
``repro_torch.analysis`` proves of the CPU replay: every output element
stored exactly once, no carry or tile row read before it is written, each
restart's consumed nonzeros, index columns and factor rows exactly
``analytic_traffic_census(N)`` times the nonzeros, no NaN left in an output
filled with NaN, and the audit output bit for bit the production kernel's.

Needs an NVIDIA GPU with the CUDA toolkit; skipped elsewhere.  Imports no
JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_analysis_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.census import audit_failures, audit_summary
from repro_torch.core.sparse_tensor import SparseTensor, build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _coo(rng, rows, dims):
    idx = np.stack([rows] + [rng.integers(0, d, rows.size) for d in dims[1:]], 1)
    return SparseTensor(idx.astype(np.int32), rng.standard_normal(rows.size).astype(np.float32),
                        dims)


def _hot_row(rng):
    rows = np.concatenate([np.zeros(100_000, np.int64), rng.integers(1, 500, 10_000)])
    return _coo(rng, rows, (500, 300, 400))


def _padding(rng):
    return _coo(rng, np.arange(0, 32_000, 16) + rng.integers(0, 16, 2000), (32_000, 50, 60))


def _sparse_rows(rng):
    return _coo(rng, np.repeat(np.arange(0, 100_000, 50), 100), (100_000, 70, 90))


def _few(rng):
    return _coo(rng, rng.integers(0, 400, 50), (400, 30, 20))


# name -> (tensor maker, rank, tile_nnz, rows_per_block, dtype)
CASES = {
    "hot row": (_hot_row, 16, 256, 256, torch.float32),
    "slice boundaries inside padding": (_padding, 16, 256, 16, torch.float32),
    "empty rows between slices": (_sparse_rows, 16, 128, 64, torch.float32),
    "fewer nonzeros than slices": (_few, 16, 32, 16, torch.float32),
    "4 modes": (lambda rng: random_sparse_tensor((60, 50, 40, 30), 20_000, seed=4, zipf_a=0.7),
                16, 128, 32, torch.float32),
    "5 modes, rank 13, bf16": (lambda rng: random_sparse_tensor((20, 18, 16, 14, 12), 20_000,
                                                                seed=5), 13, 128, 32,
                               torch.bfloat16),
}


def _factors(shape, rank, batch, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    return [torch.randn(lead + (s, rank), generator=gen).to(device=device, dtype=dtype)
            for s in shape]


def _audit(bufs, facs, mode, i_out, nnz, split_mode):
    before = tkernel.mttkrp_cuda_audit.launches
    got, counts = tkernel.mttkrp_cuda_audit(bufs, facs, mode, i_out, split_mode=split_mode)
    want = tkernel.mttkrp_cuda(bufs, facs, mode, i_out, split_mode=split_mode)
    summary = audit_summary(counts, got)
    assert tkernel.mttkrp_cuda_audit.launches == before + 1
    failures = audit_failures(summary, len(facs), nnz, i_out, int(facs[0].shape[-1]))
    assert not failures, (split_mode, mode, failures, summary)
    assert torch.equal(got, want), (split_mode, mode, "the audit build's output differs")
    assert summary["entries_read"] >= nnz
    return summary


@pytest.mark.parametrize("batch", [None, 4, 5])
@pytest.mark.parametrize("name", list(CASES))
def test_audit_build_holds_the_contracts(cuda, name, batch):
    make, rank, tile_nnz, rpb, dtype = CASES[name]
    t = make(np.random.default_rng(8))
    facs = _factors(t.shape, rank, batch, dtype, cuda, seed=t.nnz)
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=tile_nnz, rows_per_block=rpb)
        bufs = tops.plan_device_buffers(plan, cuda)
        for split_mode in ("rows", "tiles"):
            _audit(bufs, facs, mode, t.shape[mode], t.nnz, split_mode)


@pytest.mark.parametrize("batch", [None, 4])
def test_audit_build_on_blocked_plans(cuda, batch):
    t = random_sparse_tensor((300, 200, 250), 60_000, seed=2, zipf_a=0.8)
    facs = _factors(t.shape, 16, batch, torch.float32, cuda, seed=3)
    for mode in range(t.nmodes):
        plan = build_mttkrp_plan(t, mode, tile_nnz=64, rows_per_block=64, ordering="blocked",
                                 device=cuda)
        bufs = tops.plan_device_buffers(plan, cuda)
        assert tkernel.split_mode_for(bufs, None) == "tiles"
        _audit(bufs, facs, mode, t.shape[mode], t.nnz, None)


def test_audit_build_on_a_stacked_service_plan(cuda):
    dims = (64, 48, 40)
    tensors = [random_sparse_tensor(dims, n, seed=s) for s, n in ((0, 900), (1, 1500), (2, 40))]
    nnz_pad = 2048
    indices, values, _ = tops.stacked_operands(tensors, dims, nnz_pad, device=cuda)
    facs = _factors([len(tensors) * d for d in dims], 8, None, torch.float32, cuda, seed=9)
    total = sum(t.nnz for t in tensors)
    for mode in range(3):
        bufs = tops.stacked_plan_buffers(indices, values, [t.nnz for t in tensors], dims, mode)
        _audit(bufs, facs, mode, len(tensors) * dims[mode], total, None)
