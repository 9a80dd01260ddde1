"""The sharded MTTKRP and CP-ALS on the card, one process per rank.

Needs an NVIDIA GPU with the CUDA toolkit (the split kernel is built with
nvcc before the ranks start); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_distributed_cuda.py

Gloo ranks that share the card and NCCL ranks with a card each run every
case of ``tests/test_distributed.py`` in both schemes against the port's
``mttkrp_ref`` on the card (1e-4, that file's tolerance); every rank's
local MTTKRP is one split-kernel launch per call, and a ``mode_ordered``
residual pass one more; a ``mode_ordered`` call repeats bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.core.cp_als import cp_als
from repro_torch.core.cp_als_fused import FUSED_FIT_TOL
from repro_torch.core.mttkrp import mttkrp_ref
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.distributed import backend_for, spawn
from repro_torch.kernels import build

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    build.build_all(["mttkrp_split"])  # once, before the ranks load it
    return torch.device("cuda")


def _check(results, cases, dev):
    refs = []
    for t, facs, _, _ in cases:
        f = [torch.from_numpy(x).to(dev) for x in facs]
        for mode in range(t.nmodes):
            want = mttkrp_ref(t, f, mode).cpu().numpy()
            refs += [want, want]
    for rank, res in enumerate(results):
        # One launch a call, and one more for a residual pass.
        assert res["launches"] == res["expected"] >= len(refs), (rank, res["launches"])
        assert res["repeat"], f"rank {rank}: a mode_ordered call is not bit for bit repeatable"
        for i, (got, want) in enumerate(zip(res["outs"], refs)):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"rank {rank} #{i}")


@pytest.mark.parametrize("world", [3, 8])
def test_gloo_ranks_sharing_the_card(cuda, world):
    cases = ranks.sharded_cases()
    results = spawn(ranks.sharded_outputs, world, device="cuda", backend="gloo",
                    args=(cases, "cuda"))
    _check(results, cases, cuda)


def test_nccl_one_rank(cuda):
    cases = ranks.sharded_cases()
    _check(spawn(ranks.sharded_outputs, 1, device="cuda", backend="nccl", args=(cases, "cuda")),
           cases, cuda)


def test_nccl_a_card_per_rank(cuda):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards")
    cases = ranks.sharded_cases()
    assert backend_for("cuda", cards) == "nccl"
    _check(spawn(ranks.sharded_outputs, cards, device="cuda", backend="nccl",
                 args=(cases, "cuda")), cases, cuda)


def test_sharded_cp_als_on_the_card_matches_one_process(cuda):
    t = random_sparse_tensor((300, 250, 200), 20_000, seed=5, zipf_a=0.8, shuffle=True)
    inits = [[np.random.default_rng(s).random((n, 8)).astype(np.float32) for n in t.shape]
             for s in (0, 1)]
    want = [cp_als(t, 8, n_iters=5, tol=0.0, impl="kernel", device=cuda, init_factors=i).fits
            for i in inits]
    for out in spawn(ranks.sharded_cp_als, 3, device="cuda", backend="gloo",
                     args=(t, 8, inits, 5, "cuda")):
        for scheme, (eager, fused) in out.items():
            np.testing.assert_allclose(eager, want[0], atol=FUSED_FIT_TOL, rtol=0, err_msg=scheme)
            for r in range(2):
                np.testing.assert_allclose(fused[r], want[r], atol=FUSED_FIT_TOL, rtol=0,
                                           err_msg=scheme)
