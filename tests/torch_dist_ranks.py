"""Per-rank bodies of the sharded tests (``test_torch_distributed*.py``).

``repro_torch.distributed.spawn`` runs them in its rank processes, which
import this module by name; it imports no JAX, so the ranks load only
PyTorch and the port.
"""

import time

import numpy as np
import torch

from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import mttkrp as tm
from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.distributed import rank_device
from repro_torch.distributed.mttkrp_dist import sharded_setup
from repro_torch.kernels.mttkrp import kernel as tkernel

SCHEMES = ("allreduce", "mode_ordered")


def sharded_cases() -> list[tuple]:
    """``(tensor, factors, ordering, rows_per_block)`` of ``tests/test_distributed.py``
    (3-, 4- and 5-mode, uneven, a single nonzero, rank 1, one output block,
    fewer nonzeros than shards), a restart batch of factors, and the
    ``blocked`` order at dims past one input band.  Factors are numpy,
    normal from a seed."""
    rng = np.random.default_rng(0)

    def facs(t, rank, batch=None):
        lead = () if batch is None else (batch,)
        return [rng.standard_normal(lead + (s, rank)).astype(np.float32) for s in t.shape]

    out = []
    for shape, nnz, seed in (((97, 40, 33), 1200, 3), ((61, 47, 33), 1201, 3),
                             ((25, 19, 13, 11), 875, 4), ((13, 11, 9, 7, 5), 403, 5)):
        t = random_sparse_tensor(shape, nnz, seed=seed)
        out.append((t, facs(t, 16), None, 256))
    single = SparseTensor(np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32), (11, 6, 9))
    out.append((single, facs(single, 8), None, 256))
    t = random_sparse_tensor((30, 20, 10), 200, seed=21)
    out.append((t, facs(t, 1), None, 256))
    idx = np.stack([rng.integers(0, 16, 300), rng.integers(0, 40, 300),
                    rng.integers(0, 40, 300)], axis=1).astype(np.int32)
    one_block = SparseTensor(idx, rng.standard_normal(300).astype(np.float32), (256, 40, 40))
    out.append((one_block, facs(one_block, 16), None, 256))
    t = random_sparse_tensor((40, 30, 20), 5, seed=13)
    out.append((t, facs(t, 16), None, 256))
    t = random_sparse_tensor((50, 40, 30), 700, seed=8, zipf_a=0.8)
    out.append((t, facs(t, 8, batch=3), None, 256))
    t = random_sparse_tensor((300, 280, 260), 4000, seed=7, zipf_a=0.9)
    out.append((t, facs(t, 8), "blocked", 16))
    return out


def sharded_outputs(cases, device: str) -> dict:
    """Every case's sharded MTTKRP, each mode and scheme (in that order), on
    this rank (``outs``); the rank's split-kernel launches over them and the
    count expected (one a call, one more for a residual pass); and whether
    a second ``mode_ordered`` call of each gave the same bits."""
    dev = rank_device(device)
    tkernel.reset_launch_counts()
    outs, calls = [], []
    for t, facs, ordering, rpb in cases:
        f = [torch.from_numpy(x).to(dev) for x in facs]
        for mode in range(t.nmodes):
            for scheme in SCHEMES:
                got = tm.mttkrp(t, f, mode, impl="sharded", scheme=scheme, ordering=ordering,
                                rows_per_block=rpb)
                outs.append(got.cpu().numpy())
                calls.append((got, f, t, mode, scheme, ordering, rpb))
    launches = tkernel.mttkrp_cuda.launches_by_variant["split"]
    expected = sum(1 + (sharded_setup(t, mode, scheme=scheme, ordering=ordering,
                                      rows_per_block=rpb, device=dev).leftover_plan is not None)
                   for _, _, t, mode, scheme, ordering, rpb in calls)
    # Every rank makes every call (each is collective) before any is judged.
    repeat = all([torch.equal(got, tm.mttkrp(t, f, mode, impl="sharded", ordering=ordering,
                                              rows_per_block=rpb))
                  for got, f, t, mode, scheme, ordering, rpb in calls
                  if scheme == "mode_ordered"])
    return dict(outs=outs, launches=launches, expected=expected, repeat=repeat)


def sharded_cp_als(t, rank: int, inits, n_iters: int, device: str) -> dict:
    """Eager ``cp_als(impl="sharded")`` from ``inits[0]`` and
    ``FusedCPALS(impl="sharded")`` from every init, in both schemes."""
    dev = rank_device(device)
    out = {}
    for scheme in SCHEMES:
        eager = tcp.cp_als(t, rank, n_iters=n_iters, tol=0.0, impl="sharded", scheme=scheme,
                           device=dev, init_factors=inits[0])
        fused = tfused.FusedCPALS(t, rank, impl="sharded", scheme=scheme, device=dev).run(
            n_iters=n_iters, tol=0.0, init_factors=inits, fit_every=n_iters)
        out[scheme] = (eager.fits, fused.fits)
    return out


def failing_rank() -> None:
    """Rank 1 raises; the others wait, outside any collective, until
    ``spawn`` stops them (a collective would fail too, and race it)."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 planted failure")
    time.sleep(120)
