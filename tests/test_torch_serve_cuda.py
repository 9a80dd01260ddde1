"""The CP-ALS service's stacked MTTKRP and executor on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the split kernel is built with
nvcc on first use); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_cuda.py

A batch's stacked plan (``ops.stacked_plan_buffers``) through the split
kernel is held against the plain version on the same buffers and against
each tensor's own plain MTTKRP, every element within 1e-4 of the sum of
its terms' absolute values, as ``chip_smoke.compare`` does; two launches
agree bit for bit, and the plan built on the card is the one built on the
CPU.  Staging a batch and ``run_batch`` must enqueue without a host-device
synchronisation (checked behind a queued sleep), and served fits match a
standalone ``cp_als_fused`` on the card within ``FUSED_FIT_TOL``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core.sparse_tensor import build_mttkrp_plan, random_sparse_tensor
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref
from repro_torch import serve as tserve

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tensors(nmodes):
    """Three tensors of one bucket and a pad slot replaying the first.
    Mode 0 bands to 2048 rows: each tensor's rows end in empty blocks."""
    shapes = {3: [(1100, 20, 40), (1300, 30, 50), (1030, 17, 33)],
              4: [(1100, 20, 40, 9), (1300, 30, 50, 12), (1030, 17, 33, 16)]}[nmodes]
    dims = (2048, 32, 64, 16)[:nmodes]
    tensors = [random_sparse_tensor(s, 20_000, seed=i, zipf_a=0.9) for i, s in enumerate(shapes)]
    return dims, tensors + [tensors[0]]


@pytest.mark.parametrize("rank", [4, 8, 16])
@pytest.mark.parametrize("nmodes", [3, 4])
def test_stacked_plan_through_split_kernel(cuda, nmodes, rank):
    dims, tensors = _tensors(nmodes)
    batch = len(tensors)
    gen = torch.Generator().manual_seed(rank)
    facs = [torch.randn((batch * d, rank), generator=gen).to(cuda) for d in dims]
    idx, vals, _ = tops.stacked_operands(tensors, dims, 32_768, device=cuda)
    cpu_idx, cpu_vals, _ = tops.stacked_operands(tensors, dims, 32_768, device="cpu")
    nnz = [t.nnz for t in tensors]
    for mode in range(nmodes):
        bufs = tops.stacked_plan_buffers(idx, vals, nnz, dims, mode)
        # Built on the card, the plan is the one built on the CPU.
        on_cpu = tops.stacked_plan_buffers(cpu_idx, cpu_vals, nnz, dims, mode)
        for got, want in zip(bufs, on_cpu):
            if isinstance(got, torch.Tensor):
                assert torch.equal(got.cpu(), want), f"mode {mode}: plans differ"
        i_out = batch * dims[mode]
        before = tkernel.mttkrp_cuda.launches_by_variant["split"]
        got = tkernel.mttkrp_cuda(bufs, facs, mode, i_out)
        again = tkernel.mttkrp_cuda(bufs, facs, mode, i_out)
        torch.cuda.synchronize()
        assert tkernel.mttkrp_cuda.launches_by_variant["split"] == before + 2
        assert torch.equal(got, again), f"mode {mode}: two launches differ"
        want = mttkrp_plan_ref(bufs, facs, mode, i_out)
        scale = mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                                mode, i_out)
        assert bool(((got - want).abs() <= TOL * scale).all()), f"mode {mode}"
        # Tensor by tensor: its own plan's plain MTTKRP, zeros past its true rows.
        for b, t in enumerate(tensors):
            own = [f[b * d : b * d + s] for f, d, s in zip(facs, dims, t.shape)]
            alone = mttkrp_plan_ref(tops.plan_device_buffers(build_mttkrp_plan(t, mode), cuda),
                                    own, mode, t.shape[mode])
            rows = got[b * dims[mode] : (b + 1) * dims[mode]]
            torch.testing.assert_close(rows[: t.shape[mode]], alone, rtol=TOL, atol=TOL)
            assert not rows[t.shape[mode]:].any(), f"mode {mode}: padded rows of tensor {b}"


def _requests(n, rank=8, n_iters=3):
    return [tserve.DecompRequest(f"r{i}", random_sparse_tensor((300 + 7 * i, 200, 150), 30_000,
                                                               seed=i, zipf_a=0.8),
                                 rank=rank, n_iters=n_iters, seed=i + 1) for i in range(n)]


def _behind_a_sleep(fn):
    """Run ``fn`` behind about half a second of queued device work; returns
    ``(result, the sleep had ended when fn returned)``.  A call that
    synchronises with the device returns only after the sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    slept = torch.cuda.Event()
    slept.record()
    out = fn()
    ended = slept.query()
    torch.cuda.synchronize()
    return out, ended


@pytest.mark.parametrize("rank", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("rows", [16, 512, 4096])
def test_mode_update_solve_never_waits_for_the_device(cuda, rank, rows):
    """The ALS solve at the shapes a mode update gives it (B systems of
    ``rank``, ``rows`` right-hand sides), behind a queued sleep."""
    gen = torch.Generator().manual_seed(rank + rows)
    f = torch.rand((4, 64, rank), generator=gen)
    a = (f.mT @ f + 1e-2 * torch.eye(rank)).to(cuda)
    b = torch.randn((4, rank, rows), generator=gen).to(cuda)
    tcp._solve(a, b)  # loads the libraries
    got, ended = _behind_a_sleep(lambda: tcp._solve(a, b))
    assert not ended, "the solve waited for the device"
    want = torch.linalg.solve(a.double(), b.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-3, atol=1e-3 * float(want.abs().max()))


def test_run_batch_enqueues_without_a_sync(cuda):
    """The sync debug mode does not see every synchronising call, so the
    batch is also queued behind a sleep: the host must get back first."""
    reqs = _requests(3)
    sig = tserve.bucket_signature(reqs[0])
    executor = tserve.BucketExecutor(sig, device=cuda)
    executor.launch(reqs, pad_to=4)  # builds the kernel and warms the libraries
    on_card, ended = _behind_a_sleep(lambda: executor.stage(reqs, pad_to=4))
    assert not ended, "staging a batch waited for the device"
    *operands, plans = on_card
    core = executor.core
    torch.cuda.set_sync_debug_mode("error")
    try:
        (_, _, fits), ended = _behind_a_sleep(
            lambda: core.run_batch(*operands, n_iters=sig.n_iters, plans=plans))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not ended, "run_batch waited for the device"
    *cpu_operands, cpu_plans = tserve.BucketExecutor(sig, device=torch.device("cpu")).stage(
        reqs, pad_to=4)
    _, _, want = core.run_batch(*cpu_operands, n_iters=sig.n_iters, plans=cpu_plans)
    np.testing.assert_allclose(fits.cpu().numpy(), want.numpy(), atol=tfused.FUSED_FIT_TOL, rtol=0)


def test_service_on_the_card_matches_standalone_runs(cuda):
    reqs = _requests(3, n_iters=4) + [
        tserve.DecompRequest("r16", random_sparse_tensor((300, 200, 150), 30_000, seed=9),
                             rank=16, n_iters=4, seed=3)]
    svc = tserve.DecompositionService(max_batch=4, max_inflight=2, device=cuda)
    tkernel.reset_launch_counts()
    for r in reqs:
        assert svc.submit(r)
    done = svc.run_until_drained()
    batches = len({(r.dispatch_t, r.signature) for r in done.values()})
    assert batches == 2
    assert tkernel.mttkrp_cuda.launches_by_variant == {"split": batches * 4 * 3, "block": 0}
    for r in reqs:
        alone = tfused.cp_als_fused(r.tensor, r.rank, n_iters=4, tol=0.0, seed=r.seed,
                                    impl="kernel", device=cuda)
        resp = done[r.request_id]
        assert resp.state.factors[0].device.type == cuda.type
        assert [tuple(f.shape) for f in resp.state.factors] == [(d, r.rank) for d in r.tensor.shape]
        np.testing.assert_allclose(resp.state.fits, alone.fits[0], atol=tfused.FUSED_FIT_TOL,
                                   rtol=0)
