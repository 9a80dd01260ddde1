"""The experiment engine's measured runs on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the split kernel is built with
nvcc on first use); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_experiments_cuda.py

``measure_cp_als(impl="kernel", device="cuda")`` must launch the split
kernel once per MTTKRP call (eager and both fused runs, none of the block
kernel), record CUDA-event times, keep its fits within ``FUSED_FIT_TOL``
of the same run on the CPU, and report the closed-form flops.  The engine
on the card must price exactly what it prices on the CPU: the traces are
the plans', whatever runs them.
"""

import math

import pytest
import torch

from repro_torch.core.cp_als_fused import FUSED_FIT_TOL
from repro_torch.data.synthetic_tensors import make_frostt_like
from repro_torch.experiments import ExperimentSpec, measure_cp_als, run_experiments
from repro_torch.kernels.mttkrp import kernel as tkernel

pytestmark = pytest.mark.cuda

ITERS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("ordering", [None, "blocked"])
def test_measure_cp_als_kernel_on_the_card(cuda, ordering):
    t = make_frostt_like("LBNL", scale=2e-2, seed=0)  # 5 modes, 34,000 nonzeros
    tkernel.reset_launch_counts()
    got = measure_cp_als(t, name="lbnl", impl="kernel", n_iters=ITERS, ordering=ordering,
                         fused=True, device=cuda)
    calls = ITERS * t.nmodes
    assert tkernel.mttkrp_cuda.launches == 3 * calls  # eager, fused cold, fused warm
    assert tkernel.mttkrp_cuda.launches_by_variant.get("block", 0) == 0
    want = measure_cp_als(t, name="lbnl", impl="kernel", n_iters=ITERS, ordering=ordering,
                          fused=True, device="cpu")
    assert math.isfinite(got.fit) and math.isfinite(got.fused_fit)
    assert abs(got.fit - want.fit) <= FUSED_FIT_TOL
    assert abs(got.fused_fit - want.fused_fit) <= FUSED_FIT_TOL
    assert got.fused_max_fit_delta <= FUSED_FIT_TOL
    for m in got.modes:
        assert m.calls == ITERS
        assert m.flops == m.paper_flops == 2.0 * t.nmodes * t.nnz * 16
        assert m.steady_device_s > 0 and m.steady_s >= m.steady_device_s


def test_engine_prices_the_card_run_as_the_cpu_run(cuda):
    spec = dict(tensors=(("NELL-2", 1e-4),), impls=("kernel",), n_iters=2)
    tkernel.reset_launch_counts()
    got = run_experiments(ExperimentSpec(device="cuda", **spec))
    assert tkernel.mttkrp_cuda.launches == 3 * 2 * 3
    want = run_experiments(ExperimentSpec(device="cpu", **spec))
    (r,), (w,) = got.runs, want.runs
    assert [t.priced_mode_s for t in r.techs] == [t.priced_mode_s for t in w.techs]
    assert [h.trace for h in r.hit_rates] == [h.trace for h in w.hit_rates]
    assert got.all_within_tol
    assert abs(r.measured.fit - w.measured.fit) <= FUSED_FIT_TOL
