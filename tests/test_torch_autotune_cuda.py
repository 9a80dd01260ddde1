"""The autotuner (``repro_torch.dse.autotune``) on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the split kernel is built with
nvcc on first use); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_autotune_cuda.py

A real tune measures the split kernel (device time of each call, queued
behind a sleep): positive times, tuned <= default, no new measurement on a
repeat, and the winner's plans through the kernel within 1e-4 of the sum
of each element's absolute terms of the plain version, as
``chip_smoke.compare`` holds them.  A config the tile mode has no grid for
raises, naming it; the fused executor and the engine take a tuner.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cp_als_fused as tfused
from repro_torch.core.cp_als import cp_init
from repro_torch.core.sparse_tensor import random_sparse_tensor
from repro_torch.dse import DEFAULT_TILE_CONFIG, Autotuner, TileConfig, TuneSpace, measure_config
from repro_torch.experiments import ExperimentSpec, run_experiments
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.kernels.mttkrp import ops as tops
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref

pytestmark = pytest.mark.cuda

TOL = 1e-4
SPACE = TuneSpace(tile_nnz=(128, 512), rows_per_block=(64, 256), orderings=("lex", "degree"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tensor():
    return random_sparse_tensor((900, 700, 1500), 200_000, seed=0, zipf_a=0.9)


def test_measure_config_times_the_split_kernel(cuda):
    t = _tensor()
    facs = cp_init(t, 16, seed=0, device=cuda)
    tkernel.reset_launch_counts()
    s = measure_config(t, facs, 0, DEFAULT_TILE_CONFIG, reps=3)
    assert 0.0 < s < 0.1
    assert tkernel.mttkrp_cuda.launches_by_variant == {"split": 4, "block": 0}


def test_tune_on_the_card(cuda):
    t = _tensor()
    tuner = Autotuner(SPACE, device=cuda)
    tkernel.reset_launch_counts()
    result = tuner.tune(t, 16)
    assert tkernel.mttkrp_cuda.launches == len(SPACE.configs()) * 3 * (1 + tuner.reps)
    assert result.device == "cuda" and result.to_dict()["backend"] == "cuda"
    assert all(s > 0 for s in result.timings.values())
    assert result.best_s <= result.default_s and result.speedup_vs_default >= 1.0
    misses = tuner.memo.misses
    assert tuner.tune(t, 16) is result and tuner.config_for(t, 16) == result.best
    assert tuner.memo.misses == misses
    facs = [torch.randn((d, 16), generator=torch.Generator().manual_seed(d)).to(cuda)
            for d in t.shape]
    for m in range(3):
        plan = tops.get_plan(t, m, tile_nnz=result.best.tile_nnz,
                             rows_per_block=result.best.rows_per_block,
                             ordering=result.best.ordering, device=cuda)
        bufs = tops.plan_device_buffers(plan, cuda)
        got = tkernel.mttkrp_cuda(bufs, facs, m, t.shape[m])
        want = mttkrp_plan_ref(bufs, facs, m, t.shape[m])
        scale = mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                                m, t.shape[m])
        assert bool(((got - want).abs() <= TOL * scale).all())


def test_a_config_the_tile_mode_refuses_raises_and_names_it(cuda):
    t = random_sparse_tensor((300, 200, 100), 5_000, seed=1)
    tuner = Autotuner(TuneSpace(tile_nnz=(256,), rows_per_block=(16_384,),
                                orderings=("blocked",)), device=cuda)
    with pytest.raises(ValueError, match=r"\(256,16384,blocked\)"):
        tuner.tune(t, 16)


def test_fused_executor_and_engine_take_the_tuner(cuda):
    t = _tensor()
    tuner = Autotuner(SPACE, device=cuda, tune_on_miss=True)
    tkernel.reset_launch_counts()
    tuned = tfused.cp_als_fused(t, 16, n_iters=4, tol=0.0, impl="kernel", device=cuda,
                                autotune=tuner)
    best = tuner.config_for(t, 16)
    assert tkernel.mttkrp_cuda.launches == len(SPACE.configs()) * 3 * 4 + 12
    plain = tfused.cp_als_fused(t, 16, n_iters=4, tol=0.0, impl="kernel", device=cuda)
    assert np.max(np.abs(tuned.fits - plain.fits)) <= tfused.FUSED_FIT_TOL
    ex = tfused.FusedCPALS(t, 16, impl="kernel", device=cuda, autotune=tuner)
    assert {(p.tile_nnz, p.rows_per_block, p.ordering) for p in ex._plans} == {
        (best.tile_nnz, best.rows_per_block, best.ordering)}
    assert isinstance(best, TileConfig)
    spec = ExperimentSpec(tensors=(("NELL-2", 2e-3),), impls=("kernel",), n_iters=2,
                          fused=False, device="cuda", autotune=True)
    (run,) = run_experiments(spec).runs
    assert np.isfinite(run.measured.fit)
