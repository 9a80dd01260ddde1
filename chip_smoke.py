#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

  1. the card, the versions, both TF32 flags, and the build of every CUDA
     source with nvcc for sm_90a;
  2. both MTTKRP kernels (the split kernel, every call's default, and the
     block kernel) against their plain PyTorch version on the card, over
     the edge cases of the CPU tests and of the split kernel's partition
     (a hot row spanning many slices, slice boundaries inside padding,
     empty rows between slices, fewer nonzeros than slices; tolerance 1e-4
     for float32 factors, 3e-2 for bfloat16, relative to the size of each
     output's sum: see ``compare``), two split launches bit for bit equal,
     and the port's CP-ALS on the card against the same run on the CPU
     (fits within FUSED_FIT_TOL);
  3. the main path at full size: a NELL-2 stand-in at Table II size (dims
     12100 x 9200 x 28800, 76.9M drawn nonzeros, Zipf 0.85), rank 16,
     through eager ``cp_als(impl="kernel")`` (5 sweeps) and
     ``cp_als_fused`` with 4 batched restarts (5 sweeps, one sync); per
     mode the largest block's and the hottest row's share of nonzeros and
     the split kernel's CTAs; the launch counters must show one split
     launch per mode per sweep in each;
  4. per mode at full size, the split kernel against its plain version
     with one restart and with 4 restarts whose factors differ, two
     launches bit for bit equal, then times (CUDA events, median of 10) of
     the split kernel, the block kernel and the plain version beside the
     least time the card could take for the bytes the function needs;
  5. a ``torch.profiler`` trace of one eager sweep: device time by kernel
     (the split kernel and its carry pass apart) and the device's idle
     share;
  6. the flash-attention kernels against their plain version on the card
     over S in {1, 63, 64, 65, 127, 129, 200, 1000}, causal and not, (H, KV)
     in {(4, 4), (4, 2), (4, 1), (16, 8)}, D in {64, 128}, B in {1, 3},
     float32 and bfloat16, and over q, k, v that are strided views of one
     fused projection: each case through the kernel ``variant_for`` picks
     (wgmma for bfloat16, the float32 kernel for float32) and each bfloat16
     case through the ``mma.sync`` kernel too; each output row within
     FLASH_ROW_TOL of its own norm (see ``max_row_error``), and each element
     within the JAX tests' 2e-5 and 3e-2 (absolute plus relative);
  7. the LM main path: internlm2-1.8b at full width and depth (random
     weights from ``init_model(seed=0)``), ``make_prefill_fn`` on B = 2,
     S = 32768 tokens (prefill_32k's length; its batch of 32 cut to 2): one
     warm-up and 3 timed prefills, each launching the wgmma flash kernel
     once per layer (launches counted per variant); then the same model at
     S = 256 with the kernel against plain dense attention, and a reduced
     config on the card against the CPU;
  8. both bfloat16 flash kernels on layer 0's q, k, v at the main path's
     shape against their plain version by the same two limits, two planted
     faults in the wgmma kernel's output that the row limit must reject
     (late rows scaled by 0.9; the last 64 rows without the first 64 keys),
     the times (CUDA events) of the wgmma kernel, the ``mma.sync`` kernel,
     the plain version and ``scaled_dot_product_attention`` (a yardstick the
     port never calls) beside the bound, and a ``torch.profiler`` trace of
     one prefill;
  9. the multi-tenant CP-ALS service (``DecompositionService``, max_batch 8,
     2 batches in flight) on 24 synthetic requests at a tenth of NELL-2's
     dims (1.3-2.2M drawn nonzeros each, ranks 8 and 16, 10 sweeps): a
     closed-loop drain of the trace submitted four times (each batch
     uploads its tensors and builds its stacked plans on the card inside
     the clock), then a replay of the requests at the trace's arrivals;
     every bucket batch's MTTKRP one split-kernel launch over its stacked
     plan (launches counted per variant); one batch's stacked MTTKRP per
     mode against its plain version, staging and ``run_batch`` queued
     behind a sleep (the host must return first) and ``run_batch`` under
     ``torch.cuda.set_sync_debug_mode("error")``, every response against a
     standalone ``cp_als_fused`` on the card (FUSED_FIT_TOL), and a
     ``torch.profiler`` trace of one batch, staging included;
 10. the nonzero orderings (lex, secondary-sort, degree, blocked) on phase
     3's tensor, run right after phase 5 while its tensor and lex plans are
     resident: per ordering the order of each mode sorted on the card
     (CUDA-event ms; mode 0 array-equal to the CPU's), the plans and their
     contiguity flag and padding, each mode's split kernel in the mode its
     plan picks (row-run for the first three, tile for blocked) against
     the plain version (1e-4 of the sum of absolute terms) with a bit-for-bit
     repeat, at B=1 and at B=4 (the fused run's initial factors), the times
     of the split kernel in that mode (B=1 and 4) and in tile mode, the
     block kernel and the plain version beside the byte bound, and one
     ``cp_als_fused(ordering=o, restarts=4, impl="kernel")`` of 5 sweeps
     whose fits must stay within FUSED_FIT_TOL of phase 3's lex run, its
     launches counted by variant and mode (all split, 0 block); on the
     blocked plans, a ``torch.profiler`` trace of one sweep splits the tile
     mode's time between its main launch and its carry pass.  Blocked runs
     second, after lex; each ordering's plans are freed before the next.
 11. the paper's experiment engine (``repro_torch.experiments``) through
     the split kernel: ``run_experiments`` with ``impls=("kernel",)``, 3
     sweeps eager and fused (cold and warm), on the largest stand-ins that
     ``make_frostt_like``'s cap of 2M nonzeros gives (NELL-2 at 0.026,
     LBNL at its Table II size with 5 modes, PATENTS at 5.6e-4), one call
     per tensor; per run the split launches (the counter's step across its
     call: eager plus both fused runs, 0 block), each mode's
     first call against the plain version (1e-4 of the sum of absolute
     terms), eager against fused fits (FUSED_FIT_TOL), the closed-form
     flops; per mode the steady per-call ms (synchronized on both sides),
     its CUDA-event ms and the byte bound (the tensor's nonzeros, not the
     plan's padding); the host seconds of the trace
     simulation and of the pricing; the priced and Che-modeled E-SRAM to
     O-SRAM speedups and energy savings, and the trace-vs-Che hit-rate gaps
     (printed, not asserted); NELL-2's hit rates again from the plans'
     ``executed_row_trace`` (must be equal) and a ``ref`` run on NELL-2 (its
     fit within FUSED_FIT_TOL of the kernel's); then the controller's gates
     as ``scripts/run_controller.py`` runs them (``reconcile_controller``
     and ``controller_gates``: reconciliation within
     CONTROLLER_RECON_TOL, the paper's bands, fewer bank conflicts under
     degree and blocked, sorted on the card) and the ordering benchmark
     (``run_reorder_sweep(quick=True)``, its acceptance).

The last three lines are the card's ``name, power.limit``, a JSON object
with the main paths' kernels' numbers (the split MTTKRP kernel's row-run
mode with the block kernel's time as ``previous_ms``, its launches over
the CP-ALS paths of phases 3, 9, 10 and 11, its per-ordering times and
phase 11's per-tensor times; its
tile mode, on the blocked plans of phase 10; and the wgmma flash kernel
with the ``mma.sync`` kernel's), and
``{"ok": true, "device": {...}}``.  The
script needs no network and imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# The port, from this checkout (a lone copy of this script fails here).
from repro_torch.core import cp_als as tcp  # noqa: E402
from repro_torch.core import cp_als_fused as tfused  # noqa: E402
from repro_torch.core import sparse_tensor as tst  # noqa: E402
from repro_torch.data.synthetic_tensors import make_frostt_like  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.core.cache_sim import simulate_trace  # noqa: E402
from repro_torch.core.hierarchy import CacheGeometry  # noqa: E402
from repro_torch.dse.evaluator import geometry_sim_config  # noqa: E402
from repro_torch.experiments import (  # noqa: E402
    CHE_VS_TRACE_TOL,
    CONTROLLER_RECON_TOL,
    ExperimentResult,
    ExperimentSpec,
    controller_gates,
    reconcile_controller,
    run_experiments,
)
from repro_torch.experiments.reconcile import ENERGY_BAND, SPEEDUP_BAND  # noqa: E402
from repro_torch.experiments import measure as texp_measure  # noqa: E402
from repro_torch.reorder.bench import run_reorder_sweep  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as kmod  # noqa: E402
from repro_torch.kernels.mttkrp import ops  # noqa: E402
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref  # noqa: E402
from repro_torch.reorder import strategies as tstrat  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data.lm_data import SyntheticLMStream  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkmod  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention.ref import NEG_INF, max_row_error  # noqa: E402
from repro_torch.models.attention import project_qkv  # noqa: E402
from repro_torch.models.model_zoo import init_model, make_prefill_fn  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BucketExecutor,
    DecompositionService,
    TrafficConfig,
    bucket_signature,
    replay_trace,
    synthetic_trace,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
F32_TOL = 1e-4
BF16_TOL = 3e-2
FLASH_F32_TOL = 2e-5  # tests/test_flash_kernel.py
# Flash output rows, ||kernel - plain|| / ||plain|| per (b, s, h).  bf16: both
# sides round each element to bf16 (up to 2^-9 of it each, so up to 2^-8 of
# the row's norm together) and the kernel rounds probabilities to bf16 before
# P.V; 1e-2 leaves room over that and is 10x below a 0.9 scaling.  float32:
# the same sums in another order, ~1e-6.
FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOGITS_F32_TOL = 1e-4  # tests/test_torch_models.py
BF16_SCALE_TOL = 5e-2  # bf16 logits: max |a - b| <= 5e-2 * max |b| (tests/test_torch_models.py)

ARCH = "internlm2-1.8b"
PREFILL_BATCH = 2  # prefill_32k's global batch of 32, cut to 2
PREFILL_SEQ = 32_768  # prefill_32k's length
PREFILL_REPS = 3  # timed prefills after one warm-up
PLAIN_Q_CHUNK = 512  # query rows per step of the plain attention at full size
FLASH_REPS = 5
FLASH_SEQS = (1, 63, 64, 65, 127, 129, 200, 1000)  # 127, 129, 1000: S % 128 != 0

NELL2_DIMS = (12_100, 9_200, 28_800)  # paper Table II
NELL2_NNZ = 76_900_000
NELL2_ZIPF = 0.85
RANK = 16  # paper §V-A2
SWEEPS = 5
RESTARTS = 4
TIMING_REPS = 10

# Phase 9: NELL-2 Table II's dims / 10 and its Zipf 0.85; nonzeros at the
# scale of FROSTT's smaller tensors (LBNL-network 1.7M, NIPS 3.1M).  Every
# request bands to dims (2048, 1024, 4096) and nnz_pad 2^21; ranks 8 and 16
# make two buckets.
SERVE_TRAFFIC = TrafficConfig(
    n_requests=24, base_dims=(1210, 920, 2880), dim_jitter=0.1,
    nnz_range=(1_300_000, 2_200_000), ranks=(8, 16), n_iters=10, zipf_a=0.85, seed=0)
SERVE_MAX_BATCH = 8
SERVE_MAX_INFLIGHT = 2
SERVE_REPLAY_SCALE = 1.0  # the trace's own arrivals: 24 within ~50 ms, a queue forms
# The closed-loop drain submits the trace this many times under new ids (12
# batches), so that its rate is not mostly pipeline fill and drain.  Nothing
# is memoized per request, so a repeated tensor costs what a new one does.
SERVE_DRAIN_ROUNDS = 4
SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep ahead of a launch: ~0.5 s on an H100
# CUDA queues about 1020 launches ahead of the device and then blocks
# the host until there is room (phase 9's launch-queue line).  One served
# sweep queues about 109 device operations, so the check behind a sleep runs
# 4 sweeps: a batch's 10 fill the queue, and that wait is back-pressure, not
# a read of a result.
SLEEP_CHECK_SWEEPS = 4


class SmokeFailure(Exception):
    pass


T_START = time.perf_counter()


def phase(title: str) -> None:
    """Print a phase's title with the seconds since the script started."""
    print(f"{title}  [{time.perf_counter() - T_START:.1f} s]")


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(bufs, facs, mode: int, i_out: int, got: torch.Tensor, tol: float):
    """Kernel output against the plain version on the same inputs.

    Both sides sum the same float32 products in different orders, so the
    error of an output element scales with the size of its sum, not with
    its value, which may cancel to near zero.  The check is therefore
    ``|got - want| <= tol * scale``, where ``scale`` is the same MTTKRP of
    ``|values|`` and ``|factors|`` (the sum of the absolute terms of each
    element).  Returns (max |got - want|, max |got - want| / scale, ok).
    """
    want = mttkrp_plan_ref(bufs, facs, mode, i_out)
    scale = mttkrp_plan_ref(bufs._replace(values=bufs.values.abs()), [f.abs() for f in facs],
                            mode, i_out)
    diff = (got.float() - want).abs()
    if not diff.numel():
        return 0.0, 0.0, True
    max_rel = float((diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max())
    return float(diff.max()), max_rel, bool((diff <= tol * scale).all())


def factors_on(shape, rank, dev, *, batch=None, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    return [
        torch.randn(lead + (s, rank), generator=gen).to(device=dev, dtype=dtype).contiguous()
        for s in shape
    ]


def partition_edge_tensors():
    """The split kernel's partition edges (tests/test_torch_kernel_cuda.py):
    name -> (tensor, rank, tile_nnz, rows_per_block)."""
    rng = np.random.default_rng(8)

    def coo(rows, dims):
        idx = np.stack([rows] + [rng.integers(0, d, rows.size) for d in dims[1:]], 1)
        return tst.SparseTensor(idx.astype(np.int32),
                                rng.standard_normal(rows.size).astype(np.float32), dims)

    hot = coo(np.concatenate([np.zeros(200_000, np.int64), rng.integers(1, 500, 10_000)]),
              (500, 300, 400))
    padding = coo(np.arange(0, 32_000, 16) + rng.integers(0, 16, 2000), (32_000, 50, 60))
    sparse_rows = coo(np.repeat(np.arange(0, 100_000, 50), 100), (100_000, 70, 90))
    few = coo(rng.integers(0, 400, 50), (400, 30, 20))
    return {
        "hot row (200K of 210K nnz on row 0)": (hot, RANK, 256, 256),
        "slice boundaries inside padding": (padding, RANK, 256, 16),
        "empty rows between slices": (sparse_rows, RANK, 128, 64),
        "fewer nonzeros than slices": (few, RANK, 32, 16),
    }


def kernel_cases():
    """(name, tensor, rank, tile_nnz, rows_per_block, batch, dtype, tol)."""
    rng = np.random.default_rng(4)
    one_block = tst.SparseTensor(
        np.stack([rng.integers(0, 16, 3000), rng.integers(0, 40, 3000), rng.integers(0, 40, 3000)],
                 axis=1).astype(np.int32),
        rng.standard_normal(3000).astype(np.float32), (256, 40, 40))
    mid = make_frostt_like("NELL-2", scale=1e-2, seed=1, shuffle=True)
    moderate = tst.random_sparse_tensor((300, 200, 250), 60_000, seed=2, zipf_a=0.8)
    return [
        ("NELL-2-like mid-size (scale 1e-2)", mid, RANK, 256, 256, None, torch.float32, F32_TOL),
        ("empty blocks", tst.SparseTensor(np.array([[0, 0, 0], [1, 1, 1], [250, 2, 2]], np.int32),
                                         np.array([1.0, 2.0, 3.0], np.float32), (300, 4, 4)),
         8, 64, 64, None, torch.float32, F32_TOL),
        ("single nonzero", tst.SparseTensor(np.array([[5, 2, 7]], np.int32),
                                           np.array([2.5], np.float32), (11, 6, 9)),
         8, 256, 64, None, torch.float32, F32_TOL),
        ("rank 1", moderate, 1, 256, 256, None, torch.float32, F32_TOL),
        ("rank 16", moderate, 16, 256, 256, None, torch.float32, F32_TOL),
        ("rank 128", moderate, 128, 256, 256, None, torch.float32, F32_TOL),
        ("every nonzero in one block", one_block, 16, 256, 64, None, torch.float32, F32_TOL),
        ("nnz < tile", tst.random_sparse_tensor((40, 30, 20), 5, seed=13),
         16, 256, 64, None, torch.float32, F32_TOL),
        ("4 modes", tst.random_sparse_tensor((60, 50, 40, 30), 20_000, seed=4, zipf_a=0.7),
         16, 128, 32, None, torch.float32, F32_TOL),
        ("5 modes", tst.random_sparse_tensor((20, 18, 16, 14, 12), 20_000, seed=5),
         8, 128, 32, None, torch.float32, F32_TOL),
        ("bf16 factors", moderate, 16, 256, 256, None, torch.bfloat16, BF16_TOL),
        ("batched factors B=4", moderate, 16, 256, 256, 4, torch.float32, F32_TOL),
        ("rank 13 (unaligned)", moderate, 13, 128, 32, None, torch.float32, F32_TOL),
        ("batched factors B=5", moderate, 16, 64, 16, 5, torch.float32, F32_TOL),
    ] + [(name, t, rank, tile, rpb, None, torch.float32, F32_TOL)
         for name, (t, rank, tile, rpb) in partition_edge_tensors().items()]


def phase_kernel_cases(dev) -> None:
    failures = []
    print(f"  split kernel: {kmod.split_slices(3, 1, torch.float32, dev)} slices (warps) for "
          f"3 modes B=1 float32, {kmod.split_slices(3, 4, torch.float32, dev)} at B=4")
    for name, t, rank, tile, rpb, batch, dtype, tol in kernel_cases():
        facs = factors_on(t.shape, rank, dev, batch=batch, dtype=dtype, seed=t.nnz)
        for mode in range(t.nmodes):
            plan = tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb)
            bufs = ops.plan_device_buffers(plan, dev)
            got = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
            again = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
            block = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode], variant="block")
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(bufs, facs, mode, t.shape[mode], got, tol)
            same = torch.equal(got, again)
            b_abs, b_rel, b_ok = compare(bufs, facs, mode, t.shape[mode], block, tol)
            print(f"  case {name:<36} mode {mode} nnz {t.nnz:>8} rank {rank:>3} "
                  f"split max_abs {max_abs:.3e} max_rel {max_rel:.3e} {'ok' if ok else 'FAIL'}"
                  f"{'' if same else ' (two launches DIFFER)'}, block max_rel {b_rel:.3e} "
                  f"{'ok' if b_ok else 'FAIL'} (tol {tol:g} x scale)")
            if not (ok and same and b_ok):
                failures.append(f"{name} mode {mode}")
    check(not failures, f"a kernel disagrees with its plain version: {failures}")

    # The port's CP-ALS on the card (kernel) against the same run on the CPU (plain version).
    fused_tol = tfused.FUSED_FIT_TOL
    small = tst.random_sparse_tensor((300, 200, 250), 60_000, seed=6, zipf_a=0.8)
    init = tcp.cp_init(small, 8, seed=3, device="cpu")
    on_cpu = tcp.cp_als(small, 8, n_iters=5, tol=0.0, impl="kernel", device="cpu",
                                   init_factors=init)
    on_card = tcp.cp_als(small, 8, n_iters=5, tol=0.0, impl="kernel", device=dev,
                                    init_factors=init)
    gap = float(np.max(np.abs(np.array(on_cpu.fits) - np.array(on_card.fits))))
    print(f"  cp_als small tensor: card fits {on_card.fits} cpu fits {on_cpu.fits} "
          f"max gap {gap:.3e} tol {fused_tol}")
    check(gap <= fused_tol, f"cp_als on the card differs from the CPU run by {gap}")


def profile_sweep(tensor, dev, sweep_ms: float) -> None:
    """Where one eager sweep's time goes: device time by kernel (torch.profiler),
    and the device's idle share of ``sweep_ms``, the sweep's wall time measured
    without the profiler (whose own start-up inflates the traced wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tcp.cp_als(tensor, RANK, n_iters=1, tol=0.0, impl="kernel", device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tcp.cp_als(tensor, RANK, n_iters=1, tol=0.0, impl="kernel", device=dev)
        torch.cuda.synchronize()
    # Device-side entries only (kernels, memcpy, memset), so nothing counts twice.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  one eager sweep: device busy {busy_ms:.2f} ms (profiler) of {sweep_ms:.2f} ms "
          f"wall (unprofiled), idle share {max(0.0, 1 - busy_ms / sweep_ms):.3f}")
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


def mttkrp_bytes(plan, rank: int, nnz: int) -> int:
    """Each input the function needs read once, each output written once
    (``repro_torch.experiments.measure.mttkrp_bytes`` over the tensor's
    ``nnz`` nonzeros and the plan's block offsets).  The plan's padding is
    not counted: the function does not need it, and the split kernel skips
    it by position."""
    return texp_measure.mttkrp_bytes(plan.shape, plan.mode, rank, stream_nnz=nnz,
                                     offsets=plan.num_blocks + 1)


def mttkrp_flops(plan, rank: int, nnz: int) -> int:
    """N-1 factor multiplies, one value multiply and one add per (nonzero, rank)."""
    return nnz * rank * (len(plan.shape) + 1)


def cp_als_phases(dev, card: str) -> tuple[dict, tst.SparseTensor, np.ndarray]:
    """Phases 3-5: the CP-ALS main path at NELL-2 Table II size.  Returns the
    MTTKRP kernel's entry of the ``kernels`` line, the tensor and the fused
    run's fits (restarts x sweeps), for phase 10."""
    # -- phase 3: the main path at Table II size -----------------------------
    phase("phase 3: NELL-2 stand-in at Table II size, rank 16")
    t0 = time.perf_counter()
    tensor = tst.random_sparse_tensor(
        NELL2_DIMS, NELL2_NNZ, seed=0, zipf_a=NELL2_ZIPF, shuffle=True)
    host_data_s = time.perf_counter() - t0
    print(f"  tensor: dims {tensor.shape}, {NELL2_NNZ} drawn, {tensor.nnz} after coalescing, "
          f"host {host_data_s:.2f} s")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(tensor.nmodes) as pool:
        plans = list(pool.map(lambda m: ops.get_plan(tensor, m), range(tensor.nmodes)))
    host_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in plans:
        ops.plan_device_buffers(p, dev)
    ops.tensor_device_operands(tensor, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    split_ctas = kmod.split_slices(tensor.nmodes, 1, torch.float32, dev) // kmod.SPLIT_WARPS_PER_CTA
    for p in plans:
        bufs = ops.plan_device_buffers(p, dev)
        largest = int((bufs.block_real_end - bufs.block_nnz_start[:-1]).max())
        hottest = int(np.bincount(tensor.indices[:, p.mode]).max())
        print(f"  plan mode {p.mode}: {p.num_blocks} output blocks (the block kernel's CTAs for "
              f"one restart), nnz_pad {p.nnz_pad}, padding overhead {p.padding_overhead:.6f}; "
              f"largest block {largest / tensor.nnz:.4f} of nnz ({largest * p.num_blocks / tensor.nnz:.2f}x "
              f"the mean), hottest row {hottest / tensor.nnz:.4f} of nnz; split kernel {split_ctas} "
              f"CTAs x {kmod.SPLIT_WARPS_PER_CTA} slices of {p.nnz_pad / (split_ctas * kmod.SPLIT_WARPS_PER_CTA):.0f} "
              f"nonzeros")
    print(f"  host: plans {host_plan_s:.2f} s (3 threads), upload {upload_s:.2f} s")

    fused_tol = tfused.FUSED_FIT_TOL
    expected = SWEEPS * tensor.nmodes
    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    eager = tcp.cp_als(tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0,
                                  impl="kernel", device=dev)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = kmod.mttkrp_cuda.launches
    t0 = time.perf_counter()
    fused = tfused.cp_als_fused(
        tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, restarts=RESTARTS, fit_every=SWEEPS,
        impl="kernel", device=dev)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    main_launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  eager cp_als: fits {eager.fits}")
    print(f"  eager: {eager_s:.3f} s for {SWEEPS} sweeps ({eager_s / SWEEPS * 1e3:.1f} ms/sweep "
          f"incl. per-sweep fit sync), kernel launches {eager_launches} (expected {expected})")
    for r in range(RESTARTS):
        print(f"  fused restart {r} (seed {fused.seeds[r]}): fits {[float(x) for x in fused.fits[r]]}")
    print(f"  fused: {fused_s:.3f} s for {SWEEPS} sweeps x {RESTARTS} restarts "
          f"({fused_s / SWEEPS * 1e3:.1f} ms/sweep), {fused.sync_count} sync(s), kernel launches "
          f"{main_launches - eager_launches} (expected {expected})")
    print(f"  peak device memory {peak_gb:.2f} GB")
    check(eager_launches == expected, f"eager launched the kernel {eager_launches} times")
    check(main_launches - eager_launches == expected,
          f"fused launched the kernel {main_launches - eager_launches} times")
    print(f"  MTTKRP launches by variant over the main path: {by_variant}")
    check(by_variant["split"] == main_launches,
          f"the main path's MTTKRPs did not all take the split kernel: {by_variant}")
    check(np.isfinite(eager.fits).all() and np.isfinite(fused.fits).all(), "non-finite fit")
    check(all(f.shape == (s, RANK) and bool(torch.isfinite(f).all())
              for f, s in zip(eager.factors, tensor.shape)), "eager factors have the wrong shape or are not finite")
    gap = float(np.max(np.abs(np.array(eager.fits) - fused.fits[0])))
    print(f"  fused restart 0 vs eager (same seed): max fit gap {gap:.3e} (tol {fused_tol})")
    check(gap <= fused_tol, f"fused restart 0 differs from eager by {gap}")

    # -- phase 4: per-mode kernel against plain, and times -------------------
    phase("phase 4: per-mode MTTKRP at the main path's shapes "
          f"(B=1: eager's final factors; B={RESTARTS}: the fused run's initial factors, "
          f"one draw per restart; kernels median of {TIMING_REPS})")
    facs = [f.contiguous() for f in eager.factors]
    inits = [tcp.cp_init(tensor, RANK, seed=s, device=dev) for s in range(RESTARTS)]
    batched = [torch.stack(per_mode).contiguous() for per_mode in zip(*inits)]
    del inits
    rows = []
    for p in plans:
        bufs = ops.plan_device_buffers(p, dev)
        i_out = p.shape[p.mode]
        got = kmod.mttkrp_cuda(bufs, facs, p.mode, i_out)
        got_b = kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)
        same = (torch.equal(got, kmod.mttkrp_cuda(bufs, facs, p.mode, i_out))
                and torch.equal(got_b, kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)))
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(bufs, facs, p.mode, i_out, got, F32_TOL)
        check(got_b.shape == (RESTARTS, i_out, RANK), f"batched output shape {tuple(got_b.shape)}")
        max_abs_b, max_rel_b, ok_b = compare(bufs, batched, p.mode, i_out, got_b, F32_TOL)
        del got, got_b
        ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out), TIMING_REPS)
        ms_b = median_ms(lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out), TIMING_REPS)
        block = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out, variant="block"),
                          TIMING_REPS)
        block_b = median_ms(
            lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out, variant="block"), TIMING_REPS)
        plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, p.mode, i_out), TIMING_REPS, 1)
        nbytes, flops = mttkrp_bytes(p, RANK, tensor.nnz), mttkrp_flops(p, RANK, tensor.nnz)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append(dict(mode=p.mode, ms=ms, ms_b4=ms_b, block_ms=block, block_ms_b4=block_b,
                         plain_ms=plain, bound_ms=bound, bytes=nbytes, flops=flops,
                         max_abs=max(max_abs, max_abs_b), ok=ok and ok_b, same=same))
        print(f"  mode {p.mode}: split {ms:.3f} ms (B={RESTARTS}: {ms_b:.3f} ms), block {block:.3f} ms "
              f"(B={RESTARTS}: {block_b:.3f} ms), plain {plain:.3f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), share of bound {bound / ms:.4f} "
              f"(block {bound / block:.4f}), block / split {block / ms:.2f}x; B=1 max_abs "
              f"{max_abs:.3e} max_rel {max_rel:.3e} {'ok' if ok else 'FAIL'}, B={RESTARTS} "
              f"max_abs {max_abs_b:.3e} max_rel {max_rel_b:.3e} {'ok' if ok_b else 'FAIL'} "
              f"(tol {F32_TOL:g} x scale); two launches bit for bit "
              f"{'equal' if same else 'DIFFER'}  [{card}]")
    check(all(r["ok"] for r in rows), "kernel disagrees with its plain version at full size")
    check(all(r["same"] for r in rows), "two launches of the split kernel differ")
    del batched
    bytes_bound = all(r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS_PER_S for r in rows)

    # -- phase 5: where the time of a sweep goes --------------------------------
    phase("phase 5: profile of one eager sweep")
    profile_sweep(tensor, dev, eager_s / SWEEPS * 1e3)
    print(f"  host: data {host_data_s:.1f} s, plans {host_plan_s:.1f} s")
    kern = dict(
        name="mttkrp_split_kernel",
        route="cuda",
        source="src/repro_torch/kernels/mttkrp/csrc/mttkrp_split.cu",
        replaces="src/repro/kernels/mttkrp/kernel.py:44",
        launches=main_launches,
        max_abs_err=max(r["max_abs"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        previous_ms=sum(r["block_ms"] for r in rows),
        previous="mttkrp_block_kernel, csrc/mttkrp.cu (one CTA per output block)",
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by="bytes" if bytes_bound else "operations",
        library_ms=None,
        per="one CP-ALS sweep of MTTKRPs: modes 0-2, one restart",
        per_mode_ms=[r["ms"] for r in rows],
        per_mode_ms_b4=[r["ms_b4"] for r in rows],
        per_mode_previous_ms=[r["block_ms"] for r in rows],
        per_mode_previous_ms_b4=[r["block_ms_b4"] for r in rows],
        split_ctas=split_ctas,
        launches_by_variant=by_variant,
    )
    return kern, tensor, fused.fits


ORDERINGS = ("lex", "secondary-sort", "degree", "blocked")
# Phase 10 runs blocked right after lex (whose plans are phase 3's), so
# that the tile mode's profile on blocked plans is the phase's only one
# and comes before the other orderings' plan builds.
PHASE10_ORDER = ("lex", "blocked", "secondary-sort", "degree")


def device_ms_by_kernel(fn, launches: int, tries: int = 3) -> dict:
    """Device ms and launch count by kernel in one call of ``fn``
    (torch.profiler), keyed "carry" for the carry pass and "main" for the
    rest.  Within this script the profiler has recorded fewer launches than
    ``fn`` made (PERF.md §7), so the call is profiled again, up to ``tries``
    times, until each kernel shows ``launches``; the last reading is
    returned either way, its counts beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                key = "carry" if "carry" in e.key else "main"
                ms, n = out.get(key, (0.0, 0))
                out[key] = (ms + e.self_device_time_total / 1e3, n + e.count)
        if set(out) == {"main", "carry"} and all(n == launches for _, n in out.values()):
            break
    return {k: dict(ms=ms, launches=n) for k, (ms, n) in out.items()}


def ordering_phase(dev, card: str, tensor, lex_fits: np.ndarray) -> dict:
    """Phase 10: each nonzero ordering at NELL-2 Table II size, phase 3's
    tensor.  Per ordering: the ordered plans (the order sorted on the card,
    held array-equal to the CPU's on mode 0), their contiguity flag, each
    mode's split kernel (in the mode its plan picks) against the plain
    version with a bit-for-bit repeat, at B=1 and at B=RESTARTS (the fused
    run's initial factors, as phase 4), the times of the split kernel in
    both modes, the block kernel and the plain version beside the bound,
    and a fused CP-ALS run whose fits must stay within FUSED_FIT_TOL of
    phase 3's lex run.  On the blocked plans, one profiled sweep splits the
    tile mode's time between its two launches.  Each ordering's plans are
    freed before the next."""
    phase(f"phase 10: the orderings {ORDERINGS} at NELL-2 Table II size, rank {RANK}")
    ctas, warps = kmod.tile_grid(tensor.nmodes, 256, torch.float32, dev)
    print(f"  tile mode: {ctas} CTAs x {warps} warps ({ctas * warps} slices, "
          f"{ctas * warps // torch.cuda.get_device_properties(dev).multi_processor_count} warps "
          f"per SM); row-run mode: {kmod.split_slices(tensor.nmodes, 1, torch.float32, dev)} slices")
    idx_dev = torch.as_tensor(tensor.indices, device=dev)
    results, launches = {}, collections.Counter()
    for o in PHASE10_ORDER:
        t_start = time.perf_counter()
        if o != "lex":  # lex keeps phase 3's plans (its host argsort), memoized
            ops.clear_caches()
            gc.collect()
        # The order on the card, timed by CUDA events, then held against the CPU's.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        orders = [tstrat.nonzero_order_tensor(idx_dev, tensor.shape, m, o)
                  for m in range(tensor.nmodes)]
        end.record()
        end.synchronize()
        order_ms = start.elapsed_time(end)
        t0 = time.perf_counter()
        on_cpu = tstrat.nonzero_order(tensor, 0, o, device="cpu")
        cpu_order_s = time.perf_counter() - t0
        same_order = bool(np.array_equal(orders[0].cpu().numpy(), on_cpu))
        del orders, on_cpu
        t0 = time.perf_counter()
        with ThreadPoolExecutor(tensor.nmodes) as pool:
            plans = list(pool.map(lambda m: ops.get_plan(tensor, m, ordering=o, device=dev),
                                  range(tensor.nmodes)))
        bufs_all = [ops.plan_device_buffers(p, dev) for p in plans]
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        print(f"  {o}: order on the card {order_ms:.2f} ms device for 3 modes (mode 0 array-equal "
              f"to the CPU's: {same_order}, CPU {cpu_order_s:.2f} s); plans + upload "
              f"{plan_s:.2f} s host{' (phase 3 memo)' if o == 'lex' else ''}; rows contiguous "
              f"{[p.rows_contiguous for p in plans]}; padding overhead "
              f"{[round(p.padding_overhead, 6) for p in plans]}")
        check(same_order, f"{o}: the card's order differs from the CPU's")
        facs = tcp.cp_init(tensor, RANK, seed=7, device=dev)
        inits = [tcp.cp_init(tensor, RANK, seed=s, device=dev) for s in range(RESTARTS)]
        batched = [torch.stack(per_mode).contiguous() for per_mode in zip(*inits)]
        del inits
        rows = []
        for p, bufs in zip(plans, bufs_all):
            i_out = p.shape[p.mode]
            mode_name = kmod.split_mode_for(bufs, None)
            got = kmod.mttkrp_cuda(bufs, facs, p.mode, i_out)
            got_b = kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)
            same = (torch.equal(got, kmod.mttkrp_cuda(bufs, facs, p.mode, i_out))
                    and torch.equal(got_b, kmod.mttkrp_cuda(bufs, batched, p.mode, i_out)))
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(bufs, facs, p.mode, i_out, got, F32_TOL)
            check(got_b.shape == (RESTARTS, i_out, RANK), f"batched output shape {tuple(got_b.shape)}")
            max_abs_b, max_rel_b, ok_b = compare(bufs, batched, p.mode, i_out, got_b, F32_TOL)
            del got, got_b
            ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out), TIMING_REPS)
            ms_b = median_ms(lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out), TIMING_REPS)
            tiles = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out,
                                                       split_mode="tiles"), TIMING_REPS)
            block = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out, variant="block"),
                              TIMING_REPS)
            plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, p.mode, i_out), TIMING_REPS, 1)
            nbytes, flops = mttkrp_bytes(p, RANK, tensor.nnz), mttkrp_flops(p, RANK, tensor.nnz)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
            rows.append(dict(mode=p.mode, split_mode=mode_name, ms=ms, ms_b4=ms_b, tiles_ms=tiles,
                             block_ms=block, plain_ms=plain, bound_ms=bound,
                             max_abs=max(max_abs, max_abs_b), ok=ok and ok_b, same=same))
            print(f"    mode {p.mode}: split ({mode_name}) {ms:.3f} ms (B={RESTARTS}: {ms_b:.3f} ms), "
                  f"tile mode {tiles:.3f} ms, block {block:.3f} ms, plain {plain:.3f} ms, bound "
                  f"{bound:.4f} ms (share {bound / ms:.4f}); B=1 max_abs {max_abs:.3e} max_rel "
                  f"{max_rel:.3e} {'ok' if ok else 'FAIL'}, B={RESTARTS} max_abs {max_abs_b:.3e} "
                  f"max_rel {max_rel_b:.3e} {'ok' if ok_b else 'FAIL'} (tol {F32_TOL:g} x scale); "
                  f"two launches bit for bit {'equal' if same else 'DIFFER'}  [{card}]")
        tile_split = {}
        if o == "blocked":  # the tile mode's two launches apart, one sweep at B=1
            tile_split = device_ms_by_kernel(lambda: [
                kmod.mttkrp_cuda(b, facs, p.mode, p.shape[p.mode]) for p, b in zip(plans, bufs_all)],
                launches=len(plans))
            print(f"    profile of one B=1 sweep in the tile mode ({len(plans)} launches of each): " + (
                ", ".join(f"{k} {v['ms']:.3f} ms over {v['launches']} recorded launches"
                          for k, v in tile_split.items()) or "not measured") + f"  [{card}]")
        del facs, batched
        check(all(r["ok"] for r in rows), f"{o}: the split kernel disagrees with plain")
        check(all(r["same"] for r in rows), f"{o}: two launches of the split kernel differ")
        # The path: fused CP-ALS with this ordering, launches counted.
        kmod.reset_launch_counts()
        t0 = time.perf_counter()
        run = tfused.cp_als_fused(tensor, RANK, n_iters=SWEEPS, tol=0.0, seed=0, restarts=RESTARTS,
                                  fit_every=SWEEPS, impl="kernel", device=dev, ordering=o)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
        by_mode = dict(kmod.mttkrp_cuda.launches_by_mode)
        gap = float(np.max(np.abs(run.fits - lex_fits)))
        want_mode = "tiles" if o == "blocked" else "rows"
        print(f"    cp_als_fused(ordering={o!r}, restarts={RESTARTS}, impl='kernel'): {fused_s:.3f} s "
              f"for {SWEEPS} sweeps, final fits {[round(float(f), 6) for f in run.fits[:, -1]]}, "
              f"max gap to phase 3's lex fits {gap:.3e} (tol {tfused.FUSED_FIT_TOL}); launches by "
              f"variant {by_variant}, by mode {by_mode}")
        check(np.isfinite(run.fits).all() and gap <= tfused.FUSED_FIT_TOL,
              f"{o}: fused fits differ from lex by {gap}")
        expected = SWEEPS * tensor.nmodes
        check(by_variant == {"split": expected, "block": 0} and by_mode[want_mode] == expected,
              f"{o}: the path's MTTKRPs did not all take the split kernel's {want_mode} mode")
        launches[want_mode] += expected
        results[o] = dict(rows=rows, order_ms=order_ms, plan_s=plan_s, fused_s=fused_s,
                          fit_gap=gap, launches_by_mode=by_mode, tile_split_ms=tile_split,
                          rows_contiguous=[p.rows_contiguous for p in plans],
                          padding_overhead=[p.padding_overhead for p in plans],
                          seconds=time.perf_counter() - t_start)
        del plans, bufs_all, run
    ops.clear_caches()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(results=results, launches=dict(launches))


def flash_cases(dev) -> None:
    """Phase 6: each flash kernel against its plain version over edge shapes."""
    def inputs():
        for dtype, s, causal, (h, kvh), d, b in itertools.product(
                (torch.float32, torch.bfloat16), FLASH_SEQS, (True, False),
                ((4, 4), (4, 2), (4, 1), (16, 8)), (64, 128), (1, 3)):
            gen = torch.Generator(device=dev).manual_seed(s * 7 + h + d + b)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
            yield f"{dtype} S={s} causal={causal} H={h} KV={kvh} D={d} B={b}", q, k, v, causal
        # q, k, v as views of one fused projection: strided rows, q not contiguous.
        for s, causal, d in itertools.product((129, 1000), (True, False), (64, 128)):
            gen = torch.Generator(device=dev).manual_seed(s + d)
            fused = torch.randn((2, s, 16 + 2 * 8, d), generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = fused[:, :, :16], fused[:, :, 16:24], fused[:, :, 24:]
            check(not q.is_contiguous(), "the strided case's q is contiguous")
            yield f"strided bf16 S={s} causal={causal} H=16 KV=8 D={d} B=2", q, k, v, causal

    failures, worst, worst_row, count = [], {}, {}, {}
    for name, q, k, v, causal in inputs():
        tol = FLASH_F32_TOL if q.dtype == torch.float32 else BF16_TOL
        want = flash_attention_plain(q, k, v, causal=causal)
        routed = fkmod.variant_for(q.dtype, q.shape[3])
        for variant in (routed, "mma") if q.dtype == torch.bfloat16 else (routed,):
            got = fkmod.flash_attention_cuda(q, k, v, causal=causal, variant=variant)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            row_err = max_row_error(got, want)
            ok = (bool((diff <= tol + tol * want.float().abs()).all()) and got.shape == q.shape
                  and row_err <= FLASH_ROW_TOL[q.dtype])
            worst[variant] = max(worst.get(variant, 0.0), float(diff.max()))
            worst_row[variant] = max(worst_row.get(variant, 0.0), row_err)
            count[variant] = count.get(variant, 0) + 1
            if not ok:
                failures.append(f"{variant}: {name}")
    for variant, err in worst.items():
        dtype = torch.float32 if variant == "f32" else torch.bfloat16
        print(f"  {variant} kernel ({dtype}): {count[variant]} cases, max row error "
              f"{worst_row[variant]:.3e} (tol {FLASH_ROW_TOL[dtype]:g}), max |kernel - plain| "
              f"{err:.3e} (tol {FLASH_F32_TOL if variant == 'f32' else BF16_TOL:g} abs + rel)")
    check(not failures, f"flash kernels disagree with their plain version: {failures[:10]}")


def first_key_tile_dropped(q, k, v, rows: int, tile: int = 64) -> torch.Tensor:
    """The plain causal attention of the last ``rows`` queries with keys
    ``[0, tile)`` left out: what a kernel whose KV loop skipped its first
    tile would write for them.  (B, rows, H, D) in q's dtype."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    ks, vs = (t[:, tile:].float().repeat_interleave(group, dim=2) for t in (k, v))
    scores = torch.einsum("brhd,bshd->bhrs", q[:, s - rows:].float(), ks) * d**-0.5
    qpos = torch.arange(s - rows, s, device=q.device)
    kpos = torch.arange(tile, s, device=q.device)
    scores.masked_fill_(kpos[None, :] > qpos[:, None], NEG_INF)
    return torch.einsum("bhrs,bshd->brhd", torch.softmax(scores, dim=-1), vs).to(q.dtype)


def flash_full_shape_check(q, k, v) -> dict:
    """Phase 8's comparison: both bf16 kernels on the main path's q, k, v
    against their plain version by the row limit and by the JAX tests'
    elementwise one, then the same readings of two planted faults in the
    wgmma kernel's output, which the row limit must reject: rows t >= S/2
    scaled by 0.9, and the last 64 rows computed without the first 64 keys."""
    got = fkmod.flash_attention_cuda(q, k, v, causal=True)
    previous = fkmod.flash_attention_cuda(q, k, v, causal=True, variant="mma")
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True, q_chunk=PLAIN_Q_CHUNK)
    s = q.shape[1]

    def readings(out):
        diff = (out.float() - want.float()).abs()
        within = bool((diff <= BF16_TOL + BF16_TOL * want.float().abs()).all())
        return dict(max_abs=float(diff.max()), row=max_row_error(out, want), elementwise_ok=within)

    sound, sound_previous = readings(got), readings(previous)
    del previous
    scaled = got.clone()
    scaled[:, s // 2:] *= 0.9
    skipped = got.clone()
    skipped[:, s - 64:] = first_key_tile_dropped(q, k, v, 64)
    rms = {f"rows {a}-{z - 1}": float(want[:, a:z].float().pow(2).mean().sqrt())
           for a, z in ((0, 64), (s - 1024, s))}
    return dict(sound=sound, sound_previous=sound_previous, rms=rms, planted={
        "rows t >= S/2 scaled by 0.9": readings(scaled),
        "last 64 rows without the first 64 keys": readings(skipped)})


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> int:
    """Two products of 2*D flops per (query, key) pair the inputs need: for
    causal attention only the triangle, S(S+1)/2 pairs per (b, h)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * d * pairs * b * h


def prefill_matmul_flops(cfg, tokens: int) -> int:
    """The products outside the kernel per prefill: q/k/v and output
    projections, SwiGLU's three, and the lm_head over every position."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (2 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                 + 2 * cfg.num_heads * hd * d + 6 * d * cfg.d_ff)
    return tokens * (cfg.num_layers * per_layer + 2 * d * cfg.padded_vocab)


def logits_gap(got: torch.Tensor, want: torch.Tensor, vocab: int):
    """(max |got - want|, max |want|) over the real vocabulary (padded
    entries are both -1e9, where one bf16 ulp is 4e6)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max()), float(want.abs().max())


def profile_prefill(prefill, model, batch, prefill_ms: float, matmul_flops: int) -> dict:
    """Device time of one prefill by kernel class, and the idle share of
    ``prefill_ms`` (the unprofiled median)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(model, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"flash": 0.0, "matmul (cuBLAS)": 0.0, "rest": 0.0}
    for e in events:
        name = e.key.lower()
        if "flash_fwd" in name:
            key = "flash"
        elif any(t in name for t in ("gemm", "sm90_", "cutlass", "nvjet", "xmma")):
            key = "matmul (cuBLAS)"
        else:
            key = "rest"
        classes[key] += e.self_device_time_total / 1e3
    busy = sum(classes.values())
    print(f"  one prefill: device busy {busy:.2f} ms (profiler) of {prefill_ms:.2f} ms wall "
          f"(unprofiled), idle share {max(0.0, 1 - busy / prefill_ms):.3f}")
    for key, ms in classes.items():
        print(f"    {key:<16} {ms:10.2f} ms  {ms / busy:6.1%} of device time")
    print(f"    matmul rate: {matmul_flops:.3e} flops per prefill, "
          f"{matmul_flops / classes['matmul (cuBLAS)'] / 1e9:.1f} TFLOP/s")
    for e in events[:10]:
        print(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5} {e.key[:90]}")
    return dict(busy_ms=busy, **{k.split()[0] + "_ms": v for k, v in classes.items()})


def lm_phases(dev, card: str) -> dict:
    """Phases 6-8: the flash kernels' edge cases, the internlm2-1.8b prefill at
    full width and depth, and both bf16 kernels at the main path's shape; the
    wgmma flash kernel's entry of the ``kernels`` line."""
    phase("phase 6: flash kernels vs plain version on the card")
    flash_cases(dev)

    phase(f"phase 7: {ARCH} prefill, full width and depth, B={PREFILL_BATCH} S={PREFILL_SEQ}")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  init_model(seed=0): {cfg.param_count() / 1e9:.3f}e9 parameters (param_count), "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
          f"float32, {time.perf_counter() - t0:.2f} s")
    stream = SyntheticLMStream(cfg.vocab_size, PREFILL_SEQ, PREFILL_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(next(stream)["tokens"]).to(dev)}
    prefill = make_prefill_fn(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times, walls = [], []
    fkmod.reset_launch_counts()  # the main path starts here
    for rep in range(1 + PREFILL_REPS):
        before = fkmod.flash_attention_cuda.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = prefill(model, batch)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        grew = fkmod.flash_attention_cuda.launches - before
        check(grew == cfg.num_layers, f"prefill {rep} launched the flash kernel {grew} times")
        if rep:
            times.append(start.elapsed_time(end))
            walls.append(wall)
    main_launches = fkmod.flash_attention_cuda.launches  # the main path ends here
    by_variant = dict(fkmod.flash_attention_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = float(np.median(times))
    tokens = PREFILL_BATCH * PREFILL_SEQ
    check(logits.shape == (PREFILL_BATCH, cfg.padded_vocab), f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite next-token logits")
    check(bool((logits[:, cfg.vocab_size:] < -1e8).all()), "padded vocabulary not masked")
    print(f"  prefill: median {prefill_ms:.2f} ms (CUDA events; runs {[round(t, 2) for t in times]}), "
          f"host wall {[round(w, 2) for w in walls]} ms, {tokens / prefill_ms * 1e3:.0f} tokens/s; "
          f"flash launches {main_launches} over {1 + PREFILL_REPS} prefills "
          f"({cfg.num_layers} each); peak device memory {peak_gb:.2f} GB  [{card}]")
    per_prefill = {k_: n / (1 + PREFILL_REPS) for k_, n in by_variant.items()}
    print(f"  flash launches per prefill by variant: {per_prefill}")
    check(by_variant["wgmma"] == main_launches,
          f"the prefill's flash launches did not all take the wgmma kernel: {by_variant}")
    print(f"  next-token argmax {logits.float().argmax(-1).tolist()}, "
          f"max |logit| {float(logits[:, :cfg.vocab_size].float().abs().max()):.3f}")
    del logits

    # The same model at S = 256: the kernel (blocked) against plain torch (dense).
    short = {"tokens": torch.from_numpy(next(SyntheticLMStream(cfg.vocab_size, 256, 2, seed=1))
                                        ["tokens"]).to(dev)}
    with torch.inference_mode():
        blocked = forward(model, dataclasses.replace(cfg, attention_impl="blocked"), short)
        dense = forward(model, dataclasses.replace(cfg, attention_impl="dense"), short)
    gap, scale = logits_gap(blocked, dense, cfg.vocab_size)
    print(f"  S=256 full model, blocked (kernel) vs dense (plain torch): max |gap| {gap:.4f} "
          f"of max |logit| {scale:.3f} (tol {BF16_SCALE_TOL} x scale)")
    check(gap <= BF16_SCALE_TOL * scale, "blocked and dense logits differ at S=256")
    del blocked, dense

    # A reduced config: the port's forward on the card against the CPU.
    for dtype, tol in ((torch.float32, None), (torch.bfloat16, BF16_SCALE_TOL)):
        small = reduced_config(ARCH, num_kv_heads=2, attention_impl="blocked", dtype=dtype)
        small_model = init_model(small, seed=1, device="cpu")
        toks = {"tokens": next(SyntheticLMStream(small.vocab_size, 300, 2, seed=2))["tokens"]}
        with torch.inference_mode():
            want = forward(small_model, small, toks)
            got = forward(small_model.to(dev), small, toks).cpu()  # moves the module
        gap, scale = logits_gap(got, want, small.vocab_size)
        limit = LOGITS_F32_TOL if tol is None else tol * scale
        print(f"  reduced config {dtype}: card vs CPU max |gap| {gap:.3e} of max |logit| "
              f"{scale:.3f} (limit {limit:.3e})")
        check(gap <= limit, f"reduced-config forward in {dtype}: card differs from CPU")

    phase("phase 8: the bf16 flash kernels at the main path's shape (layer 0's q, k, v)")
    layer = model.layers[0]
    with torch.inference_mode():
        x = model.embed[batch["tokens"].long()].to(cfg.dtype)
        q, k, v = project_qkv(layer.attn.params(), cfg, layer.ln1(x, cfg.norm_eps))
    del x
    b, s, h, d = q.shape
    found = flash_full_shape_check(q, k, v)
    row_tol = FLASH_ROW_TOL[q.dtype]
    for label, sound in (("wgmma", found["sound"]), ("mma", found["sound_previous"])):
        ok = sound["row"] <= row_tol and sound["elementwise_ok"]
        print(f"  {label} kernel: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}, over all (b, h): "
              f"max row error {sound['row']:.3e} (tol {row_tol:g}), max |kernel - plain| "
              f"{sound['max_abs']:.3e} (tol {BF16_TOL:g} abs + rel: "
              f"{'ok' if sound['elementwise_ok'] else 'FAIL'}) {'ok' if ok else 'FAIL'}")
        check(ok, f"the {label} flash kernel disagrees with its plain version at the main path's shape")
    sound = found["sound"]
    print("  rms of the plain output: " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in found["rms"].items()))
    for fault, r in found["planted"].items():
        print(f"  planted fault in the wgmma kernel's output, {fault}: max row error {r['row']:.3e} "
              f"({'rejected' if r['row'] > row_tol else 'NOT rejected'}); the elementwise "
              f"tol alone would {'pass' if r['elementwise_ok'] else 'reject'} it")
        check(r["row"] > row_tol, f"the row limit does not reject a planted fault: {fault}")
    ms = median_ms(lambda: fkmod.flash_attention_cuda(q, k, v, causal=True), FLASH_REPS)
    previous_ms = median_ms(
        lambda: fkmod.flash_attention_cuda(q, k, v, causal=True, variant="mma"), FLASH_REPS)
    plain_ms = median_ms(
        lambda: flash_attention_plain(q, k, v, causal=True, q_chunk=PLAIN_Q_CHUNK), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), FLASH_REPS)
    flops = attention_flops(b, s, h, d, True)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"  wgmma kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), mma.sync kernel "
          f"{previous_ms:.3f} ms ({flops / previous_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.1f} ms, "
          f"SDPA {library_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} ({flops:.3e} flops "
          f"at 989 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s), share of bound "
          f"{bound_ms / ms:.3f} (mma.sync {bound_ms / previous_ms:.3f})  [{card}]")
    check(ms < previous_ms, f"the wgmma kernel ({ms:.3f} ms) is not faster than mma.sync "
                            f"({previous_ms:.3f} ms)")
    del q, k, v, qt, kt, vt
    prof = profile_prefill(prefill, model, batch, prefill_ms,
                           prefill_matmul_flops(cfg, PREFILL_BATCH * PREFILL_SEQ))
    return dict(
        name="flash_fwd_sm90_kernel",
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:24",
        launches=main_launches,
        max_abs_err=sound["max_abs"],
        max_row_err=sound["row"],
        ms=ms,
        previous_ms=previous_ms,
        previous="flash_fwd_bf16_kernel, csrc/flash_attention.cu (mma.sync)",
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=library_ms,
        per=f"one layer's causal attention, B={b} S={s} H={h} KV={cfg.num_kv_heads} D={d} bf16",
        launches_per_prefill=cfg.num_layers,
        launches_by_variant=by_variant,
        prefill_ms=prefill_ms,
        prefill_tokens_per_s=tokens / prefill_ms * 1e3,
        prefill_peak_gb=peak_gb,
        prefill_profile_ms=prof,
    )


def service_summary(svc, wall_s: float) -> dict:
    """Requests/s, latency percentiles and batches of one service run."""
    resps = list(svc.completed.values())
    batches = collections.Counter((r.dispatch_t, r.signature) for r in resps)
    summary = {key: svc.metrics.summary(key) for key in ("latency_s", "queue_wait_s", "service_s")}
    return dict(requests=len(resps), wall_s=wall_s, requests_per_s=len(resps) / wall_s,
                batches=len(batches), batch_sizes=sorted(batches.values(), reverse=True),
                max_queue_depth=max(svc.metrics.values("queue_depth")),
                **{f"{k[:-2]}_{stat}_ms": v[stat] * 1e3 for k, v in summary.items()
                   for stat in ("p50", "p99")})


def profile_batch(executor, members, batch_ms: float) -> dict:
    """Device time of one batch by kernel class: its staging (uploads and the
    stacked plans' build) and its ``run_batch``; the idle share is of
    ``batch_ms``, the unprofiled wall time of both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_stage:
        *operands, plans = executor.stage(members, pad_to=SERVE_MAX_BATCH)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        executor.core.run_batch(*operands, n_iters=executor.signature.n_iters, plans=plans)
        torch.cuda.synchronize()
    stage_events = [e for e in prof_stage.key_averages() if e.device_type == DeviceType.CUDA]
    stage_ms = {"uploads (memcpy HtoD)": 0.0, "plan build (sort, scatter, rest)": 0.0}
    for e in stage_events:
        key = "uploads (memcpy HtoD)" if "memcpy" in e.key.lower() else \
            "plan build (sort, scatter, rest)"
        stage_ms[key] += e.self_device_time_total / 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    classes = {"split kernel": 0.0, "carry pass": 0.0, "fit gathers": 0.0,
               "products (mul, GEMM/GEMV)": 0.0, "solves": 0.0, "rest": 0.0}
    for e in events:
        name = e.key.lower()
        if "mttkrp_split_kernel" in name:
            key = "split kernel"
        elif "mttkrp_carry_kernel" in name:
            key = "carry pass"
        elif "index" in name or "gather" in name:
            key = "fit gathers"
        elif any(t in name for t in ("getrf", "getrs", "trsm", "lu_", "laswp", "solve", "magma",
                                     "cusolver", "batch_")):
            key = "solves"
        elif any(t in name for t in ("mulfunctor", "gemm", "gemv", "dot", "nvjet", "sm90_",
                                     "cutlass")):
            key = "products (mul, GEMM/GEMV)"
        else:
            key = "rest"
        classes[key] += e.self_device_time_total / 1e3
    classes = {**{f"staging: {k}": v for k, v in stage_ms.items()}, **classes}
    busy = sum(classes.values())
    print(f"  one batch, staged and run (B={SERVE_MAX_BATCH}, {executor.signature.n_iters} "
          f"sweeps): device busy {busy:.2f} ms (profiler) of {batch_ms:.2f} ms wall "
          f"(unprofiled), idle share {max(0.0, 1 - busy / batch_ms):.3f}")
    for key, ms in classes.items():
        print(f"    {key:<40} {ms:9.3f} ms  {ms / busy:6.1%} of device time")
    stage_events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for label, evs in (("staging", stage_events[:6]), ("run_batch", events[:12])):
        for e in evs:
            print(f"    {label:<9} {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
                  f"{e.key[:80]}")
    return dict(busy_ms=busy, **{k.split(" (")[0].replace("staging: ", "stage_")
                                 .replace(" ", "_") + "_ms": v for k, v in classes.items()})


def behind_a_sleep(fn, cycles: int = SLEEP_CYCLES):
    """Run ``fn`` behind ``cycles`` of queued device work (~0.5 s by
    default).  Returns ``(result, host ms of the call, whether the sleep had
    ended when it returned)``: a call that synchronises with the device
    returns only after the sleep."""
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    slept = torch.cuda.Event()
    slept.record()
    t0 = time.perf_counter()
    out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ended = slept.query()
    torch.cuda.synchronize()
    return out, host_ms, ended


def host_waits(dev, dims) -> None:
    """Where the host waits for the device on the service's path: the ALS
    solve at a batch's shapes by PyTorch's default route and by the port's
    (``cp_als._solve``, which must never wait), and how many launches the
    launch queue takes before it blocks the host."""
    gen = torch.Generator().manual_seed(0)
    waits = {"default": [], "port": []}
    for rank in SERVE_TRAFFIC.ranks:
        for rows in sorted(set(dims)):
            f = torch.rand((SERVE_MAX_BATCH, 64, rank), generator=gen)
            a = (f.mT @ f + 1e-2 * torch.eye(rank)).to(dev)
            b = torch.randn((SERVE_MAX_BATCH, rank, rows), generator=gen).to(dev)
            routes = {"default": lambda: torch.linalg.solve_ex(a, b, check_errors=False),
                      "port": lambda: tcp._solve(a, b)}
            for route, fn in routes.items():
                fn()  # the first call loads the library
                if behind_a_sleep(fn, SLEEP_CYCLES // 5)[2]:
                    waits[route].append((rank, rows))
    print(f"  ALS solves of {SERVE_MAX_BATCH} systems (rank, right-hand sides) that waited for a "
          f"queued sleep: PyTorch's default route {waits['default']}, the port's {waits['port']}")
    check(not waits["port"], f"the port's solve waited for the device at {waits['port']}")
    x = torch.zeros(16, device=dev)
    queued = {}
    for n in (512, 1000, 1020, 1024, 1100):
        queued[n] = not behind_a_sleep(lambda: [x.add_(1.0) for _ in range(n)],
                                       SLEEP_CYCLES // 5)[2]
    print(f"  launch queue: n tiny kernels behind a sleep, did the host get back first? {queued}")


def service_phase(dev, card: str) -> dict:
    """Phase 9: the multi-tenant CP-ALS service at a real size; what it adds
    to the MTTKRP kernel's entry of the ``kernels`` line."""
    cfg = SERVE_TRAFFIC
    phase(f"phase 9: the CP-ALS service, {cfg.n_requests} requests, dims ~{cfg.base_dims} "
          f"(NELL-2 / 10), {cfg.nnz_range} drawn nonzeros, ranks {cfg.ranks}, "
          f"{cfg.n_iters} sweeps, max_batch {SERVE_MAX_BATCH}, max_inflight {SERVE_MAX_INFLIGHT}")
    t0 = time.perf_counter()
    trace = synthetic_trace(cfg)
    draw_s = time.perf_counter() - t0
    reqs = [r for _, r in trace]
    sigs = {r.request_id: bucket_signature(r) for r in reqs}
    nnz = [r.tensor.nnz for r in reqs]
    print(f"  trace: {len(reqs)} requests, {min(nnz)}-{max(nnz)} nonzeros after coalescing, "
          f"arrivals over {trace[-1][0] * 1e3:.1f} ms; host draw {draw_s:.2f} s")
    for sig, n in sorted(collections.Counter(sigs.values()).items()):
        print(f"  bucket dims {sig.dims} nnz_pad {sig.nnz_pad} rank_pad {sig.rank_pad} "
              f"n_iters {sig.n_iters}: {n} requests")

    # Off the clock: one batch per bucket through a throwaway service, so the
    # drain does not time the first use of each library kernel.  It leaves
    # nothing of its requests behind: the drain uploads and plans each anew.
    warm = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                device=dev)
    for sig in set(sigs.values()):
        first = next(r for r in reqs if sigs[r.request_id] == sig)
        warm.submit(dataclasses.replace(first, request_id=first.request_id + "-warm"))
    warm.run_until_drained()

    # -- the main path: a closed-loop drain, then an open-loop replay ---------
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_counts()  # the main path starts here
    drain = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                 device=dev)
    drained = [dataclasses.replace(r, request_id=f"{r.request_id}-d{k}")
               for k in range(SERVE_DRAIN_ROUNDS) for r in reqs]
    t0 = time.perf_counter()
    for r in drained:
        check(drain.submit(r), f"{r.request_id} refused")
    done = drain.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    replay_trace_ = [(a, dataclasses.replace(r, request_id=r.request_id + "-replay"))
                     for a, r in trace]
    replay = DecompositionService(max_batch=SERVE_MAX_BATCH, max_inflight=SERVE_MAX_INFLIGHT,
                                  device=dev)
    t0 = time.perf_counter()
    replayed = replay_trace(replay, replay_trace_, time_scale=SERVE_REPLAY_SCALE)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    runs = {"closed-loop drain": (drain, drain_s), f"replay at time_scale {SERVE_REPLAY_SCALE}":
            (replay, replay_s)}
    stats = {}
    for label, (svc, wall) in runs.items():
        st = stats[label] = service_summary(svc, wall)
        print(f"  {label}: {st['requests']} answered in {wall:.3f} s, "
              f"{st['requests_per_s']:.2f} requests/s; latency p50 {st['latency_p50_ms']:.1f} ms "
              f"p99 {st['latency_p99_ms']:.1f} ms, queue wait p50 {st['queue_wait_p50_ms']:.1f} "
              f"p99 {st['queue_wait_p99_ms']:.1f} ms, service p50 {st['service_p50_ms']:.1f} "
              f"p99 {st['service_p99_ms']:.1f} ms; {st['batches']} batches of "
              f"{st['batch_sizes']} real requests; max queue depth at a completion "
              f"{st['max_queue_depth']:.0f}  [{card}]")
    batches = sum(st["batches"] for st in stats.values())
    expected = batches * cfg.n_iters * len(cfg.base_dims)
    print(f"  MTTKRP launches over the service: {by_variant} (expected {expected} split = "
          f"{batches} batches x {cfg.n_iters} sweeps x {len(cfg.base_dims)} modes, 0 block); "
          f"peak device memory {peak_gb:.2f} GB")
    check(by_variant == {"split": expected, "block": 0} and launches == expected,
          f"the service's MTTKRPs were not one split launch per mode per sweep per batch: "
          f"{by_variant}")
    check(stats[f"replay at time_scale {SERVE_REPLAY_SCALE}"]["max_queue_depth"] >= 1,
          "the replay never found a queue: raise its arrival rate")

    # (d) every request answered once, pad slots dropped.
    for label, (svc, _) in runs.items():
        want = ({r.request_id for r in drained} if svc is drain
                else {r.request_id + "-replay" for r in reqs})
        check(set(svc.completed) == want and svc.metrics.total_logged == len(want),
              f"{label}: a request was dropped or answered twice")
        check(sum(stats[label]["batch_sizes"]) == len(want), f"{label}: pad slots answered")

    # (c) every response against a standalone cp_als_fused on the card.
    t0 = time.perf_counter()
    worst = 0.0
    for r in reqs:
        alone = tfused.cp_als_fused(r.tensor, r.rank, n_iters=cfg.n_iters, tol=0.0, seed=r.seed,
                                    impl="kernel", device=dev).fits[0]
        for resp in [done[f"{r.request_id}-d{k}"] for k in range(SERVE_DRAIN_ROUNDS)] + [
                replayed[r.request_id + "-replay"]]:
            st = resp.state
            check(len(st.fits) == cfg.n_iters and np.isfinite(st.fits).all(),
                  f"{resp.request_id}: fits {st.fits}")
            check([tuple(f.shape) for f in st.factors] == [(d, r.rank) for d in r.tensor.shape]
                  and tuple(st.weights.shape) == (r.rank,), f"{resp.request_id}: not trimmed")
            worst = max(worst, float(np.max(np.abs(np.array(st.fits) - alone))))
    print(f"  every response vs a standalone cp_als_fused(impl='kernel') on the card, same seed: "
          f"max fit gap {worst:.3e} over {(SERVE_DRAIN_ROUNDS + 1) * len(reqs)} responses "
          f"(tol {tfused.FUSED_FIT_TOL}), "
          f"{time.perf_counter() - t0:.1f} s")
    check(worst <= tfused.FUSED_FIT_TOL, f"a served response differs from cp_als_fused by {worst}")
    first = reqs[0]
    print(f"  {first.request_id}: rank {first.rank}, fits {done[first.request_id + '-d0'].state.fits}")

    # (a) one batch's stacked MTTKRP per mode, kernel against plain.
    sig = sigs[reqs[0].request_id]
    members = [r for r in reqs if sigs[r.request_id] == sig][:SERVE_MAX_BATCH]
    members += [members[0]] * (SERVE_MAX_BATCH - len(members))
    tensors = [r.tensor for r in members]
    facs = factors_on([SERVE_MAX_BATCH * d for d in sig.dims], sig.rank_pad, dev, seed=9)
    s_idx, s_val, _ = ops.stacked_operands(tensors, sig.dims, sig.nnz_pad, device=dev)
    rows = []
    for mode in range(sig.nmodes):
        bufs = ops.stacked_plan_buffers(s_idx, s_val, [t.nnz for t in tensors], sig.dims, mode)
        i_out = SERVE_MAX_BATCH * sig.dims[mode]
        got = kmod.mttkrp_cuda(bufs, facs, mode, i_out)
        same = torch.equal(got, kmod.mttkrp_cuda(bufs, facs, mode, i_out))
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(bufs, facs, mode, i_out, got, F32_TOL)
        del got
        ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, mode, i_out), TIMING_REPS)
        plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, mode, i_out), TIMING_REPS, 1)
        nnz_pad, nblocks = int(bufs.values.shape[0]), int(bufs.block_real_end.shape[0])
        nbytes = (nnz_pad * 4 * (sig.nmodes + 1) + (nblocks + 1) * 8
                  + sum(SERVE_MAX_BATCH * d * sig.rank_pad * 4 for d in sig.dims))
        flops = nnz_pad * sig.rank_pad * (sig.nmodes + 1)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append(dict(ms=ms, plain_ms=plain, bound_ms=bound, max_abs=max_abs, ok=ok, same=same))
        print(f"  stacked MTTKRP mode {mode} (B={SERVE_MAX_BATCH}, rank_pad {sig.rank_pad}, "
              f"nnz_pad {nnz_pad}, {nblocks} blocks, {i_out} rows): split {ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bound:.4f} ms; max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"{'ok' if ok else 'FAIL'} (tol {F32_TOL:g} x scale); two launches bit for bit "
              f"{'equal' if same else 'DIFFER'}  [{card}]")
    check(all(r["ok"] for r in rows), "the stacked MTTKRP disagrees with its plain version")
    check(all(r["same"] for r in rows), "two launches on a stacked plan differ")
    del facs

    del s_idx, s_val, bufs

    host_waits(dev, sig.dims)
    # (b) staging and run_batch enqueue without a host-device synchronisation:
    # the sync debug mode does not see every synchronising call, so each is
    # also queued behind a sleep, and the host must get back before it ends.
    executor = BucketExecutor(sig, device=dev)
    staged, stage_host_ms, ended = behind_a_sleep(
        lambda: executor.stage(members, pad_to=SERVE_MAX_BATCH))
    check(not ended, "staging a batch waited for the device")
    *operands, plans = staged
    _, short_ms, ended = behind_a_sleep(
        lambda: executor.core.run_batch(*operands, n_iters=SLEEP_CHECK_SWEEPS, plans=plans))
    check(not ended, "run_batch waited for the device")
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        executor.core.run_batch(*operands, n_iters=sig.n_iters, plans=plans)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  behind a {SLEEP_CYCLES:.0e}-cycle sleep the host got back before it ended: staging "
          f"(uploads, plans) in {stage_host_ms:.1f} ms, run_batch of {SLEEP_CHECK_SWEEPS} sweeps "
          f"in {short_ms:.1f} ms; run_batch of {sig.n_iters} sweeps under "
          f"set_sync_debug_mode('error'): no synchronisation, enqueued in {enqueue_ms:.1f} ms")
    del staged, operands, plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    executor.launch(members, pad_to=SERVE_MAX_BATCH)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_batch(executor, members, batch_ms)
    print(f"  host: draw {draw_s:.1f} s; one batch staged in {stage_host_ms:.1f} ms and enqueued "
          f"in {enqueue_ms:.1f} ms, done after {batch_ms:.1f} ms")
    return dict(launches=launches, by_variant=by_variant, peak_gb=peak_gb, stats=stats,
                batch_ms=batch_ms, profile_ms=prof, draw_s=draw_s,
                stage_host_ms=stage_host_ms, enqueue_ms=enqueue_ms,
                stacked_ms=[r["ms"] for r in rows], stacked_plain_ms=[r["plain_ms"] for r in rows],
                stacked_bound_ms=[r["bound_ms"] for r in rows],
                stacked_max_abs=max(r["max_abs"] for r in rows))


# Phase 11: the paper's experiment engine at the largest stand-ins that
# make_frostt_like's cap of 2M nonzeros gives: NELL-2 (3585, 2725, 8532),
# LBNL at its full Table II size with 5 modes, PATENTS (4, 19716, 19716).
ENGINE_TENSORS = (("NELL-2", 0.026), ("LBNL", 1.0), ("PATENTS", 5.6e-4))
ENGINE_ITERS = 3
BACK_TO_BACK = 50  # launches between two CUDA events, for the kernel's own time


def back_to_back_ms(fn, n: int = BACK_TO_BACK) -> float:
    """Device ms per call of ``n`` calls queued back to back between two
    CUDA events: the host gaps between launches hide behind the queue
    whenever a call takes the device longer than the host takes to enqueue
    the next one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def engine_phase(dev, card: str) -> dict:
    """Phase 11: ``run_experiments`` through the split kernel on the engine's
    stand-ins, then the controller's gates and the ordering benchmark."""
    phase(f"phase 11: the experiment engine, {ENGINE_TENSORS}, rank {RANK}, "
          f"{ENGINE_ITERS} sweeps eager and fused (cold, warm), impl kernel")
    held = []  # (dims, mode, max_abs, max_rel, ok): each mode's first call vs plain
    tensors = {}  # dims -> the engine's tensor, from its first call

    def hold(tensor, impl, mode, facs, out):
        if impl != "kernel":
            return
        tensors[tensor.shape] = tensor
        bufs = ops.plan_device_buffers(ops.get_plan(tensor, mode), dev)  # the run's plan
        max_abs, max_rel, ok = compare(bufs, list(facs), mode, tensor.shape[mode], out, F32_TOL)
        held.append((tensor.shape, mode, max_abs, max_rel, ok))

    # One run_experiments per tensor, so each run's launches are the counter's
    # step across it; the runs together are the spec's result (run_experiments
    # prices each tensor on its own).
    spec = ExperimentSpec(tensors=ENGINE_TENSORS, impls=("kernel",), n_iters=ENGINE_ITERS,
                          fused=True, device="cuda")
    runs, per_run = [], []
    kmod.reset_launch_counts()  # the main path of phase 11 starts here
    t0 = time.perf_counter()
    for one in ENGINE_TENSORS:
        before = kmod.mttkrp_cuda.launches
        runs += run_experiments(dataclasses.replace(spec, tensors=(one,)),
                                first_call_hook=hold).runs
        per_run.append(kmod.mttkrp_cuda.launches - before)
    engine_s = time.perf_counter() - t0
    launches = kmod.mttkrp_cuda.launches  # the main path ends here
    by_variant = dict(kmod.mttkrp_cuda.launches_by_variant)
    by_mode = dict(kmod.mttkrp_cuda.launches_by_mode)
    result = ExperimentResult(spec=spec, runs=runs)
    print(f"  engine: {engine_s:.1f} s host wall for {len(result.runs)} runs; split launches "
          f"{launches} by variant {by_variant} by mode {by_mode}  [{card}]")
    check(by_variant.get("block", 0) == 0 and by_variant["split"] == launches,
          f"the engine's MTTKRPs did not all take the split kernel: {by_variant}")
    check(len(per_run) == len(result.runs), f"{len(result.runs)} runs for {len(per_run)} tensors")
    kernel_ms = {}  # shape -> per mode, the split kernel alone on the run's plans
    for tensor in tensors.values():
        facs = factors_on(tensor.shape, RANK, dev)  # random factors, for the time only
        kernel_ms[tensor.shape] = [
            back_to_back_ms(lambda b=ops.plan_device_buffers(ops.get_plan(tensor, m), dev), m=m:
                            kmod.mttkrp_cuda(b, facs, m, tensor.shape[m]))
            for m in range(tensor.nmodes)]
        del facs
    fit_tol = tfused.FUSED_FIT_TOL
    entries = {}
    for run, n_launches in zip(result.runs, per_run):
        m = run.measured
        expected = 3 * ENGINE_ITERS * len(run.dims)  # eager, fused cold, fused warm
        print(f"  {run.key}: dims {run.dims}, nnz {run.nnz}; split launches {n_launches} "
              f"(expected {expected}: {ENGINE_ITERS} sweeps x {len(run.dims)} modes, eager and "
              f"fused cold and warm); fit eager {m.fit:.6f} fused {m.fused_fit:.6f}, max fit gap "
              f"{m.fused_max_fit_delta:.3e} (tol {fit_tol}); wall eager {m.wall_s:.3f} s, fused cold "
              f"{m.fused_wall_s:.3f} s, warm {m.fused_warm_wall_s:.3f} s")
        check(n_launches == expected, f"{run.key} launched the split kernel {n_launches} times")
        check(m.fused_max_fit_delta <= fit_tol and abs(m.fused_fit - m.fit) <= fit_tol,
              f"{run.key}: fused fits differ from eager by {m.fused_max_fit_delta}")
        check(np.isfinite([m.fit, m.fused_fit]).all(), f"{run.key}: non-finite fit")
        rows = []
        for mm in m.modes:
            plan = ops.get_plan(tensors[run.dims], mm.mode)
            nbytes = mttkrp_bytes(plan, RANK, run.nnz)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            paper = 2.0 * len(run.dims) * run.nnz * RANK
            check(mm.flops == mm.paper_flops == paper,
                  f"{run.key} mode {mm.mode}: flops {mm.flops} != closed form {paper}")
            kms = kernel_ms[run.dims][mm.mode]
            rows.append(dict(ms=mm.steady_s * 1e3, event_ms=mm.steady_device_s * 1e3,
                             first_ms=mm.first_s * 1e3, kernel_ms=kms, bound_ms=bound))
            print(f"    mode {mm.mode}: {run.dims[mm.mode]} rows, steady {mm.steady_s * 1e3:.4f} ms "
                  f"per call (CUDA events {mm.steady_device_s * 1e3:.4f} ms), first "
                  f"{mm.first_s * 1e3:.3f} ms; the kernel alone {kms:.4f} ms ({BACK_TO_BACK} back "
                  f"to back), byte bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB), "
                  f"flops {mm.flops:.4g} = 2·N·|T|·R")
        for _, mode, max_abs, max_rel, ok in [h for h in held if h[0] == run.dims]:
            print(f"    mode {mode} first call vs plain: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
                  f"{'ok' if ok else 'FAIL'} (tol {F32_TOL:g} x scale)")
        hs = {k: f"{v:.2f}" for k, v in run.host_s.items()}
        print(f"    host s: {hs}; hit rates: {len(run.hit_rates)} scenarios, max |trace - che(L)| "
              f"{max(h.max_abs_err for h in run.hit_rates):.4f}, all_within_tol {run.all_within_tol} "
              f"(tol {CHE_VS_TRACE_TOL}, printed, not asserted)")
        entries[run.tensor] = dict(dims=list(run.dims), nnz=run.nnz, launches=n_launches,
                                   per_mode_ms=[r["ms"] for r in rows],
                                   per_mode_event_ms=[r["event_ms"] for r in rows],
                                   per_mode_kernel_ms=[r["kernel_ms"] for r in rows],
                                   per_mode_bound_ms=[r["bound_ms"] for r in rows],
                                   host_s=run.host_s, all_within_tol=run.all_within_tol)
    check(len(held) == sum(len(r.dims) for r in result.runs), f"{len(held)} first calls held")
    check(all(h[4] for h in held), "a first call of the engine disagrees with the plain version")
    print("  E-SRAM -> O-SRAM, priced (measured trace hit rates) beside modeled (Che):")
    for key, sp in result.speedup_table().items():
        ev = result.energy_table()[key]
        print(f"    {key}: speedup {sp['priced']:.4f} (Che {sp['modeled']:.4f}), energy saving "
              f"{ev['priced']:.4f} (Che {ev['modeled']:.4f})")
    for run in result.runs:
        for tech in run.techs:
            print(f"    {run.key} {tech.tech}: priced {sum(tech.priced_mode_s):.4e} s, modeled "
                  f"{sum(tech.modeled_mode_s):.4e} s, measured-vs-priced share residual max "
                  f"{tech.max_share_residual:.4f}")

    # The NELL-2 run's hit rates, again on the host from the plans' traces.
    nell = result.runs[0]
    nell_tensor = tensors[nell.dims]
    t0 = time.perf_counter()
    same = True
    for h in nell.hit_rates:
        geometry = CacheGeometry(capacity_bytes=h.capacity_bytes, line_bytes=h.line_bytes,
                                 associativity=h.associativity)
        cfg, row_bytes = geometry_sim_config(geometry, RANK, n_inputs=len(nell.dims) - 1)
        plan = ops.get_plan(nell_tensor, h.mode)
        rates = tuple(simulate_trace(plan.executed_row_trace(k, include_padding=False), cfg,
                                     row_bytes=row_bytes).hit_rate
                      for k in range(len(nell.dims)) if k != h.mode)
        same = same and rates == h.trace
    print(f"  NELL-2 hit rates recomputed from executed_row_trace: "
          f"{'equal' if same else 'DIFFER'} over {len(nell.hit_rates)} scenarios "
          f"({time.perf_counter() - t0:.1f} s host)")
    check(same, "the engine's NELL-2 hit rates differ from the plans' traces")

    t0 = time.perf_counter()
    ref = run_experiments(ExperimentSpec(tensors=ENGINE_TENSORS[:1], impls=("ref",),
                                         n_iters=ENGINE_ITERS, fused=True, device="cuda"))
    ref_run = ref.runs[0]
    gap = abs(ref_run.measured.fit - nell.measured.fit)
    print(f"  {ref_run.key}: {time.perf_counter() - t0:.1f} s host wall; steady ms per mode "
          f"{[round(mm.steady_s * 1e3, 4) for mm in ref_run.measured.modes]} (CUDA events "
          f"{[round(mm.steady_device_s * 1e3, 4) for mm in ref_run.measured.modes]}); fit "
          f"{ref_run.measured.fit:.6f}, kernel {nell.measured.fit:.6f}, gap {gap:.3e} "
          f"(tol {fit_tol}); speedup priced {ref.speedup_table()[ref_run.key]['priced']:.4f}; "
          f"host s {({k: round(v, 2) for k, v in ref_run.host_s.items()})}")
    check(gap <= fit_tol, f"ref and kernel fits on NELL-2 differ by {gap}")
    check(ref_run.measured.fused_max_fit_delta <= fit_tol, "ref fused fits differ from eager")
    ops.clear_caches()

    # The controller's gates, as scripts/run_controller.py runs them.
    t0 = time.perf_counter()
    cells, _ = reconcile_controller()
    recon_s = time.perf_counter() - t0
    for c in cells:
        print(f"    recon {c.workload:8s} {c.tech:7s} analytic {c.analytic_seconds:.4e} s, "
              f"controller {c.controller_seconds:.4e} s, rel {c.rel_err:+.5f}")
    check(all(c.ok and c.rel_err >= -1e-9 for c in cells),
          f"the controller does not reconcile within {CONTROLLER_RECON_TOL}")
    t0 = time.perf_counter()
    gates = controller_gates(rank=RANK, device=dev)
    gates_s = time.perf_counter() - t0
    rates = {o: c.conflict_rate for o, c in gates.conflicts.items()}
    print(f"  controller: reconciliation {len(cells)} cells in {recon_s:.1f} s host (tol "
          f"{CONTROLLER_RECON_TOL}); paper bands {gates.bands} (speedup {SPEEDUP_BAND}, energy "
          f"{ENERGY_BAND}); bank conflict rates {rates}; bands and conflicts {gates_s:.1f} s host")
    check(gates.bands_ok, f"the cycle model leaves the paper bands: {gates.bands}")
    check(gates.conflicts_ok, f"degree/blocked do not reduce bank conflicts: {rates}")
    t0 = time.perf_counter()
    sweep = run_reorder_sweep(quick=True, device=dev)
    reorder_s = time.perf_counter() - t0
    acc = sweep["acceptance"]
    print(f"  ordering benchmark (quick, orders sorted on the card): {reorder_s:.1f} s host; "
          f"winners {({n: r['winners'] for n, r in acc['tensors'].items()})}, ok {acc['ok']}")
    check(acc["ok"], f"the ordering benchmark's acceptance fails: {acc}")
    return dict(launches=launches, by_variant=by_variant, runs=entries,
                max_abs=max(h[2] for h in held), engine_s=engine_s,
                ref=dict(per_mode_ms=[mm.steady_s * 1e3 for mm in ref_run.measured.modes],
                         per_mode_event_ms=[mm.steady_device_s * 1e3 for mm in ref_run.measured.modes],
                         host_s=ref_run.host_s, fit_gap=gap),
                speedup=result.speedup_table(), energy=result.energy_table(),
                recon_s=recon_s, gates_s=gates_s, reorder_s=reorder_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    # -- phase 1: card, versions, build ------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card} | torch.cuda: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"tf32: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} CUDA source(s) in {time.perf_counter() - t0:.2f} s wall")
    for lib in built.values():
        print(f"  {lib.name}: nvcc {lib.seconds:.2f} s -> {lib.path.relative_to(REPO)}")
        for line in lib.log.splitlines():
            if "Compiling entry function" in line:
                print(f"    {line.split(chr(39))[1][:110]}")  # the mangled kernel name
            elif "registers" in line or "spill" in line or "error" in line.lower():
                print(f"    {line.strip()}")

    # -- phase 2: kernel against plain, small CP-ALS card vs CPU -------------
    phase("phase 2: kernel vs plain version on the card")
    phase_kernel_cases(dev)

    mttkrp_entry, nell2, lex_fits = cp_als_phases(dev, card)
    # Phase 10 runs here, while phase 3's tensor and lex plans are resident.
    ordered = ordering_phase(dev, card, nell2, lex_fits)
    del nell2
    gc.collect()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ops.clear_caches()  # the memos pin the NELL-2 plans' device buffers
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory held after the CP-ALS phases: {held_gb:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after clearing the plan memos")
    flash_entry = lm_phases(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    served = service_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    engine = engine_phase(dev, card)
    row_run = ordered["launches"].get("rows", 0)
    mttkrp_entry["launches_by_path"] = {
        "cp_als (phase 3)": mttkrp_entry["launches"], "service (phase 9)": served["launches"],
        "cp_als_fused, lex / secondary-sort / degree (phase 10)": row_run,
        "run_experiments, impl kernel (phase 11)": engine["launches"]}
    mttkrp_entry["launches"] += served["launches"] + row_run + engine["launches"]
    mttkrp_entry["max_abs_err"] = max(
        [mttkrp_entry["max_abs_err"], served["stacked_max_abs"], engine["max_abs"]]
        + [r["max_abs"] for o, res in ordered["results"].items() if o != "blocked"
           for r in res["rows"]])
    mttkrp_entry["per_ordering"] = {
        o: dict(split_mode=[r["split_mode"] for r in res["rows"]],
                per_mode_ms=[r["ms"] for r in res["rows"]],
                per_mode_ms_b4=[r["ms_b4"] for r in res["rows"]],
                per_mode_tiles_ms=[r["tiles_ms"] for r in res["rows"]],
                per_mode_block_ms=[r["block_ms"] for r in res["rows"]],
                per_mode_plain_ms=[r["plain_ms"] for r in res["rows"]],
                per_mode_bound_ms=[r["bound_ms"] for r in res["rows"]],
                order_device_ms=res["order_ms"], plan_host_s=res["plan_s"],
                fused_fit_gap=res["fit_gap"])
        for o, res in ordered["results"].items()}
    blocked = ordered["results"]["blocked"]["rows"]
    tile_entry = dict(
        name="mttkrp_tile_kernel",
        route="cuda",
        source="src/repro_torch/kernels/mttkrp/csrc/mttkrp_split.cu",
        replaces="src/repro/kernels/mttkrp/kernel.py:44",
        launches=ordered["launches"].get("tiles", 0),
        max_abs_err=max(r["max_abs"] for r in blocked),
        ms=sum(r["ms"] for r in blocked),
        previous_ms=sum(r["block_ms"] for r in blocked),
        previous="mttkrp_block_kernel, csrc/mttkrp.cu, on the same blocked plans",
        plain_ms=sum(r["plain_ms"] for r in blocked),
        bound_ms=sum(r["bound_ms"] for r in blocked),
        bound_by=mttkrp_entry["bound_by"],
        library_ms=None,
        per="one CP-ALS sweep of MTTKRPs over the blocked ordering's plans: modes 0-2, one restart",
        per_mode_ms=[r["ms"] for r in blocked],
        per_mode_ms_b4=[r["ms_b4"] for r in blocked],
        per_mode_ms_on_lex_plans=[r["tiles_ms"] for r in ordered["results"]["lex"]["rows"]],
        sweep_profile=ordered["results"]["blocked"]["tile_split_ms"],
        launches_by_path={"cp_als_fused, blocked (phase 10)": ordered["launches"].get("tiles", 0)},
    )
    mttkrp_entry["engine"] = {k: engine[k] for k in (
        "runs", "ref", "speedup", "energy", "engine_s", "recon_s", "gates_s", "reorder_s")}
    mttkrp_entry["service"] = {k: served[k] for k in (
        "stats", "batch_ms", "profile_ms", "peak_gb", "stage_host_ms", "enqueue_ms", "stacked_ms",
        "stacked_plain_ms", "stacked_bound_ms")}
    total_s = time.perf_counter() - T_START
    print(f"total {total_s:.1f} s")
    kernels = [mttkrp_entry, tile_entry, flash_entry]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)
