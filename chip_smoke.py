#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line):

  1. the card, the versions, both TF32 flags, and the build of every CUDA
     source with nvcc for sm_90a;
  2. the MTTKRP kernel against its plain PyTorch version on the card, over
     the edge cases of the CPU tests (tolerance 1e-4 for float32 factors,
     3e-2 for bfloat16, relative to the size of each output's sum: see
     ``compare``), and the port's CP-ALS on the card against the same run
     on the CPU (fits within FUSED_FIT_TOL);
  3. the main path at full size: a NELL-2 stand-in at Table II size (dims
     12100 x 9200 x 28800, 76.9M drawn nonzeros, Zipf 0.85), rank 16,
     through eager ``cp_als(impl="kernel")`` (5 sweeps) and
     ``cp_als_fused`` with 4 batched restarts (5 sweeps, one sync); the
     launch counter must show one kernel launch per mode per sweep in each;
  4. per mode at full size, the kernel against its plain version with one
     restart and with 4 restarts whose factors differ, then kernel times
     (CUDA events, median of 10) against the plain version and the least
     time the card could take for the bytes the function needs;
  5. a ``torch.profiler`` trace of one eager sweep: device time by kernel
     and the device's idle share.

The last three lines are the card's ``name, power.limit``, a JSON object
with the kernel's numbers, and ``{"ok": true, "device": {...}}``.  The
script needs no network and imports no JAX.
"""

from __future__ import annotations

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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mttkrp import kernel as kmod  # noqa: E402
from repro_torch.kernels.mttkrp import ops  # noqa: E402
from repro_torch.kernels.mttkrp.ref import mttkrp_plan_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F32_TOL = 1e-4
BF16_TOL = 3e-2

NELL2_DIMS = (12_100, 9_200, 28_800)  # paper Table II
NELL2_NNZ = 76_900_000
NELL2_ZIPF = 0.85
RANK = 16  # paper §V-A2
SWEEPS = 5
RESTARTS = 4
TIMING_REPS = 10


class SmokeFailure(Exception):
    pass


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

    Both sides sum the same float32 products in different orders (the
    kernel's shared-memory atomics land in a run-dependent order), so the
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
    ]


def phase_kernel_cases(dev) -> None:
    failures = []
    for name, t, rank, tile, rpb, batch, dtype, tol in kernel_cases():
        facs = factors_on(t.shape, rank, dev, batch=batch, dtype=dtype, seed=t.nnz)
        for mode in range(t.nmodes):
            plan = tst.build_mttkrp_plan(t, mode, tile_nnz=tile, rows_per_block=rpb)
            bufs = ops.plan_device_buffers(plan, dev)
            got = kmod.mttkrp_cuda(bufs, facs, mode, t.shape[mode])
            torch.cuda.synchronize()
            max_abs, max_rel, ok = compare(bufs, facs, mode, t.shape[mode], got, tol)
            print(f"  case {name:<36} mode {mode} nnz {t.nnz:>8} rank {rank:>3} "
                  f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} tol {tol:g} x scale "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} mode {mode}")
    check(not failures, f"kernel disagrees with its plain version: {failures}")

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
    for e in events[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


def mttkrp_bytes(plan, rank: int) -> int:
    """Each input the function needs read once, each output written once
    (factor values in float32).  Per nonzero it needs N-1 gather indices, one
    output-row index and the value: the plan stores the row twice (as
    ``local_row`` and as the output mode's column of the indices), and the
    second copy is not counted."""
    n = len(plan.shape)
    stream = plan.nnz_pad * (4 * (n - 1) + 4 + 4) + (plan.num_blocks + 1) * 8
    factors = sum(plan.shape[k] * rank * 4 for k in range(n) if k != plan.mode)
    return stream + factors + plan.shape[plan.mode] * rank * 4


def mttkrp_flops(plan, rank: int) -> int:
    """N-1 factor multiplies, one value multiply and one add per (nonzero, rank)."""
    return plan.nnz_pad * rank * (len(plan.shape) + 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

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
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"    {line.strip()}")

    # -- phase 2: kernel against plain, small CP-ALS card vs CPU -------------
    print("phase 2: kernel vs plain version on the card")
    phase_kernel_cases(dev)

    # -- phase 3: the main path at Table II size -----------------------------
    print("phase 3: NELL-2 stand-in at Table II size, rank 16")
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
    for p in plans:
        print(f"  plan mode {p.mode}: {p.num_blocks} output blocks (CTAs for one restart), "
              f"nnz_pad {p.nnz_pad}, padding overhead {p.padding_overhead:.6f}")
    print(f"  host: plans {host_plan_s:.2f} s (3 threads), upload {upload_s:.2f} s")

    fused_tol = tfused.FUSED_FIT_TOL
    expected = SWEEPS * tensor.nmodes
    torch.cuda.reset_peak_memory_stats()
    kmod.mttkrp_cuda.launches = 0  # the main path starts here
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
    check(np.isfinite(eager.fits).all() and np.isfinite(fused.fits).all(), "non-finite fit")
    check(all(f.shape == (s, RANK) and bool(torch.isfinite(f).all())
              for f, s in zip(eager.factors, tensor.shape)), "eager factors have the wrong shape or are not finite")
    gap = float(np.max(np.abs(np.array(eager.fits) - fused.fits[0])))
    print(f"  fused restart 0 vs eager (same seed): max fit gap {gap:.3e} (tol {fused_tol})")
    check(gap <= fused_tol, f"fused restart 0 differs from eager by {gap}")

    # -- phase 4: per-mode kernel against plain, and times -------------------
    print("phase 4: per-mode MTTKRP at the main path's shapes "
          f"(B=1: eager's final factors; B={RESTARTS}: the fused run's initial factors, "
          f"one draw per restart; kernel median of {TIMING_REPS})")
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
        torch.cuda.synchronize()
        max_abs, max_rel, ok = compare(bufs, facs, p.mode, i_out, got, F32_TOL)
        check(got_b.shape == (RESTARTS, i_out, RANK), f"batched output shape {tuple(got_b.shape)}")
        max_abs_b, max_rel_b, ok_b = compare(bufs, batched, p.mode, i_out, got_b, F32_TOL)
        del got, got_b
        ms = median_ms(lambda: kmod.mttkrp_cuda(bufs, facs, p.mode, i_out), TIMING_REPS)
        ms_b = median_ms(lambda: kmod.mttkrp_cuda(bufs, batched, p.mode, i_out), TIMING_REPS)
        plain = median_ms(lambda: mttkrp_plan_ref(bufs, facs, p.mode, i_out), TIMING_REPS, 1)
        nbytes, flops = mttkrp_bytes(p, RANK), mttkrp_flops(p, RANK)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
        rows.append(dict(mode=p.mode, ms=ms, ms_b4=ms_b, plain_ms=plain, bound_ms=bound,
                         bytes=nbytes, flops=flops, max_abs=max(max_abs, max_abs_b),
                         ok=ok and ok_b))
        print(f"  mode {p.mode}: kernel {ms:.3f} ms (B={RESTARTS}: {ms_b:.3f} ms), plain {plain:.3f} ms, "
              f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP), "
              f"share of bound {bound / ms:.4f}; B=1 max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"{'ok' if ok else 'FAIL'}, B={RESTARTS} max_abs {max_abs_b:.3e} "
              f"max_rel {max_rel_b:.3e} {'ok' if ok_b else 'FAIL'} (tol {F32_TOL:g} x scale)  "
              f"[{card}]")
    check(all(r["ok"] for r in rows), "kernel disagrees with its plain version at full size")
    del batched
    bytes_bound = all(r["bytes"] / HBM_BYTES_PER_S >= r["flops"] / F32_FLOPS_PER_S for r in rows)

    # -- phase 5: where the time of a sweep goes --------------------------------
    print("phase 5: profile of one eager sweep")
    profile_sweep(tensor, dev, eager_s / SWEEPS * 1e3)
    total_s = time.perf_counter() - t_start
    print(f"total {total_s:.1f} s (host data {host_data_s:.1f} s, plans {host_plan_s:.1f} s)")

    kernels = [dict(
        name="mttkrp_block_kernel",
        route="cuda",
        source="src/repro_torch/kernels/mttkrp/csrc/mttkrp.cu",
        replaces="src/repro/kernels/mttkrp/kernel.py:44",
        launches=main_launches,
        max_abs_err=max(r["max_abs"] for r in rows),
        ms=sum(r["ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=sum(r["bound_ms"] for r in rows),
        bound_by="bytes" if bytes_bound else "operations",
        library_ms=None,
        per="one CP-ALS sweep of MTTKRPs: modes 0-2, one restart",
        per_mode_ms=[r["ms"] for r in rows],
        per_mode_ms_b4=[r["ms_b4"] for r in rows],
    )]
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
