#!/usr/bin/env python3
"""Time the port's two recurrence kernels at the recurrent families' prefill
shapes on one CUDA card: ``wkv6_scan_cuda`` at rwkv6-3b's (B = 2, S = 32768,
H = 40) and ``ssd_scan_cuda`` at zamba2-1.2b's (B = 2, S = 32768, H = 64,
N = 64), on contiguous float32 inputs drawn from a seed with the models'
decays; CUDA-event medians.  With ``--bwd``, their backward kernels instead,
``wkv6_scan_bwd_cuda`` and ``ssd_scan_bwd_cuda``, at the training shapes
(B = 2, S = 4096, H = 40 and 64) against a cotangent dy drawn from the seed.

    python scripts/torch_scan_times.py [--bwd] [--src DIR] [--reps N] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's), so two versions of the kernels are compared on
one card by running the script once for each, in turns (A, B, B, A); each
version builds its kernels into its own checkout's build directory.  Prints
the card's name and power limit, each kernel's time, and one JSON line with
the times and a checksum of each output (the same inputs in every run, so
two versions' checksums agree to float32 rounding; with ``--bwd`` one a
gradient).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {"wkv6": (2, 32768, 40), "ssd": (2, 32768, 64)}  # (B, S, H)
BWD_SHAPES = {"wkv6": (2, 4096, 40), "ssd": (2, 4096, 64)}  # the training shapes


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def inputs(kind: str, dev, torch, shape):
    b, s, h = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "wkv6":
        r, k, v, w = (torch.randn((b, s, h, 64), generator=gen, device=dev) for _ in range(4))
        w = torch.exp(-torch.exp(w.clamp(max=0.5) - 3.0))
        return r, k, v, w, 0.1 * torch.randn((h, 64), generator=gen, device=dev)
    dtx = torch.randn((b, s, h, 64), generator=gen, device=dev)
    bm, cm = (torch.randn((b, s, 64), generator=gen, device=dev) for _ in range(2))
    return torch.exp(-2.0 * torch.rand((b, s, h), generator=gen, device=dev)), dtx, bm, cm


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", type=Path, default=Path(__file__).resolve().parents[1] / "src",
                        help="the src directory whose repro_torch is timed")
    parser.add_argument("--reps", type=int, default=10, help="timed launches a kernel")
    parser.add_argument("--label", default=None, help="a name for this run's JSON line")
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward kernels at the training shapes")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    from repro_torch.kernels.recurrence import kernel as rkernel

    if not torch.cuda.is_available():
        print("no CUDA device: the recurrence kernels run on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    out = {"label": args.label or str(args.src), "src": str(args.src.resolve()), "card": card,
           "bwd": args.bwd, "kernels": {}}
    shapes = BWD_SHAPES if args.bwd else SHAPES
    kernels = ((("wkv6", rkernel.wkv6_scan_bwd_cuda), ("ssd", rkernel.ssd_scan_bwd_cuda))
               if args.bwd else (("wkv6", rkernel.wkv6_scan_cuda), ("ssd", rkernel.ssd_scan_cuda)))
    for kind, fn in kernels:
        xs = inputs(kind, dev, torch, shapes[kind])
        if args.bwd:
            gen = torch.Generator(device=dev).manual_seed(1)
            xs = (*xs, torch.randn(tuple(shapes[kind]) + (64,), generator=gen, device=dev))
        ys = fn(*xs)  # builds the library on first use, and warms up
        ys = ys if isinstance(ys, tuple) else (ys,)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*xs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        finite = all(bool(torch.isfinite(y).all()) for y in ys)
        entry = dict(shape=list(shapes[kind]), median_ms=ms, times_ms=times,
                     abs_sum=[float(y.double().abs().sum()) for y in ys], finite=finite)
        grid = getattr(rkernel, "bwd_grid", None)
        if args.bwd and grid is not None:
            entry["grid"] = grid(kind, shapes[kind][0], shapes[kind][2])
        out["kernels"][kind] = entry
        print(f"{kind}{' backward' if args.bwd else ''} at (B, S, H) {tuple(shapes[kind])}: "
              f"median {ms:.3f} ms of {args.reps} ({out['label']}; {card})")
        if not finite:
            print(f"{kind}: non-finite output", file=sys.stderr)
            return 1
        del xs, ys
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
