#!/usr/bin/env python3
"""Measure how far the recurrent families' float32 train steps on one CUDA
card lie from the same steps on the CPU, and what part of that gap the
scan kernels make.

    python scripts/torch_family_step_gaps.py [--seeds 0 1 2] [--archs ...]

For each arch's ``reduced_config`` (float32, blocked attention) and seed:
3 AdamW steps (lr 1e-3, 2 microbatches, batch 4 x 32 tokens, the bf16
cotangent fence out) from ``init_model(seed)`` on batches drawn from
``SyntheticLMStream(seed=3 * seed + i)``, as ``chip_smoke.py`` phase 18 (b)
runs them with seed 0, once on the CPU and three times on the card:

* ``kernels``: the main path, the scan kernels and their backward kernels;
* ``plain``: the scans through their plain step loops under autograd on the
  card, so the card's gap without the scan kernels;
* ``tf32``: a control, the main path with the scans' operands (r, k, v of
  WKV-6; dtx, b, c of the SSD) and their gradients rounded to TF32 (10
  mantissa bits), an error of the size a scan whose products ran in one
  TF32 pass, not 3xTF32, would make.

Each seed also runs once more on the CPU with the scans' step loops in
float64 (``f64``): its gap to the float32 CPU run is what the rounding of a float32 scan
alone costs on this config, a floor below which no float32 side can be
held.

Each run's reading is the largest of the relative gaps of the losses and
gradient norms and of every leaf of the parameters and both moments in
norm, against the CPU run, as phase 18 (b) reads them; the line per arch
gives the sound runs' largest reading and the control's smallest.  Prints
the card's name and power limit and one JSON line.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.data.lm_data import SyntheticLMStream  # noqa: E402
from repro_torch.kernels.recurrence import ref as rref  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import AdamW, init_adamw_state  # noqa: E402

STEPS, BATCH, SEQ, MICROBATCHES, LR = 3, 4, 32, 2, 1e-3


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


class _Tf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_tf32(grad)


@contextlib.contextmanager
def scans(mode: str):
    """The models' scans as ``mode`` runs them; restored on exit."""
    saved = trwkv.wkv6_scan_logw, tssm.ssd_scan_logdec
    if mode == "plain":
        trwkv.wkv6_scan_logw = lambda r, k, v, log_w, u: rref.wkv6_scan_ref(
            r, k, v, torch.exp(log_w), u)
        tssm.ssd_scan_logdec = lambda log_dec, *rest: rref.ssd_scan_ref(torch.exp(log_dec), *rest)
    elif mode == "f64":
        trwkv.wkv6_scan_logw = lambda r, k, v, log_w, u: rref.wkv6_scan_ref(
            r.double(), k.double(), v.double(), torch.exp(log_w.double()), u.double()).float()
        tssm.ssd_scan_logdec = lambda log_dec, *rest: rref.ssd_scan_ref(
            torch.exp(log_dec.double()), *(t.double() for t in rest)).float()
    elif mode == "tf32":
        trwkv.wkv6_scan_logw = lambda r, k, v, log_w, u: saved[0](
            *(_Tf32.apply(t) for t in (r, k, v)), log_w, u)
        tssm.ssd_scan_logdec = lambda log_dec, dtx, bm, cm: saved[1](
            log_dec, *(_Tf32.apply(t) for t in (dtx, bm, cm)))
    try:
        yield
    finally:
        trwkv.wkv6_scan_logw, tssm.ssd_scan_logdec = saved


def run(arch: str, seed: int, where: str) -> tuple[list[dict], dict]:
    cfg = reduced_config(arch, dtype=torch.float32, attention_impl="blocked")
    state = init_adamw_state(tzoo.init_model(cfg, seed=seed, device="cpu").to(where), lr=LR)
    step = tzoo.make_train_step(cfg, AdamW(), num_microbatches=MICROBATCHES, device=where)
    metrics = []
    for i in range(STEPS):
        batch = next(SyntheticLMStream(cfg.vocab_size, SEQ, BATCH, seed=3 * seed + i))
        state, m = step(state, {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
        metrics.append({key: float(val) for key, val in m.items()})
    return metrics, tree_to_numpy({k: state[k] for k in ("params", "m", "v")})


def _leaves(tree, where=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{where}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{where}/{i}")
    else:
        yield where, np.asarray(tree, np.float64)


def reading(got, want) -> tuple[float, str]:
    """The largest relative gap of the losses and gradient norms, and of a
    leaf in norm, with where it is."""
    (gm, gs), (wm, ws) = got, want
    gaps = {f"step {i} {key}": abs(a[key] - b[key]) / abs(b[key])
            for i, (a, b) in enumerate(zip(gm, wm)) for key in ("loss", "grad_norm")}
    for (name, w), (_, g) in zip(_leaves(ws), _leaves(gs)):
        gaps[name] = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--archs", nargs="+", default=["rwkv6-3b", "zamba2-1.2b"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_family_step_gaps: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    fence, ttr.grad_fence_bf16 = ttr.grad_fence_bf16, lambda x: x
    out = {}
    try:
        for arch in args.archs:
            per = {"kernels": [], "plain": [], "tf32": []}
            floor = []
            for seed in args.seeds:
                cpu = run(arch, seed, "cpu")
                with scans("f64"):
                    gap, where = reading(run(arch, seed, "cpu"), cpu)
                floor.append(gap)
                print(f"{arch} seed {seed} CPU, scans in float64 vs float32: {gap:.3e} ({where})")
                for mode in per:
                    with scans(mode):
                        gap, where = reading(run(arch, seed, "cuda"), cpu)
                    per[mode].append(gap)
                    print(f"{arch} seed {seed} {mode:<7} card vs CPU: {gap:.3e} ({where})  [{card}]")
            sound, control = max(per["kernels"] + per["plain"]), min(per["tf32"])
            print(f"{arch}: sound runs' largest {sound:.3e} (kernels {max(per['kernels']):.3e}, "
                  f"plain {max(per['plain']):.3e}); the TF32 control's smallest {control:.3e}; "
                  f"a float32 scan's rounding on the CPU {min(floor):.3e}-{max(floor):.3e}")
            out[arch] = dict(per, f64_on_cpu=floor, sound_max=sound, control_min=control)
    finally:
        ttr.grad_fence_bf16 = fence
    print(json.dumps({"card": card, "seeds": args.seeds, "gaps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
