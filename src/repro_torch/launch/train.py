"""Training launcher (port of ``repro.launch.train``).

``python -m repro_torch.launch.train --arch granite-moe-1b-a400m --reduced``
runs the fault-tolerant loop (``runtime.train_loop``) on the GPU with
AdamW and a warm-up-cosine schedule; ``--device cpu`` runs it on the CPU.
Weights are random, from ``init_model(seed=0)``; tokens come from
``SyntheticLMStream``.  It trains what JAX's launcher trains: every family
whose batch is tokens and labels (the dense, MoE, RWKV-6 and hybrid
families, and the VLM without its optional patch embeddings).  The
encoder-decoder family (whisper-base) needs audio frames, which the stream
does not give, and is refused; ``make_train_step`` trains it on batches
that carry them.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.grad_compress import Int8ErrorFeedback
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--d-model", type=int, default=None, help="override width (reduced)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, **train_kwargs) -> dict:
    """Build the config, stream, optimiser and loop from ``args`` and call
    ``train``; ``train_kwargs`` go to it (``fault_hook=`` for instance)."""
    if args.reduced:
        over = {}
        if args.d_model:
            h = max(2, args.d_model // 64)
            over.update(d_model=args.d_model, num_heads=h, num_kv_heads=min(h, 8),
                        head_dim=args.d_model // h, d_ff=args.d_model * 3)
        if args.layers:
            over["num_layers"] = args.layers
        cfg = reduced_config(args.arch, **over)
    else:
        cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(f"{cfg.name} training requires audio frames; SyntheticLMStream gives "
                         "tokens and labels only (train it through make_train_step on batches "
                         "with frames)")
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M) device={args.device}")
    stream = SyntheticLMStream(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch
    )
    opt = AdamW(
        schedule=warmup_cosine(min(20, args.steps // 5 + 1), args.steps),
        compressor=Int8ErrorFeedback() if args.compress_grads else None,
    )
    loop = TrainLoopConfig(
        total_steps=args.steps,
        save_every=args.save_every,
        log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        lr=args.lr,
        num_microbatches=args.microbatches,
    )
    return train(cfg, loop, stream=stream, optimizer=opt, device=args.device, **train_kwargs)


def main(argv: list[str] | None = None) -> int:
    res = run(parse_args(argv))
    if not res["history"]:  # resumed at or past --steps: nothing to train
        print(f"[train] done: resumed from step {res['resumed_from']}, no steps left")
        return 0
    print(f"[train] done: final loss {res['history'][-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
