"""Serving launcher: batched continuous-batching decode on any arch (port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch internlm2-1.8b --reduced --requests 8``
runs on the GPU; ``--device cpu`` runs on the CPU.  Weights are random,
from ``init_model(seed=0)``.  As JAX's launcher does, it refuses the
encoder-decoder family (whisper-base), whose requests need audio frames
that a token prompt does not carry.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
from repro_torch.models.model_zoo import init_model
from repro_torch.runtime.serve_loop import BatchServer, ServeConfig


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(f"{cfg.name} serving requires audio frames; a token prompt carries "
                         "none (decode it through make_decode_fn and fill_cross_cache)")
    model = init_model(cfg, seed=0, device=args.device)
    srv = BatchServer(cfg, model, ServeConfig(max_slots=args.slots, max_len=args.max_len),
                      device=args.device)

    t0 = time.perf_counter()
    for i in range(args.requests):
        srv.submit(f"req-{i}", [2 + (i % 11), 5, 7, 3])
    done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    tokens = sum(len(d["tokens"]) for d in done)
    print(f"[serve] {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s)")
    for d in done[:3]:
        print(f"  {d['id']}: {d['tokens'][:10]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
