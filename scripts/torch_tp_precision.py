#!/usr/bin/env python3
"""How far the tensor-parallel bf16 forward and gradient of a reduced config
lie from float32, beside the unsharded bf16 ones, on 4 gloo ranks of the CPU.

    PYTHONPATH=src python scripts/torch_tp_precision.py [--arch granite-moe-1b-a400m]
        [--layers 2] [--seq 64] [--top-k K --capacity-factor C]

On a (2, 2) (data, model) mesh, every layer on the rank's model shard
(``distributed.tensor_parallel``), from ``init_model(seed=0)``:

* the forward: every position's logits of a batch of 4 x 64 tokens (drawn
  from ``default_rng(5)`` below 500), sharded and unsharded, in bf16 and
  float32; each run's largest and rms error against the unsharded float32
  logits;
* the gradient: one SGD step at lr 1 (the update is the gradient) on
  ``chip_smoke.py`` phase 19's batch (``SyntheticLMStream(seed=19)``, 4
  rows of ``--seq`` tokens, the first 16 labels of each row -100, 2
  microbatches): the sharded step in bf16 and float32, the unsharded step
  in bf16 and float32, and a control, the unsharded bf16 step with 4
  microbatches of one row; per leaf ``||g - g_ref|| / ||g_ref||``, the
  worst leaf of each pair printed.

``--top-k`` equal to the config's expert count, with a large
``--capacity-factor``, routes every token to every expert: no top-k choice
is left to flip when the sums run in another order.  Exits 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.data.lm_data import SyntheticLMStream  # noqa: E402
from repro_torch.distributed.spawn import spawn  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.tree import param_tree, tree_map  # noqa: E402

MESH = (2, 2)
BATCH, MICROBATCHES, LR = 4, 2, 1.0


def config(args, dtype):
    overrides = {k: v for k, v in (("top_k", args.top_k),
                                   ("capacity_factor", args.capacity_factor)) if v is not None}
    cfg = reduced_config(args.arch, **overrides)
    return dataclasses.replace(cfg, num_layers=args.layers, dtype=dtype)


def step_batch(cfg, seq: int) -> dict:
    b = next(SyntheticLMStream(cfg.vocab_size, seq, BATCH, seed=19))
    labels = np.array(b["labels"], copy=True)
    labels[:, :16] = -100
    return {"tokens": np.asarray(b["tokens"]), "labels": labels}


def forward_batch() -> dict:
    return {"tokens": np.random.default_rng(5).integers(0, 500, (BATCH, 64)).astype(np.int32)}


def weights(cfg) -> dict:
    return tree_map(lambda p: p.detach().to(cfg.dtype),
                    param_tree(tzoo.init_model(cfg, seed=0, device="cpu")))


def rank_forward(args, dtype) -> np.ndarray:
    """Every position's logits of the sharded forward, gathered whole."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharded_serve import gather_logits, serve_param_shardings
    from repro_torch.distributed.sharding import gather_tensors, shard_state
    from repro_torch.launch.mesh import axis_index, make_mesh
    from repro_torch.tree import tree_leaves

    cfg = config(args, dtype)
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    tree = weights(cfg)
    params = shard_state(tree, serve_param_shardings(tree, cfg, mesh), mesh)
    it = iter(gather_tensors(tree_leaves(params), axes=("data",)))
    local = tree_map(lambda _: next(it), params)
    rows = BATCH // MESH[0]
    d = axis_index(mesh, ("data",))
    batch = {k: v[d * rows:(d + 1) * rows] for k, v in forward_batch().items()}
    with torch.inference_mode(), tp.scope(tp.model_axis(mesh)):
        logits = ttr.forward_params(local, cfg, batch)
    b, s, v = logits.shape
    whole = gather_logits(logits.reshape(b * s, v).float(), mesh, ("data",))
    return whole.numpy().reshape(BATCH, s, -1)


def rank_sgd(args, dtype) -> dict:
    """The parameters after one sharded SGD step, gathered whole."""
    from repro_torch.distributed.sharded_step import sharded_train_step
    from repro_torch.distributed.sharding import (
        P,
        batch_shardings,
        gather_state,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import init_adamw_state

    cfg = config(args, dtype)
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    tree = param_tree(tzoo.init_model(cfg, seed=0, device="cpu"))
    sh = {"params": train_state_shardings(init_adamw_state(tree), cfg, mesh)["params"],
          "lr": P()}
    state = shard_state({"params": tree, "lr": torch.tensor(LR)}, sh, mesh)
    batch = step_batch(cfg, args.seq)
    step = sharded_train_step(cfg, None, mesh, sh, batch_shardings(batch, cfg, mesh),
                              num_microbatches=MICROBATCHES)
    state, _ = step(state, batch)
    return tree_to_numpy(gather_state(state["params"]))


def unsharded_sgd(args, dtype, microbatches: int) -> dict:
    cfg = config(args, dtype)
    state = {"params": tzoo.init_model(cfg, seed=0, device="cpu"), "lr": LR}
    step = tzoo.make_train_step(cfg, None, num_microbatches=microbatches, device="cpu")
    state, _ = step(state, step_batch(cfg, args.seq))
    return tree_to_numpy(state["params"])


def leaf_gaps(trees: dict, init: dict, pairs) -> dict:
    """Per pair, the worst leaf's ``||(a - init) - (b - init)|| / ||b - init||``."""
    out = {}

    def walk(nodes, i, where, acc):
        if isinstance(i, dict):
            for key in i:
                walk({n: t[key] for n, t in nodes.items()}, i[key], f"{where}/{key}", acc)
            return
        i = np.asarray(i, np.float64)
        delta = {n: np.asarray(t, np.float64) - i for n, t in nodes.items()}
        for a, b in pairs:
            acc.setdefault((a, b), []).append(
                (float(np.linalg.norm(delta[a] - delta[b]) / max(np.linalg.norm(delta[b]), 1e-30)),
                 where))

    acc: dict = {}
    walk(trees, init, "", acc)
    for pair, vals in acc.items():
        out[pair] = max(vals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64, help="tokens a row of the SGD step's batch")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)

    truth = None
    print(f"{args.arch}, {args.layers} layers, mesh {MESH} (data, model), 4 gloo ranks on the CPU")
    for dtype in (torch.float32, torch.bfloat16):
        cfg = config(args, dtype)
        with torch.inference_mode():
            unsharded = ttr.forward_params(weights(cfg), cfg, forward_batch()).float().numpy()
        sharded = spawn(rank_forward, 4, device="cpu", backend="gloo", args=(args, dtype))[0]
        if truth is None:
            truth = unsharded
        live = truth > -1e8
        for side, got in (("unsharded", unsharded), ("sharded", sharded)):
            err = np.abs(got - truth)[live]
            print(f"  forward {str(dtype)[6:]} {side}: against unsharded float32, max "
                  f"{err.max():.4e}, rms {np.sqrt(np.mean(err ** 2)):.4e}")

    init = tree_to_numpy(tzoo.init_model(config(args, torch.float32), seed=0, device="cpu"))
    trees = {"unsharded": unsharded_sgd(args, torch.bfloat16, MICROBATCHES),
             "control": unsharded_sgd(args, torch.bfloat16, BATCH),
             "unsharded f32": unsharded_sgd(args, torch.float32, MICROBATCHES)}
    for label, dtype in (("sharded", torch.bfloat16), ("sharded f32", torch.float32)):
        trees[label] = spawn(rank_sgd, 4, device="cpu", backend="gloo", args=(args, dtype))[0]
    print(f"  one SGD step at lr {LR:g} on {BATCH} x {args.seq} tokens, the worst leaf's "
          "||g - g_ref|| / ||g_ref||:")
    for (a, b), (gap, where) in leaf_gaps(trees, init, (
            ("sharded", "unsharded f32"), ("unsharded", "unsharded f32"),
            ("control", "unsharded f32"), ("sharded", "unsharded"), ("control", "unsharded"),
            ("sharded f32", "unsharded f32"))).items():
        print(f"    {a} vs {b}: {gap:.4e} ({where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
