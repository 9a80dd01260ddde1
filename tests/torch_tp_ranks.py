"""Per-rank body of ``tests/test_torch_tensor_parallel.py``: the sharded
prefill, decode and train step under tensor parallelism on a (2, 2) mesh of
4 gloo ranks.  Imports no JAX, so the ranks load only PyTorch and the port."""

import numpy as np
import torch

# (name, arch, overrides of reduced_config): every family, one config whose KV
# heads do not divide the model axis and one whose query heads do not
PREFILL_CASES = (
    ("internlm2", "internlm2-1.8b", {}),
    ("internlm2-kv1", "internlm2-1.8b", {"num_kv_heads": 1}),
    ("internlm2-h3", "internlm2-1.8b", {"num_heads": 3, "num_kv_heads": 1, "head_dim": 32,
                                         "d_model": 96}),
    ("granite-moe", "granite-moe-1b-a400m", {}),
    ("rwkv6", "rwkv6-3b", {}),
    ("zamba2", "zamba2-1.2b", {}),
    ("whisper", "whisper-base", {}),
    ("internvl2", "internvl2-26b", {}),
)
# decode: the cache's KV heads on the model axis, its sequence there (KV = 1),
# and the recurrent families' states (heads on the model axis)
DECODE_CASES = ("internlm2", "internlm2-kv1", "rwkv6", "zamba2")
BATCH, SEQ, DECODE_STEPS, DECODE_CACHE = 4, 32, 12, 16
TRAIN_ROWS = 8
MESH = (2, 2)


def case_config(name: str):
    from repro_torch.configs import registry as treg

    arch, overrides = {c[0]: c[1:] for c in PREFILL_CASES}[name]
    return treg.reduced_config(arch, dtype=torch.float32, **overrides)


def tp_ranks(inputs: dict, workdir: str) -> dict:
    """Each case's sharded prefill (the logits gathered whole, the rank's
    matmul flops), the sharded decode's steps, the vocabulary-parallel
    loss and its gradient, the granite-moe train step's matmul flops, and
    rank 0's traced collectives of each case's prefill and decode step
    beside the calls the dry run's rank records for them on ``meta``."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharded_serve import (
        gather_logits,
        serve_param_shardings,
        sharded_decode,
        sharded_prefill,
    )
    from repro_torch.distributed.sharded_step import sharded_train_step
    from repro_torch.distributed.sharding import (
        batch_shardings,
        decode_state_shardings,
        gather_tensors,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.optim import AdamW, init_adamw_state
    from repro_torch.perf import coll_breakdown as cb
    from repro_torch.perf.op_cost import OpCounter
    from repro_torch.tree import tree_leaves

    ttr.grad_fence_bf16 = lambda x: x
    rank = dist.get_rank()
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    shape = MeshShape(MESH, ("data", "model"))
    out: dict = {"rank": rank, "coord": tuple(mesh.get_coordinate()), "prefill": {},
                 "decode": {}, "traced": {}}

    def placed(name):
        cfg = case_config(name)
        tree = lm_params_from_numpy(cfg, inputs["params"][name], device="cpu").params()
        psh = serve_param_shardings(tree, cfg, mesh)
        return cfg, tree, psh, shard_state(tree, psh, mesh)

    for name, _, _ in PREFILL_CASES:
        cfg, tree, psh, params = placed(name)
        batch = inputs["batches"][name]
        bsh = batch_shardings(batch, cfg, mesh)
        prefill = sharded_prefill(cfg, mesh, psh, bsh)
        with OpCounter() as counter:
            local = prefill(params, batch)
        traced = rank == 0
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) if traced else \
                _null() as prof:
            local = prefill(params, batch)
        if traced:
            prof.export_chrome_trace(f"{workdir}/prefill-{name}.json")
            c = dict(params=tree, psh=psh, bsh=bsh,
                     batch={k: torch.from_numpy(v) for k, v in batch.items()})
            out["traced"]["prefill", name] = (
                cb.records_from_trace(f"{workdir}/prefill-{name}.json"),
                dryrun.rank_collectives(cfg, "prefill", c, shape))
        with OpCounter() as apart:  # the weights' gather: the dry run's collective record
            gather_tensors(tree_leaves(params), axes=("data",))
        out["prefill"][name] = {"local": local.numpy(), "flops": counter.cost.matmul_flops,
                                "count": counter.cost.flops - apart.cost.flops,
                                "whole": gather_logits(local, mesh, ("data",)).numpy()}

    for name in DECODE_CASES:
        cfg, tree, psh, params = placed(name)
        state = ttr.init_decode_state(cfg, BATCH, DECODE_CACHE, cache_dtype=torch.float32,
                                      device="cpu")
        ssh = decode_state_shardings(state, cfg, mesh)
        tokens = inputs["decode_tokens"]
        tsh = batch_shardings({"tokens": tokens[0]}, cfg, mesh)["tokens"]
        sstate = shard_state(state, ssh, mesh)
        step = sharded_decode(cfg, mesh, psh, tsh, ssh)
        logits = []
        for i, tok in enumerate(tokens):
            traced = rank == 0 and i == 9
            with profile(activities=[ProfilerActivity.CPU], record_shapes=True) if traced \
                    else _null() as prof:
                local, sstate = step(params, torch.from_numpy(tok), sstate)
            if traced:
                prof.export_chrome_trace(f"{workdir}/decode-{name}.json")
                c = dict(params=tree, psh=psh, bsh=tsh, ssh=ssh,
                         batch={"tokens": torch.from_numpy(tok), "state": state})
                out["traced"]["decode", name] = (
                    cb.records_from_trace(f"{workdir}/decode-{name}.json"),
                    dryrun.rank_collectives(cfg, "decode", c, shape))
            logits.append(gather_logits(local, mesh, ("data",)).numpy())
        out["decode"][name] = {"logits": np.stack(logits),
                               "windows": sorted(k for k in ("k", "v") if k in ssh
                                                 and ssh[k][2] == "model")}

    # the vocabulary-parallel loss on the rank's shard of the logits
    logits = torch.from_numpy(inputs["loss_logits"])
    labels = torch.from_numpy(inputs["loss_labels"]).long()
    axis = tp.model_axis(mesh)
    v_local = logits.shape[-1] // MESH[1]
    shard = logits[..., axis.index * v_local:(axis.index + 1) * v_local].clone().requires_grad_()
    with tp.scope(axis):
        loss = ttr.cross_entropy_loss(shard, labels, vocab=logits.shape[-1])
        loss.backward()
    out["loss"] = {"loss": float(loss), "grad": shard.grad.numpy(), "index": axis.index}

    # the granite-moe train step's matmul flops on the rank
    cfg = case_config("granite-moe")
    state = init_adamw_state(lm_params_from_numpy(cfg, inputs["params"]["granite-moe"],
                                                  device="cpu"))
    ssh = train_state_shardings(state, cfg, mesh)
    bsh = batch_shardings(inputs["train_batch"], cfg, mesh)
    step = sharded_train_step(cfg, AdamW(), mesh, ssh, bsh)
    sstate = shard_state(state, ssh, mesh)
    with OpCounter() as counter:
        _, metrics = step(sstate, inputs["train_batch"])
    out["train"] = {"flops": counter.cost.matmul_flops, "loss": float(metrics["loss"])}
    return out


def hanging_ranks() -> None:
    """Rank 0 enters an ``all_reduce`` that rank 1 never calls."""
    import time

    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(4))
    time.sleep(300)


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
