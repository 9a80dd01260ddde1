"""Per-rank body of ``tests/test_torch_coll_breakdown.py``: a sharded train
step profiled on a group of 4 gloo ranks.  Imports no JAX, so the ranks
load only PyTorch and the port."""

import numpy as np
import torch

TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4, num_kv_heads=4, head_dim=8,
            vocab_size=64, num_experts=4, top_k=2, moe_d_ff=32)
# (label, layout, microbatches, dtype)
RUNS = (("2d-bf16-mb2", "2d", 2, torch.bfloat16), ("dp_only-f32", "dp_only", 1, torch.float32))


def profiled_steps(workdir: str) -> dict:
    """For each of ``RUNS``: two steps of ``sharded_train_step`` on a (2, 2)
    mesh, the second under ``torch.profiler``; rank 0 writes its chrome
    trace to ``workdir`` and returns the paths and the calls the dry run's
    rank records on ``meta`` for the same step (``launch.dryrun.rank_collectives``)."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.layout import layout_scope
    from repro_torch.distributed.sharded_step import sharded_train_step
    from repro_torch.distributed.sharding import (
        batch_shardings,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import AdamW, init_adamw_state

    rank = dist.get_rank()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 64, (8, 16)).astype(np.int32) for k in ("tokens", "labels")}
    out = {}
    for label, layout, mb, dtype in RUNS:
        cfg = treg.reduced_config("granite-moe-1b-a400m", dtype=dtype, **TINY)
        with layout_scope(layout):
            state = init_adamw_state(zoo.init_model(cfg, seed=0, device="cpu"))
            ssh = train_state_shardings(state, cfg, mesh)
            bsh = batch_shardings(batch, cfg, mesh)
            sstate = shard_state(state, ssh, mesh)
            step = sharded_train_step(cfg, AdamW(), mesh, ssh, bsh, num_microbatches=mb)
            sstate, _ = step(sstate, batch)
            with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
                sstate, _ = step(sstate, batch)
            c = dict(state=state, specs=ssh, bsh=bsh, n_ub=mb,
                     batch={k: torch.from_numpy(v) for k, v in batch.items()})
            records = dryrun.rank_collectives(cfg, "train", c,
                                              MeshShape((2, 2), ("data", "model")))
        if rank == 0:
            path = f"{workdir}/{label}.json"
            prof.export_chrome_trace(path)
            out[label] = {"trace": path, "records": records}
    return out


def counted_step(arch: str, seq: int, rows: int, microbatches: int) -> dict:
    """One ``sharded_train_step`` on a (1, 1) mesh of this one rank, under
    ``perf.op_cost.OpCounter``.  The weights' gather and the loss's
    finiteness check are also counted apart, by a second counter around
    each call (both counters read their ops): the dry run prices the gather
    as a collective record instead of its copies, and a ``meta`` loss has no
    value to check."""
    import repro_torch.distributed.sharded_step as ss
    from repro_torch.configs import registry as treg
    from repro_torch.distributed.layout import layout_scope, pick_layout
    from repro_torch.distributed.sharding import (
        batch_shardings,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import AdamW, init_adamw_state
    from repro_torch.perf.op_cost import OpCounter

    apart = OpCounter()

    def counted_apart(fn):
        def wrapped(*args, **kwargs):
            with apart:
                return fn(*args, **kwargs)
        return wrapped

    ss.gather_tensors = counted_apart(ss.gather_tensors)
    ss.check_finite = counted_apart(ss.check_finite)
    cfg = treg.reduced_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    with layout_scope(pick_layout(cfg, "train")):
        state = init_adamw_state(zoo.init_model(cfg, seed=0, device="cpu"))
        ssh = train_state_shardings(state, cfg, mesh)
        bsh = batch_shardings(batch, cfg, mesh)
        sstate = shard_state(state, ssh, mesh)
        step = ss.sharded_train_step(cfg, AdamW(), mesh, ssh, bsh,
                                     num_microbatches=microbatches)
        with OpCounter() as counter:
            _, metrics = step(sstate, batch)
    return {"flops": counter.cost.flops, "bytes": counter.cost.bytes,
            "apart_flops": apart.cost.flops, "apart_bytes": apart.cost.bytes,
            "loss": float(metrics["loss"])}
