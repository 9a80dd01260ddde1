"""Per-rank bodies of the sharded tests (``test_torch_distributed*.py``).

``repro_torch.distributed.spawn`` runs them in its rank processes, which
import this module by name; it imports no JAX, so the ranks load only
PyTorch and the port.
"""

import time

import numpy as np
import torch

from repro_torch.core import cp_als as tcp
from repro_torch.core import cp_als_fused as tfused
from repro_torch.core import mttkrp as tm
from repro_torch.core.sparse_tensor import SparseTensor, random_sparse_tensor
from repro_torch.distributed import rank_device
from repro_torch.distributed.mttkrp_dist import sharded_setup
from repro_torch.kernels.mttkrp import kernel as tkernel
from repro_torch.tree import tree_leaves

SCHEMES = ("allreduce", "mode_ordered")


def sharded_cases() -> list[tuple]:
    """``(tensor, factors, ordering, rows_per_block)`` of ``tests/test_distributed.py``
    (3-, 4- and 5-mode, uneven, a single nonzero, rank 1, one output block,
    fewer nonzeros than shards), a restart batch of factors, and the
    ``blocked`` order at dims past one input band.  Factors are numpy,
    normal from a seed."""
    rng = np.random.default_rng(0)

    def facs(t, rank, batch=None):
        lead = () if batch is None else (batch,)
        return [rng.standard_normal(lead + (s, rank)).astype(np.float32) for s in t.shape]

    out = []
    for shape, nnz, seed in (((97, 40, 33), 1200, 3), ((61, 47, 33), 1201, 3),
                             ((25, 19, 13, 11), 875, 4), ((13, 11, 9, 7, 5), 403, 5)):
        t = random_sparse_tensor(shape, nnz, seed=seed)
        out.append((t, facs(t, 16), None, 256))
    single = SparseTensor(np.array([[5, 2, 7]], np.int32), np.array([2.5], np.float32), (11, 6, 9))
    out.append((single, facs(single, 8), None, 256))
    t = random_sparse_tensor((30, 20, 10), 200, seed=21)
    out.append((t, facs(t, 1), None, 256))
    idx = np.stack([rng.integers(0, 16, 300), rng.integers(0, 40, 300),
                    rng.integers(0, 40, 300)], axis=1).astype(np.int32)
    one_block = SparseTensor(idx, rng.standard_normal(300).astype(np.float32), (256, 40, 40))
    out.append((one_block, facs(one_block, 16), None, 256))
    t = random_sparse_tensor((40, 30, 20), 5, seed=13)
    out.append((t, facs(t, 16), None, 256))
    t = random_sparse_tensor((50, 40, 30), 700, seed=8, zipf_a=0.8)
    out.append((t, facs(t, 8, batch=3), None, 256))
    t = random_sparse_tensor((300, 280, 260), 4000, seed=7, zipf_a=0.9)
    out.append((t, facs(t, 8), "blocked", 16))
    return out


def sharded_outputs(cases, device: str) -> dict:
    """Every case's sharded MTTKRP, each mode and scheme (in that order), on
    this rank (``outs``); the rank's split-kernel launches over them and the
    count expected (one a call, one more for a residual pass); and whether
    a second ``mode_ordered`` call of each gave the same bits."""
    dev = rank_device(device)
    tkernel.reset_launch_counts()
    outs, calls = [], []
    for t, facs, ordering, rpb in cases:
        f = [torch.from_numpy(x).to(dev) for x in facs]
        for mode in range(t.nmodes):
            for scheme in SCHEMES:
                got = tm.mttkrp(t, f, mode, impl="sharded", scheme=scheme, ordering=ordering,
                                rows_per_block=rpb)
                outs.append(got.cpu().numpy())
                calls.append((got, f, t, mode, scheme, ordering, rpb))
    launches = tkernel.mttkrp_cuda.launches_by_variant["split"]
    expected = sum(1 + (sharded_setup(t, mode, scheme=scheme, ordering=ordering,
                                      rows_per_block=rpb, device=dev).leftover_plan is not None)
                   for _, _, t, mode, scheme, ordering, rpb in calls)
    # Every rank makes every call (each is collective) before any is judged.
    repeat = all([torch.equal(got, tm.mttkrp(t, f, mode, impl="sharded", ordering=ordering,
                                              rows_per_block=rpb))
                  for got, f, t, mode, scheme, ordering, rpb in calls
                  if scheme == "mode_ordered"])
    return dict(outs=outs, launches=launches, expected=expected, repeat=repeat)


def sharded_cp_als(t, rank: int, inits, n_iters: int, device: str) -> dict:
    """Eager ``cp_als(impl="sharded")`` from ``inits[0]`` and
    ``FusedCPALS(impl="sharded")`` from every init, in both schemes."""
    dev = rank_device(device)
    out = {}
    for scheme in SCHEMES:
        eager = tcp.cp_als(t, rank, n_iters=n_iters, tol=0.0, impl="sharded", scheme=scheme,
                           device=dev, init_factors=inits[0])
        fused = tfused.FusedCPALS(t, rank, impl="sharded", scheme=scheme, device=dev).run(
            n_iters=n_iters, tol=0.0, init_factors=inits, fit_every=n_iters)
        out[scheme] = (eager.fits, fused.fits)
    return out


def failing_rank() -> None:
    """Rank 1 raises once every rank has finished setting up the group (one
    barrier: a rank that left while the others were still connecting would
    fail their connection, and ``spawn`` could report that first); the
    others wait, outside any collective, until ``spawn`` stops them (a
    collective would fail too, and race it)."""
    torch.distributed.barrier()
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 planted failure")
    time.sleep(120)


# -- the sharded LM paths (test_torch_distributed_lm.py) ----------------------

LM_TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=4, num_kv_heads=4, head_dim=8,
               vocab_size=64, num_experts=4, top_k=2, moe_d_ff=32)  # tests/test_distributed.py:203
LOOP_TINY = dict(num_layers=1, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16,
                 vocab_size=64)
# (label, microbatches, layout, batches), each run by JAX's pjit step too
LM_RUNS = (("mb1", 1, "2d", "batches"), ("mb2", 2, "2d", "batches"),
           ("dp_only-mb2", 2, "dp_only", "batches8"), ("sgd-mb2", 2, "2d", "batches"),
           ("int8ef-mb2", 2, "2d", "batches1"))


def lm_run_state(label: str, model):
    """The optimiser and initial state of one of ``LM_RUNS``."""
    from repro_torch.optim import AdamW, Int8ErrorFeedback, init_adamw_state

    if label.startswith("sgd"):
        return None, {"params": model, "lr": torch.tensor(0.05)}
    if label.startswith("int8ef"):
        opt = AdamW(compressor=Int8ErrorFeedback())
        return opt, opt.compressor.init_state(init_adamw_state(model, lr=1e-2))
    return AdamW(), init_adamw_state(model, lr=1e-2)
DECODE_TINY = dict(num_layers=1, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16,
                   vocab_size=64)  # tests/test_distributed.py:118


def _np_tree(tree):
    from repro_torch.convert import tree_to_numpy

    return tree_to_numpy(tree)


def lm_ranks(inputs: dict, workdir: str) -> dict:
    """Every sharded LM case on one 4-rank group: local slices on (2, 2); the
    sharded train step (2 steps, 1 and 2 microbatches; and 2 under
    "dp_only"); the elastic restore of its state onto (4, 1) and (1, 4), and
    of JAX's sharded checkpoint; ``train(state_shardings=)`` and its resume;
    the sharded decode on 4 windows; both collectives.  Rank 0 returns the
    full results, every rank its own local ones."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data.lm_data import SyntheticLMStream
    from repro_torch.distributed import collectives as tcoll
    from repro_torch.distributed.decode import sharded_decode_attention
    from repro_torch.distributed.layout import layout_scope
    from repro_torch.distributed.sharded_step import sharded_train_step
    from repro_torch.distributed.sharding import (
        P,
        batch_shardings,
        gather_state,
        shard_state,
        train_state_shardings,
    )
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.optim import AdamW, init_adamw_state
    from repro_torch.runtime import checkpoint as tckpt
    from repro_torch.runtime.train_loop import TrainLoopConfig, train

    ttr.grad_fence_bf16 = lambda x: x  # out of both sides, as test_torch_train.py does
    rank = dist.get_rank()
    out: dict = {"rank": rank}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out["coord"] = tuple(mesh.get_coordinate())

    # local slices
    slices = []
    for shape, spec in inputs["slice_cases"]:
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        placed = shard_state({"x": full}, {"x": P(*spec)}, mesh)
        back = gather_state(placed)["x"]
        slices.append((placed["x"].to_local().numpy(), bool(torch.equal(back, full))))
    out["slices"] = slices

    # the sharded train step
    cfg = treg.reduced_config("granite-moe-1b-a400m", dtype=torch.float32, **LM_TINY)
    runs = {}
    for label, mb, layout, key in LM_RUNS:
        batches = inputs[key]
        with layout_scope(layout):
            opt, state = lm_run_state(label, lm_params_from_numpy(cfg, inputs["params"],
                                                                  device="cpu"))
            ssh = train_state_shardings(state, cfg, mesh)
            sstate = shard_state(state, ssh, mesh)
            step = sharded_train_step(cfg, opt, mesh, ssh,
                                      batch_shardings(batches[0], cfg, mesh), num_microbatches=mb)
            metrics = []
            for batch in batches:
                sstate, m = step(sstate, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        full = gather_state(sstate)
        runs[label] = {"metrics": metrics, "state": _np_tree(full) if rank == 0 else None}
        if label == "mb2":
            kept, kept_full, kept_ssh = sstate, full, ssh
    out["runs"] = runs

    # the elastic restore of the (2, 2) state, and of JAX's sharded checkpoint
    ck = os.path.join(workdir, "elastic")
    tckpt.save_checkpoint(ck, 2, kept, extra_metadata={"from": "2x2"})
    out["saved_on_disk"] = os.path.isdir(os.path.join(ck, f"{2:010d}"))
    restores = {}
    for shape in ((4, 1), (1, 4), (2, 2)):
        m2 = make_mesh(shape, ("data", "model"), device="cpu")
        ssh2 = train_state_shardings(kept_full, cfg, m2)
        for source, path in (("port", ck), ("jax", inputs["jax_ckpt"])):
            got, meta = tckpt.restore_checkpoint(path, kept_full, shardings=ssh2, mesh=m2)
            placed_ok = all(list(a.placements) == list(b.placements) for a, b in zip(
                tree_leaves(got), tree_leaves(shard_state(kept_full, ssh2, m2))))
            whole = gather_state(got)
            restores[(shape, source)] = {
                "placed": placed_ok, "meta": meta,
                "equal": (all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                               tree_leaves(kept_full)))
                          if source == "port" else None),
                "state": _np_tree(whole) if rank == 0 and source == "jax" else None}
    out["restores"] = restores
    del kept, kept_ssh

    # refusals of the sharded step
    zstate = shard_state(init_adamw_state(lm_params_from_numpy(cfg, inputs["params"],
                                                               device="cpu")),
                         train_state_shardings(kept_full, cfg, mesh, zero1=True), mesh)
    zstep = sharded_train_step(cfg, AdamW(), mesh, train_state_shardings(kept_full, cfg, mesh,
                                                                         zero1=True),
                               batch_shardings(inputs["batches"][0], cfg, mesh))
    try:
        zstep(zstate, inputs["batches"][0])
        out["zero1_refused"] = None
    except ValueError as exc:
        out["zero1_refused"] = str(exc)

    # train(state_shardings=), and its resume
    lcfg = treg.reduced_config("internlm2-1.8b", dtype=torch.float32, **LOOP_TINY)
    loop_dir = os.path.join(workdir, "loop")
    lparams = lambda: lm_params_from_numpy(lcfg, inputs["loop_params"], device="cpu")  # noqa
    lssh = train_state_shardings(init_adamw_state(lparams()), lcfg, mesh)
    hist, resumed = [], []
    for total in (4, 6):
        loop = TrainLoopConfig(total_steps=total, log_every=1, save_every=2, lr=1e-2,
                               num_microbatches=2, checkpoint_dir=loop_dir)
        res = train(lcfg, loop, stream=SyntheticLMStream(lcfg.vocab_size, 16, 4, seed=1),
                    optimizer=AdamW(), init_params_fn=lparams, state_shardings=lssh,
                    mesh=mesh, device="cpu")
        hist += res["history"]
        resumed.append(res["resumed_from"])
    out["loop"] = {"history": hist, "resumed": resumed,
                   "sharded": type(res["state"]["m"]["final_ln"]).__name__}

    # the sharded decode, the cache's sequence over 4 ranks
    mesh4 = make_mesh((4,), ("model",), device="cpu")
    dcfg = treg.reduced_config("internlm2-1.8b", dtype=torch.float32, **DECODE_TINY)
    aparams = {k: torch.from_numpy(np.array(v)) for k, v in inputs["attn_params"].items()}
    b, smax = inputs["decode_x"].shape[1], inputs["decode_smax"]
    s_local = smax // 4
    k_l = torch.zeros((b, s_local, dcfg.num_kv_heads, dcfg.head_dim))
    v_l = torch.zeros_like(k_l)
    pos = torch.from_numpy(inputs["decode_pos"]).long()
    outs = []
    for x in inputs["decode_x"]:
        o, k_l, v_l = sharded_decode_attention(aparams, dcfg, mesh4, torch.from_numpy(x), k_l,
                                               v_l, pos)
        outs.append(o.numpy())
        pos = pos + 1
    out["decode"] = {"out": np.stack(outs), "k": k_l.numpy(), "v": v_l.numpy()}

    # the collectives over the 4 ranks
    group = axis_group(mesh4, "model")
    x = torch.from_numpy(inputs["psum_x"][rank:rank + 1])
    out["psum"] = tcoll.compressed_psum(x, group).numpy()
    w = torch.from_numpy(inputs["ring_w"])
    n_local = w.shape[1] // 4
    out["ring"] = tcoll.ring_allgather_matmul(
        torch.from_numpy(inputs["ring_x"]), w[:, rank * n_local:(rank + 1) * n_local], group,
        4).numpy()
    return out
