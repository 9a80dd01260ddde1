"""The dry run: what every (architecture x shape x mesh) cell costs a rank
under the port's own step (port of ``repro.launch.dryrun``).

JAX's dry run compiles each cell's pjit step for 256 or 512 emulated
devices and reads XLA's memory analysis and compiled HLO.  The port
compiles nothing; for each cell, on one rank, it

* builds the state on ``meta`` (``init_model(device="meta")``,
  ``init_adamw_state``, ``model_zoo.input_specs``): shapes, no storage;
* shards it with the port's rules, which are JAX's: ``train_state_shardings``
  for train; for prefill and decode bf16 weights by ``param_shardings``,
  FSDP over the data axes only when a bf16 tensor-parallel shard passes
  12 GiB (JAX's threshold, kept for parity), ``batch_shardings`` and
  ``decode_state_shardings``.  The argument bytes are the rank's slices
  (``local_slices``): JAX's per-device shards;
* counts one step of the path the port runs on a rank with
  ``perf.op_cost.OpCounter``:

  - train: ``sharded_train_step``'s own body (``rank_train_step``).  The
    rank casts its weight shards and gathers them whole, runs its data
    shard's rows of each microbatch of the global batch (one counted
    ``num_microbatches`` times), sums the float32 gradients over the data
    group and updates its shards with AdamW;
  - prefill: ``make_prefill_fn`` on the data shard's rows, after gathering
    the weights whole (the port has no sharded prefill);
  - decode: ``make_decode_fn`` on the data shard's rows, the weights and
    every state leaf that the rules shard on ``model`` other than a cache's
    sequence gathered whole; a cache sharded on its sequence is attended
    window by window, as ``distributed.decode.sharded_decode_attention``
    does, each layer's window counted as ``decode_attention`` over it.

  The gathers are counted among the collectives and their outputs in the
  peak.  The collectives come in closed form
  (``sharded_step.gather_collectives`` / ``step_collectives``, and the
  window combine's two ``all_reduce``s a layer); a rank on ``meta`` has no
  group to call;
* prices the counts with ``perf.roofline.roofline_from_stats`` at the
  ``H100_SXM`` record's peaks.

Nothing is divided by the model axis: under layout "2d" the ranks that
differ on ``model`` compute the same rows (the port's model axis shards
storage only), so ``useful_ratio`` shows that waste.  A cell whose modelled
peak passes the card's 80 GB is ``"status": "ok", "fits": false``.

The scans' flops are their kernels' TF32 products, priced here at the bf16
peak like every other flop.

Usage (the counts do not depend on the host; every cell runs on the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each cell is written to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.distributed.layout import layout_scope, pick_layout
from repro_torch.distributed.sharded_step import (
    data_group_axes,
    gather_collectives,
    rank_train_step,
    step_collectives,
)
from repro_torch.distributed.sharding import (
    P,
    batch_shardings,
    decode_state_shardings,
    local_slices,
    param_shardings,
    spec_leaves,
    train_state_shardings,
)
from repro_torch.launch.mesh import MODEL_AXIS, MeshShape
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamW, init_adamw_state
from repro_torch.perf.coll_stats import collective_stats
from repro_torch.perf.op_cost import OpCounter
from repro_torch.perf.roofline import H100_SXM, model_flops_for, roofline_from_stats
from repro_torch.tree import param_tree, tree_leaves, tree_map

__all__ = ["PRODUCTION_MESHES", "RESULTS_DIR", "SERVE_FSDP_BYTES", "argument_bytes",
           "cell_setup", "default_microbatches", "dryrun_cell", "main", "mesh_name",
           "run_and_save"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PRODUCTION_MESHES = {False: MeshShape((16, 16), ("data", "model")),
                     True: MeshShape((2, 16, 16), ("pod", "data", "model"))}
SERVE_FSDP_BYTES = 12 * 2**30  # JAX's serving threshold (src/repro/launch/dryrun.py:94)
_CACHES = ("k", "v", "cross_k", "cross_v", "shared_k", "shared_v")


def mesh_name(mesh: MeshShape) -> str:
    return "x".join(str(s) for s in mesh.sizes)


def default_microbatches(cfg, spec, *, dp_size: int, target_bytes: float = 2.5 * 2**30) -> int:
    """Microbatch count bounding per-chip remat residuals (~L*b*S*d bf16)."""
    b_local = max(1, spec.global_batch // dp_size)
    resid = cfg.num_layers * b_local * spec.seq_len * cfg.d_model * 2
    n = 1
    max_n = spec.global_batch // dp_size if spec.global_batch >= dp_size else 1
    while n < max_n and resid / n > target_bytes:
        n *= 2
    return max(1, min(n, max_n))


def _local_shape(shape, spec, mesh: MeshShape) -> tuple[int, ...]:
    """The shape of the slice a rank holds (every rank's is the same size)."""
    return tuple(s.stop - s.start for s in local_slices(spec, shape, mesh, (0,) * len(mesh.sizes)))


def _local(tree, specs, mesh: MeshShape):
    """``tree`` with each tensor replaced by a ``meta`` tensor of its rank's slice."""
    it = iter(spec_leaves(specs))
    return tree_map(lambda x: torch.empty(_local_shape(x.shape, next(it), mesh), dtype=x.dtype,
                                          device="meta"), tree)


def argument_bytes(tree, specs, mesh: MeshShape) -> int:
    """The bytes of a rank's slices of ``tree`` under ``specs``."""
    return sum(math.prod(_local_shape(x.shape, spec, mesh)) * x.element_size()
               for x, spec in zip(tree_leaves(tree), spec_leaves(specs)))


def _gathered(tree, shard_tree, specs, mesh: MeshShape):
    """The gather of the weights before the step: ``tree``'s whole tensors,
    made as new ``meta`` tensors (inside the counter, so they enter the
    peak), after the rank's shards were read; the records of the calls."""
    leaves, local = tree_leaves(tree), tree_leaves(shard_tree)
    records = gather_collectives([(tuple(x.shape), x.dtype) for x in leaves],
                                 spec_leaves(specs), mesh)
    full = [torch.empty_like(x, device="meta") if tuple(x.shape) != tuple(s.shape) else s
            for x, s in zip(leaves, local)]
    it = iter(full)
    return tree_map(lambda _: next(it), tree), records


def _counted_once(counter: OpCounter, n: int):
    """Microbatch indices for ``microbatch_grads``: index 0 only, its body
    counted ``n`` times (the trip-count analogue)."""
    with counter.repeat(n):
        yield 0


def _train_work(cfg, counter: OpCounter, state: dict, specs: dict, batch: dict, bsh,
                mesh: MeshShape, n: int) -> tuple[list[dict], str]:
    """One rank's ``sharded_train_step`` on ``meta``: its body
    (``rank_train_step``) on the rank's slices, the gather's results made as
    new tensors and no sum; returns the step's collectives."""
    data = data_group_axes(bsh)
    d_size = math.prod(mesh.shape[a] for a in data)
    local = {key: _local(state[key], specs[key], mesh) for key in ("params", "m", "v")}
    local.update(step=state["step"], lr=state["lr"])
    counter.hold(local, batch)  # the rank holds the global batch, as the step takes it
    leaves = tree_leaves(state["params"])
    coord = (0,) * len(mesh.sizes)

    def gather(cast: list) -> list[torch.Tensor]:
        """The whole weights: a leaf the rank holds whole is its cast, the
        rest new tensors (the calls are the collective records)."""
        return [c if tuple(c.shape) == tuple(p.shape)
                else torch.empty(p.shape, dtype=c.dtype, device="meta")
                for p, c in zip(leaves, cast)]

    slices = [local_slices(sp, p.shape, mesh, coord)
              for p, sp in zip(leaves, spec_leaves(specs["params"]))]
    rank_train_step(cfg, AdamW(), zoo.make_loss_fn(cfg), state, local, batch, n=n,
                    d_size=d_size, d_idx=0, gather=gather, slices=slices,
                    indices=_counted_once(counter, n))
    records = step_collectives(cfg, state["params"], specs["params"], mesh, bsh)
    per_rank = next(iter(batch.values())).shape[0] // (n * d_size)
    path = (f"sharded_train_step on one rank: the weights cast and gathered whole, "
            f"{n} microbatch{'es' if n > 1 else ''} of {per_rank} row{'s' if per_rank > 1 else ''} "
            f"(one counted x{n}), the float32 gradients summed over "
            f"{'(' + ','.join(data) + ')' if d_size > 1 else 'no group'}, AdamW on the rank's shards")
    return records, path


def _serve_specs(cfg, params, mesh: MeshShape):
    fsdp = cfg.param_count() * 2 / mesh.shape[MODEL_AXIS] > SERVE_FSDP_BYTES
    return param_shardings(params, cfg, mesh, fsdp=fsdp)


def _prefill_work(cfg, counter: OpCounter, params, psh, batch: dict, bsh, mesh: MeshShape):
    local_p, local_batch = _local(params, psh, mesh), _local(batch, bsh, mesh)
    counter.hold(local_p, local_batch)
    full, records = _gathered(params, local_p, psh, mesh)
    del local_p
    rows = next(iter(local_batch.values())).shape[0]
    out = zoo.make_prefill_fn(cfg, device="meta")(Transformer(cfg, full), local_batch)
    return records, f"make_prefill_fn on {rows} row{'s' if rows > 1 else ''} a rank, the bf16 " \
                    "weights gathered whole (the port has no sharded prefill)", out


def _decode_work(cfg, counter: OpCounter, params, psh, batch: dict, bsh, ssh, mesh: MeshShape):
    tp = mesh.shape[MODEL_AXIS]
    state, sspec = batch["state"], ssh
    local_p = _local(params, psh, mesh)
    local_tok = _local(batch["tokens"], bsh, mesh)
    local_state = _local(state, sspec, mesh)
    counter.hold(local_p, local_tok, local_state)
    full, records = _gathered(params, local_p, psh, mesh)
    del local_p
    # state leaves sharded on ``model`` other than a cache's sequence: gathered over model
    gathered, windows = {}, 0
    for key in sorted(state):
        spec = sspec[key]
        if MODEL_AXIS not in P(*spec).axes():
            gathered[key] = local_state[key]
            continue
        if key in _CACHES and spec[2] == MODEL_AXIS:
            gathered[key] = local_state[key]
            windows += state[key].shape[0]
            continue
        data_only = P(*(None if e == MODEL_AXIS else e for e in spec))
        shape = _local_shape(state[key].shape, data_only, mesh)
        records += gather_collectives([(shape, state[key].dtype)], [P(*(
            MODEL_AXIS if e == MODEL_AXIS else None for e in spec))], mesh)
        gathered[key] = torch.empty(shape, dtype=state[key].dtype, device="meta")
    del local_state
    rows = local_tok.shape[0]
    out, _ = zoo.make_decode_fn(cfg, device="meta")(Transformer(cfg, full), local_tok, gathered)
    # each window's flash-decoding combine: an all_reduce MAX of the (B, 1, H)
    # lse and a SUM of the weighted outputs and weights (distributed/decode.py)
    lse = rows * cfg.num_heads * 4
    for _ in range(windows // 2):  # k and v: one attention
        records.append({"kind": "all-reduce", "result_bytes": float(lse), "axes": (MODEL_AXIS,),
                        "group": tp})
        records.append({"kind": "all-reduce", "axes": (MODEL_AXIS,), "group": tp,
                        "result_bytes": float(rows * cfg.num_heads * (cfg.head_dim + 1) * 4)})
    path = (f"make_decode_fn on {rows} row{'s' if rows > 1 else ''} a rank, the bf16 weights "
            "gathered whole" + (f", {windows // 2} attention{'s' if windows > 2 else ''} over "
                                "cache windows sharded on model (sharded_decode_attention's "
                                "combine)" if windows else ""))
    return records, path, out


def cell_setup(cfg, spec, mesh: MeshShape, *, num_microbatches: int | None = None) -> dict:
    """A cell's meta state, its shardings, its microbatch count (JAX's
    ``default_microbatches`` unless given) and the rank's argument bytes
    (``"args"``), under the layout the cell picks."""
    layout = pick_layout(cfg, spec.kind)
    with layout_scope(layout):
        params = param_tree(zoo.init_model(cfg, device="meta"))
        batch = zoo.input_specs(cfg, spec)
        out = dict(layout=layout, batch=batch, n_ub=1)
        if spec.kind == "train":
            state = init_adamw_state(params)
            specs = train_state_shardings(state, cfg, mesh)
            bsh = batch_shardings(batch, cfg, mesh)
            dp_size = mesh.size if layout == "dp_only" else mesh.size // mesh.shape[MODEL_AXIS]
            n_ub = num_microbatches or default_microbatches(cfg, spec, dp_size=dp_size)
            return dict(out, state=state, specs=specs, bsh=bsh, n_ub=n_ub,
                        args=argument_bytes(state, specs, mesh) + argument_bytes(batch, bsh, mesh))
        params = tree_map(lambda p: p.detach().to(torch.bfloat16), params)
        psh = _serve_specs(cfg, params, mesh)
        if spec.kind == "prefill":
            bsh = batch_shardings(batch, cfg, mesh)
            return dict(out, params=params, psh=psh, bsh=bsh,
                        args=argument_bytes(params, psh, mesh) + argument_bytes(batch, bsh, mesh))
        ssh = decode_state_shardings(batch["state"], cfg, mesh)
        bsh = batch_shardings({"tokens": batch["tokens"]}, cfg, mesh)["tokens"]
        return dict(out, params=params, psh=psh, bsh=bsh, ssh=ssh,
                    args=(argument_bytes(params, psh, mesh)
                          + argument_bytes(batch["tokens"], bsh, mesh)
                          + argument_bytes(batch["state"], ssh, mesh)))


def dryrun_cell(cfg, spec, mesh: MeshShape, *, arch: str | None = None,
                calls: list | None = None, num_microbatches: int | None = None) -> dict:
    """The record of one cell: ``cfg`` at ``spec`` on one rank of ``mesh``
    (a ``MeshShape`` with a ``model`` axis), priced at ``H100_SXM``.  ``calls``, if
    given, receives the step's collective records (``perf.coll_stats``);
    ``num_microbatches`` replaces JAX's default count for a train cell."""
    arch = arch or cfg.name
    app = applicable_shapes(cfg)[spec.name] if spec.name in SHAPES else spec
    if isinstance(app, str):
        return {"arch": arch, "shape": spec.name, "mesh": mesh_name(mesh), "status": "skip",
                "reason": app}
    chips = mesh.size
    t0 = time.time()
    c = cell_setup(cfg, spec, mesh, num_microbatches=num_microbatches)
    layout, n_ub, args, batch = c["layout"], c["n_ub"], c["args"], c["batch"]
    t_build = time.time() - t0
    t0 = time.time()
    counter = OpCounter()
    with layout_scope(layout), counter:
        if spec.kind == "train":
            records, path = _train_work(cfg, counter, c["state"], c["specs"], batch, c["bsh"],
                                        mesh, n_ub)
            out = None
        elif spec.kind == "prefill":
            records, path, out = _prefill_work(cfg, counter, c["params"], c["psh"], batch,
                                               c["bsh"], mesh)
        else:
            records, path, out = _decode_work(cfg, counter, c["params"], c["psh"], batch,
                                              c["bsh"], c["ssh"], mesh)
    out_bytes = 0 if out is None else out.numel() * out.element_size()
    t_count = time.time() - t0
    if calls is not None:
        calls.extend(records)
    cost = counter.cost
    cost.add_collectives(records)
    coll = collective_stats(records)
    peak = float(cost.peak_bytes)
    cell = roofline_from_stats(
        arch=arch, shape=spec.name, mesh_name=mesh_name(mesh), chips=chips,
        cost={"flops": cost.flops, "bytes accessed": cost.bytes}, coll=coll,
        model_flops=model_flops_for(cfg, spec), peak_bytes=peak)
    return {
        "arch": arch,
        "shape": spec.name,
        "mesh": mesh_name(mesh),
        "tag": "",
        "status": "ok",
        "chips": chips,
        "num_microbatches": n_ub,
        "layout": layout,
        "lower_s": round(t_build, 2),  # building and sharding the meta state
        "compile_s": round(t_count, 2),  # counting the step
        "memory_analysis": {
            "argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(max(peak - args - out_bytes, 0)),
            "generated_code_size_in_bytes": 0,
        },
        "flops_per_chip": cell.hlo_flops,
        "bytes_per_chip": cell.hlo_bytes,
        "xla_cost_analysis": {"flops": cost.flops, "bytes accessed": cost.bytes},  # the op count
        "unknown_trip_whiles": 0,
        "collectives": {
            "counts": dict(coll.counts),
            "result_bytes": dict(coll.result_bytes),
            "ici_bytes_per_chip": coll.ici_bytes_per_chip,
        },
        "roofline": cell.row(),
        "port_path": path,
        "fits": peak <= H100_SXM.hbm_bytes,
    }


def run_and_save(arch: str, shape_name: str, *, multi_pod: bool,
                 results_dir: Path = RESULTS_DIR) -> dict:
    mesh = PRODUCTION_MESHES[multi_pod]
    try:
        rec = dryrun_cell(get_config(arch), SHAPES[shape_name], mesh, arch=arch)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name(mesh),
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    rec.setdefault("mesh", mesh_name(mesh))
    results_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{arch}__{shape_name}__{rec['mesh']}.json"
    (results_dir / fname).write_text(json.dumps(rec, indent=2, default=float))
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (
            f" compute={r['compute_s']*1e3:.2f}ms memory={r['memory_s']*1e3:.2f}ms"
            f" coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']}"
            f" peak={r['hbm_gb_per_chip'] * 2**30 / 1e9:.1f}GB fits={rec['fits']}"
            f" (build {rec['lower_s']}s count {rec['compile_s']}s)"
        )
    elif status == "error":
        extra = " " + rec["error"][:200]
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: {status}{extra}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), help="one architecture")
    ap.add_argument("--shape", choices=sorted(SHAPES), help="one shape")
    ap.add_argument("--all", action="store_true", help="sweep all cells")
    ap.add_argument("--multi-pod", action="store_true", help="use the (2,16,16) mesh")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = sorted(ARCHITECTURES) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]

    n_ok = n_skip = n_err = 0
    t0 = time.time()
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_and_save(arch, shape, multi_pod=mp)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skip"
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error in {time.time() - t0:.1f} s",
          flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
