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
  ``perf.op_cost.OpCounter``, under the rank's model axis
  (``distributed.tensor_parallel``, recording its calls on ``meta``), so
  every layer computes the rank's model shard as JAX's partitioned program
  gives it to the device (heads, hidden width, experts, vocabulary; a
  weight the rules replicate computed whole):

  - train: ``sharded_train_step``'s own body (``rank_train_step``).  The
    rank casts its weight shards and gathers them over the data axes, runs
    its data shard's rows of each microbatch of the global batch (one
    counted ``num_microbatches`` times), reduce-scatters or sums the
    float32 gradients of its model shards over the data group and updates
    its shards with AdamW;
  - prefill: ``sharded_serve.rank_prefill`` on the data shard's rows, the
    bf16 weights gathered over the data axes where the serving rule shards
    them there;
  - decode: ``sharded_serve.rank_decode`` on the data shard's rows and the
    rank's shards of the state; a cache sharded on its sequence is attended
    window by window (``distributed.decode.window_decode_attention``).

  The gathers are counted among the collectives and their outputs in the
  peak.  A rank on ``meta`` has no group to call: its collectives are the
  calls its run records instead of making them (``rank_collectives``): the
  data axes' gathers and sums (``sharded_step.RankComm``) and the model
  axis's calls of every layer, forward, backward and remat's recompute
  (``distributed.tensor_parallel``), those of the microbatch counted once
  made ``num_microbatches`` times.  The CPU tests and ``chip_smoke.py`` hold
  them to the calls a traced run on a group makes;
* prices the counts with ``perf.roofline.roofline_from_stats`` at the
  ``H100_SXM`` record's peaks.

A cell whose modelled peak passes the card's 80 GB is ``"status": "ok",
"fits": false``.

The scans' flops are their kernels' TF32 products, priced here at the bf16
peak like every other flop.

Usage (the counts do not depend on the host; every cell runs on the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each cell is written to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.distributed.layout import layout_scope, pick_layout
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharded_serve import (
    SERVE_FSDP_BYTES,
    rank_decode,
    rank_prefill,
    serve_param_shardings,
    windowed_caches,
)
from repro_torch.distributed.sharded_step import (
    RankComm,
    data_group_axes,
    gather_collectives,
    rank_train_step,
    tp_axes,
)
from repro_torch.distributed.sharding import (
    P,
    batch_shardings,
    decode_state_shardings,
    local_slices,
    spec_leaves,
    train_state_shardings,
)
from repro_torch.launch.mesh import MODEL_AXIS, MeshShape
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.adamw import AdamW, init_adamw_state
from repro_torch.perf.coll_stats import collective_stats
from repro_torch.perf.op_cost import OpCounter
from repro_torch.perf.roofline import H100_SXM, model_flops_for, roofline_from_stats
from repro_torch.tree import param_tree, tree_leaves, tree_map

__all__ = ["PRODUCTION_MESHES", "RESULTS_DIR", "SERVE_FSDP_BYTES", "argument_bytes",
           "cell_setup", "default_microbatches", "dryrun_cell", "main", "mesh_name",
           "rank_collectives", "run_and_save"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PRODUCTION_MESHES = {False: MeshShape((16, 16), ("data", "model")),
                     True: MeshShape((2, 16, 16), ("pod", "data", "model"))}


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


def _counted_once(counter: OpCounter, n: int, records: list | None = None):
    """Microbatch indices for ``microbatch_grads``: index 0 only, its body
    counted ``n`` times (the trip-count analogue) and the calls it records
    into ``records`` made ``n`` times."""
    records = [] if records is None else records
    start = len(records)
    with counter.repeat(n):
        yield 0
    records[start:] = records[start:] * n


def _train_work(cfg, counter: OpCounter, c: dict, mesh: MeshShape, optimizer=None):
    """One rank's ``sharded_train_step`` on ``meta``: its body
    (``rank_train_step``) on the rank's slices, under its model axis, with
    a ``RankComm`` that records the calls instead of making them; returns
    the calls and the path."""
    state = dict(c["state"], params=param_tree(c["state"]["params"]))
    specs, batch, n = c["specs"], c["batch"], c["n_ub"]
    data = data_group_axes(c["bsh"])
    d_size = math.prod(mesh.shape[a] for a in data)
    local = {key: _local(state[key], specs[key], mesh) for key in ("params", "m", "v")}
    local.update(step=state["step"], lr=state["lr"])
    counter.hold(local, batch)  # the rank holds the global batch, as the step takes it
    leaves = tree_leaves(state["params"])
    coord = (0,) * len(mesh.sizes)
    comm = RankComm(mesh, spec_leaves(specs["params"]), [p.shape for p in leaves], data,
                    coordinate=coord,
                    compressed=optimizer is not None and optimizer.compressor is not None)
    axis = tp.model_axis(mesh, coordinate=coord, records=comm.records) \
        if tp_axes(mesh, data) else None
    with tp.scope(axis):
        rank_train_step(cfg, optimizer or AdamW(), zoo.make_loss_fn(cfg), state, local, batch,
                        n=n, d_size=d_size, d_idx=0, comm=comm,
                        indices=_counted_once(counter, n, comm.records))
    per_rank = next(iter(batch.values())).shape[0] // (n * d_size)
    tp_size = mesh.shape[MODEL_AXIS] if axis is not None else 1
    path = (f"sharded_train_step on one rank: the weights cast and gathered over "
            f"{'(' + ','.join(data) + ')' if d_size > 1 else 'no group'}"
            + (f", each layer computing its model-axis shard (tensor and expert parallelism "
               f"over {tp_size} ranks)" if tp_size > 1 else ", computed whole")
            + f", {n} microbatch{'es' if n > 1 else ''} of {per_rank} "
            f"row{'s' if per_rank > 1 else ''} (one counted x{n}), the float32 gradients "
            f"reduce-scattered or summed over "
            f"{'(' + ','.join(data) + ')' if d_size > 1 else 'no group'} into the parameters' "
            "sharding, AdamW on the rank's shards")
    return comm.records, path, None


def _serve_specs(cfg, params, mesh: MeshShape):
    return serve_param_shardings(params, cfg, mesh)


def _model_shapes(params, specs, mesh: MeshShape, model) -> list:
    """Each weight's slice on the ``model`` axes alone."""
    coord = (0,) * len(mesh.sizes)
    return [tuple(sl.stop - sl.start for sl in local_slices(
        P(*(tuple(a for a in P(e).axes() if a in model) for e in sp)), p.shape, mesh, coord))
        for p, sp in zip(tree_leaves(params), spec_leaves(specs))]


def _serve_rank(cfg, params, psh, mesh: MeshShape, data, counter: OpCounter, *held):
    """The rank's model shards of the bf16 weights on ``meta`` (new tensors
    where FSDP shards them over the data axes: the gather's results), its
    model axis recording into a list, and that list, which starts with the
    weights' gathers over the data axes (``sharded_serve``'s
    ``gather_tensors``)."""
    model = tp_axes(mesh, data)
    local_p = _local(params, psh, mesh)
    counter.hold(local_p, *held)
    shapes = _model_shapes(params, psh, mesh, model)
    keep = [P(*(tuple(a for a in P(e).axes() if a not in model) for e in sp))
            for sp in spec_leaves(psh)]
    records = gather_collectives([(sh, p.dtype) for sh, p in zip(shapes, tree_leaves(params))],
                                 keep, mesh)
    it = iter(shapes)
    tree = tree_map(lambda x: (lambda sh: x if tuple(x.shape) == sh else
                               torch.empty(sh, dtype=x.dtype, device="meta"))(next(it)),
                    local_p)
    axis = tp.model_axis(mesh, coordinate=(0,) * len(mesh.sizes), records=records) \
        if model else None
    return tree, axis, records


def _prefill_work(cfg, counter: OpCounter, c: dict, mesh: MeshShape):
    params, psh, bsh = c["params"], c["psh"], c["bsh"]
    data = data_group_axes(bsh)
    local_batch = _local(c["batch"], bsh, mesh)
    tree, axis, records = _serve_rank(cfg, params, psh, mesh, data, counter, local_batch)
    with tp.scope(axis):
        out = rank_prefill(cfg, tree, local_batch)
    rows = next(iter(local_batch.values())).shape[0]
    tp_size = mesh.shape[MODEL_AXIS] if axis is not None else 1
    return records, (f"sharded_prefill on {rows} row{'s' if rows > 1 else ''} a rank, the bf16 "
                     "weights " + ("gathered over the data axes" if any(
                         set(P(*sp).axes()) & set(data) for sp in spec_leaves(psh))
                         else "held whole on the data axes")
                     + (f", each layer computing its model-axis shard over {tp_size} ranks, "
                        "logits on a vocabulary shard" if tp_size > 1 else "")), out


def _decode_work(cfg, counter: OpCounter, c: dict, mesh: MeshShape):
    params, psh, bsh, ssh = c["params"], c["psh"], c["bsh"], c["ssh"]
    state = c["batch"]["state"]
    data = data_group_axes({"tokens": bsh})
    local_tok = _local(c["batch"]["tokens"], bsh, mesh)
    local_state = _local(state, ssh, mesh)
    tree, axis, records = _serve_rank(cfg, params, psh, mesh, data, counter, local_tok,
                                      local_state)
    windows = windowed_caches(ssh)
    if axis is not None:
        axis = dataclasses.replace(axis, windows=windows)
    with tp.scope(axis):
        out = rank_decode(cfg, tree, local_tok, local_state)
    rows = local_tok.shape[0]
    n_win = sum(state[k].shape[0] for k in windows) // 2
    path = (f"sharded_decode on {rows} row{'s' if rows > 1 else ''} a rank, each layer "
            f"computing its model-axis shard over {mesh.shape[MODEL_AXIS]} ranks, the state's "
            "shards updated in place" + (f", {n_win} attention{'s' if n_win > 1 else ''} over "
                                         "cache windows sharded on model (the heads gathered, "
                                         "the windows combined)" if n_win else ""))
    return records, path, out


_WORK = {"train": _train_work, "prefill": _prefill_work, "decode": _decode_work}


def rank_collectives(cfg, kind: str, c: dict, mesh: MeshShape, *, optimizer=None) -> list[dict]:
    """The collectives one rank of ``mesh`` makes in a train step, a prefill
    or a decode step (``kind``), as its run on ``meta`` records them, under
    the caller's layout: records for ``perf.coll_stats``
    (``{"kind", "result_bytes", "group", "axes"}``).  ``c`` holds what
    ``cell_setup`` gives (train: ``state``, ``specs``, ``batch``, ``bsh``,
    ``n_ub``; prefill: ``params``, ``psh``, ``batch``, ``bsh``; decode also
    ``ssh`` and the state in ``batch["state"]``); only shapes and dtypes are
    read.  ``optimizer`` (train) is the step's (default AdamW); its
    compressor changes the gradients' sums."""
    with OpCounter() as counter:
        args = (optimizer,) if kind == "train" else ()
        records, _, _ = _WORK[kind](cfg, counter, c, mesh, *args)
    return records


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
    given, receives the collectives the rank's meta run records
    (``rank_collectives``); ``num_microbatches`` replaces JAX's default
    count for a train cell."""
    arch = arch or cfg.name
    app = applicable_shapes(cfg)[spec.name] if spec.name in SHAPES else spec
    if isinstance(app, str):
        return {"arch": arch, "shape": spec.name, "mesh": mesh_name(mesh), "status": "skip",
                "reason": app}
    chips = mesh.size
    t0 = time.time()
    c = cell_setup(cfg, spec, mesh, num_microbatches=num_microbatches)
    layout, n_ub, args = c["layout"], c["n_ub"], c["args"]
    t_build = time.time() - t0
    t0 = time.time()
    counter = OpCounter()
    with layout_scope(layout), counter:
        records, path, out = _WORK[spec.kind](cfg, counter, c, mesh)
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
