"""The port's dry run against the JAX package's (``repro.launch.dryrun``).

* ``model_flops_for`` equals JAX's, exactly, for every config and shape;
* ``default_microbatches`` equals JAX's for every cell on both production
  meshes.  JAX's side runs in a subprocess: importing its dry run sets
  ``XLA_FLAGS`` to 512 host devices, which would reach every later JAX test
  of this process;
* a cell JAX skips is skipped with JAX's reason, string for string;
* a rank's argument bytes, for every config x applicable shape x
  production mesh, equal the sum of one device's shard sizes under JAX's
  rules on ``AbstractMesh`` (train: the AdamW state and the batch; prefill:
  the bf16 weights and the batch; decode: the weights, the tokens and the
  decode state), byte for byte;
* full-size cells finish on ``meta`` and render through the port's
  ``perf/report.py``;
* on a dense path (S = 64, below the flash path's 2048) the count on
  ``meta`` equals the count of the same prefill on CPU tensors, op for op:
  the counter reads one stream of ops wherever the tensors lie;
* a train cell's count on ``meta`` equals ``sharded_train_step``'s on a
  (1, 1) mesh of one gloo rank (``tests/torch_coll_ranks.py``), flops and
  bytes to 1e-9, the gather priced as its collective record.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicable_shapes as japplicable
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.optim.adamw import init_adamw_state as jinit_adamw
from repro.perf.roofline import model_flops_for as jmodel_flops_for
import torch_coll_ranks as ranks
from repro_torch.configs import registry as treg
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes
from repro_torch.distributed.spawn import spawn
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model_zoo as tzoo
from repro_torch.perf import report
from repro_torch.perf.op_cost import OpCounter
from repro_torch.perf.roofline import H100_SXM, model_flops_for

REPO = Path(__file__).resolve().parents[1]
TRAIN_COUNT_RTOL = 1e-9  # the real step's count against meta's
ARCHS = sorted(treg.ARCHITECTURES)
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def test_production_meshes_are_jaxs():
    for multi_pod, (shape, axes) in MESHES.items():
        mesh = dryrun.PRODUCTION_MESHES[multi_pod]
        assert (mesh.sizes, mesh.axis_names) == (shape, axes)
    assert dryrun.mesh_name(dryrun.PRODUCTION_MESHES[True]) == "2x16x16"


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_equals_jaxs(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in SHAPES:
        assert model_flops_for(tcfg, SHAPES[name]) == jmodel_flops_for(jcfg, JSHAPES[name])


def test_default_microbatches_equal_jaxs_on_both_meshes():
    code = (
        "import json\n"
        "from repro.launch import dryrun as d\n"
        "from repro.configs import ARCHITECTURES, get_config\n"
        "from repro.configs.shapes import SHAPES\n"
        "from repro.distributed.layout import pick_layout\n"
        "out = {}\n"
        "for arch in sorted(ARCHITECTURES):\n"
        "    cfg = get_config(arch)\n"
        "    for name, spec in SHAPES.items():\n"
        "        for chips in (256, 512):\n"
        "            dp = chips if pick_layout(cfg, spec.kind) == 'dp_only' else chips // 16\n"
        "            out[f'{arch}|{name}|{chips}'] = d.default_microbatches(cfg, spec, dp_size=dp)\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(want) == len(ARCHS) * len(SHAPES) * 2
    for arch in ARCHS:
        cfg = treg.get_config(arch)
        for name, spec in SHAPES.items():
            for multi_pod in (False, True):
                chips = 512 if multi_pod else 256
                key = f"{arch}|{name}|{chips}"
                assert dryrun.default_microbatches(cfg, spec, dp_size=chips // 16) == want[key]
                if spec.kind == "train":
                    setup = dryrun.cell_setup(cfg, spec, dryrun.PRODUCTION_MESHES[multi_pod])
                    assert setup["n_ub"] == want[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_reasons_are_jaxs(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    want = japplicable(jcfg)
    for name in SHAPES:
        for multi_pod in (False, True):
            if isinstance(want[name], str):
                rec = dryrun.dryrun_cell(tcfg, SHAPES[name], dryrun.PRODUCTION_MESHES[multi_pod],
                                         arch=arch)
                assert rec["status"] == "skip" and rec["reason"] == want[name]
            else:
                assert not isinstance(applicable_shapes(tcfg)[name], str)


def _shard_bytes(tree, shardings, mesh) -> int:
    """One device's bytes of ``tree`` under JAX's shardings (every device's
    shard is the same size under these rules)."""
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(shardings,
                                                  is_leaf=lambda x: hasattr(x, "spec"))):
        n = 1
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        for dim, entry in zip(leaf.shape, spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            div = math.prod(mesh.shape[a] for a in axes)
            assert dim % div == 0
            n *= dim // div
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.eval_shape(lambda: jtr.init_model(jreg.get_config(arch), jax.random.PRNGKey(0)))


def _jax_argument_bytes(arch: str, name: str, multi_pod: bool) -> int:
    """``lower_cell``'s arguments, one device's shards (src/repro/launch/dryrun.py:68-140)."""
    cfg, spec = jreg.get_config(arch), JSHAPES[name]
    mesh = AbstractMesh(*MESHES[multi_pod])
    params = _jax_params(arch)
    batch = jzoo.input_specs(cfg, spec)
    if spec.kind == "train":
        state = jax.eval_shape(functools.partial(jinit_adamw, lr=3e-4), params)
        return (_shard_bytes(state, jsh.train_state_shardings(state, cfg, mesh), mesh)
                + _shard_bytes(batch, jsh.batch_shardings(batch, cfg, mesh), mesh))
    params = jax.tree_util.tree_map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16), params)
    fsdp = cfg.param_count() * 2 / mesh.shape["model"] > 12 * 2**30
    total = _shard_bytes(params, jsh.param_shardings(params, cfg, mesh, fsdp=fsdp), mesh)
    if spec.kind == "prefill":
        return total + _shard_bytes(batch, jsh.batch_shardings(batch, cfg, mesh), mesh)
    toks = {"tokens": batch["tokens"]}
    return (total + _shard_bytes(toks, jsh.batch_shardings(toks, cfg, mesh), mesh)
            + _shard_bytes(batch["state"], jsh.decode_state_shardings(batch["state"], cfg, mesh),
                           mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jaxs_shards_on_the_production_meshes(arch):
    tcfg = treg.get_config(arch)
    n = 0
    for name, spec in SHAPES.items():
        if isinstance(applicable_shapes(tcfg)[name], str):
            continue
        for multi_pod in (False, True):
            got = dryrun.cell_setup(tcfg, spec, dryrun.PRODUCTION_MESHES[multi_pod])["args"]
            assert got == _jax_argument_bytes(arch, name, multi_pod), (name, multi_pod)
            n += 1
    assert n >= 6


FULL_CELLS = [("internlm2-1.8b", "train_4k", False), ("rwkv6-3b", "long_500k", False),
              ("whisper-base", "decode_32k", False), ("qwen3-moe-235b-a22b", "prefill_32k", True)]


@pytest.mark.parametrize("arch,shape,multi_pod", FULL_CELLS)
def test_full_size_cells_finish_on_meta_and_render(arch, shape, multi_pod, tmp_path):
    rec = dryrun.run_and_save(arch, shape, multi_pod=multi_pod, results_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    mesh = "2x16x16" if multi_pod else "16x16"
    assert (tmp_path / f"{arch}__{shape}__{mesh}.json").exists()
    r = rec["roofline"]
    assert r["card"] == H100_SXM.name and rec["chips"] == (512 if multi_pod else 256)
    assert r["compute_s"] == pytest.approx(rec["flops_per_chip"] / 989e12)
    assert r["memory_s"] == pytest.approx(rec["bytes_per_chip"] / 3.35e12)
    assert r["collective_s"] == pytest.approx(rec["collectives"]["ici_bytes_per_chip"] / 450e9)
    assert rec["fits"] == (r["hbm_gb_per_chip"] * 2**30 <= 80e9)
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0 and rec["port_path"]
    # a serving rank keeps its model shards (no gather); every cell's layers
    # call the model axis
    assert sum(rec["collectives"]["counts"].values()) >= 1
    # useful work over the flops of every rank
    assert r["useful_ratio"] == pytest.approx(r["model_flops"] / (rec["flops_per_chip"]
                                                                  * rec["chips"]))
    cells = report.load_cells(tmp_path)
    table = report.roofline_table_md(cells, mesh)
    assert f"| {arch} | {shape} |" in table and f"**{r['dominant']}**" in table
    assert "cells compiled OK: **1**" in report.dryrun_summary_md(cells)
    if shape == "train_4k":  # the data group's sums: one reduce-scatter, one all-reduce;
        # the norm's all-reduce; and the model axis's, every layer and microbatch
        counts = rec["collectives"]["counts"]
        assert rec["num_microbatches"] > 1 and counts["reduce-scatter"] == 1
        assert counts["all-reduce"] > 2 * rec["num_microbatches"] * 24


def test_a_train_cell_that_cannot_fit_reads_fits_false():
    """Every rank holds the bf16 weights gathered over the data axes and the
    float32 gradients of its model-axis shard of every leaf under the port's
    step: 6 bytes a model-local parameter.  yi-34b's 56 query heads do not
    divide the model axis, so its attention stays whole on every rank: 8.8e9
    parameters a rank, 53 GB, and with the activations the cell still does
    not fit."""
    from repro_torch.distributed.sharded_step import RankComm, data_group_axes
    from repro_torch.distributed.sharding import spec_leaves
    from repro_torch.tree import tree_leaves

    cfg = treg.get_config("yi-34b")
    mesh = dryrun.PRODUCTION_MESHES[False]
    c = dryrun.cell_setup(cfg, SHAPES["train_4k"], mesh)
    comm = RankComm(mesh, spec_leaves(c["specs"]["params"]),
                    [p.shape for p in tree_leaves(c["state"]["params"])],
                    data_group_axes(c["bsh"]), coordinate=(0, 0))
    model_local = sum(math.prod(sh) for sh in comm.model_shapes)
    assert cfg.param_count() / 16 < model_local < cfg.param_count() / 3
    rec = dryrun.dryrun_cell(cfg, SHAPES["train_4k"], mesh)
    assert rec["status"] == "ok" and rec["fits"] is False
    assert rec["roofline"]["hbm_gb_per_chip"] * 2**30 >= model_local * 6


def test_meta_count_equals_the_count_on_cpu_tensors():
    cfg = treg.reduced_config("internlm2-1.8b")
    spec = ShapeSpec("x", "prefill", 64, 2)
    rec = dryrun.dryrun_cell(cfg, spec, MeshShape((1, 1), ("data", "model")))
    # the weights' gather runs over groups of one: it moves nothing between ranks
    assert rec["collectives"]["ici_bytes_per_chip"] == 0
    gathered = rec["collectives"]["result_bytes"].get("all-gather", 0.0)
    model = tzoo.init_model(cfg, seed=0, device="cpu").to(torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))).int()
    with OpCounter() as c:
        tzoo.make_prefill_fn(cfg, device="cpu")(model, {"tokens": toks})
    assert c.cost.flops == rec["flops_per_chip"]
    # a gather over a group of one reads and writes its result once each
    assert c.cost.bytes + 2 * gathered == rec["bytes_per_chip"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_meta_train_count_equals_the_sharded_step_on_a_group_of_one(arch):
    """The dry run counts ``sharded_train_step``'s own body: its count on
    meta equals the real step's on one gloo rank, to 1e-9 relative, once the
    step's gather and finiteness check (counted apart) are replaced by the
    gather's record, which on a group of one reads and writes its result."""
    seq, rows, n = 64, 4, 2
    got = spawn(ranks.counted_step, 1, device="cpu", backend="gloo",
                args=(arch, seq, rows, n))[0]
    rec = dryrun.dryrun_cell(treg.reduced_config(arch), ShapeSpec("x", "train", seq, rows),
                             MeshShape((1, 1), ("data", "model")), num_microbatches=n)
    assert rec["num_microbatches"] == n and math.isfinite(got["loss"])
    gathered = rec["collectives"]["result_bytes"]["all-gather"]
    assert gathered > 0 and got["apart_bytes"] > 0
    flops = got["flops"] - got["apart_flops"]
    nbytes = got["bytes"] - got["apart_bytes"] + 2 * gathered
    assert flops == pytest.approx(rec["flops_per_chip"], rel=TRAIN_COUNT_RTOL)
    assert nbytes == pytest.approx(rec["bytes_per_chip"], rel=TRAIN_COUNT_RTOL)


def test_importing_the_dry_run_sets_no_environment_variable():
    code = ("import os; before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.perf.coll_breakdown\n"
            "print(before == dict(os.environ))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.stdout.strip() == "True", proc.stderr
