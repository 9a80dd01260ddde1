"""Tensor parallelism over the model axis against JAX's partitioned program,
on a (2, 2) (data, model) mesh of 4 gloo ranks on the CPU.

JAX's side runs once, in a subprocess with 4 forced host devices (as
``tests/test_torch_distributed_lm.py`` runs it): ``jax.jit`` of
``make_prefill_fn`` / ``make_decode_fn`` / ``make_train_step`` with the
rules' ``in_shardings``, GSPMD partitioning the compute.  The port's side
once, in one group of 4 ranks (``tests/torch_tp_ranks.py::tp_ranks``): the
sharded prefill, decode and train step, every layer computing its model
shard.  Reduced configs of every family in float32 (and a config whose KV
heads do not divide the model axis, and one whose query heads do not), JAX
``init_model``'s weights.  Tolerances:

* (a) the sharded prefill's logits, gathered whole, within
  ``LOGITS_F32_TOL`` (1e-4, ``tests/test_torch_models.py:48``) of the
  largest |logit| of JAX's pjit prefill and of the port's unsharded one;
* (b) the sharded decode, 12 steps from position 0 over a cache of 16,
  within ``DECODE_TOL`` (3e-4) of JAX's pjit decode: the cache's KV heads on
  the model axis, and its sequence there (KV = 1: two windows of 8, the
  heads gathered before the combine); RWKV's and Mamba's states by heads;
* (c) each rank's matmul flops (``perf.op_cost``) against the per-device dot
  flops of JAX's compiled partitioned HLO within ``MATMUL_REL_TOL`` (1%),
  for one forward per config and the granite-moe train step, once the dots
  where GSPMD's partitioning and the port's differ are named and counted
  (``_departures``);
* (d) the vocabulary-parallel loss on each rank's shard of the logits: its
  value within 1e-6 of ``cross_entropy_loss`` of the whole logits and its
  gradient the slice of the whole gradient (labels of -100, a row with
  none, the padded vocabulary's logits at -1e9);
* rank 0's traced collectives of every case's prefill and decode step
  equal the calls the dry run's rank records on ``meta``
  (``rank_collectives``);
* the dry run's rank (``launch.dryrun`` on ``meta``, a (2, 2) ``MeshShape``)
  counts each rank's prefill op for op: flops equal (the weights' gather
  counted apart), for the configs that run no scan (on the CPU the scans
  are their plain loops, on ``meta`` the kernels' custom ops).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from repro.configs import registry as jreg
from repro.models import transformer as jtr
from repro_torch.convert import lm_params_from_numpy
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.spawn import spawn
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parent)
LOGITS_F32_TOL = 1e-4  # tests/test_torch_models.py:48
DECODE_TOL = 3e-4  # tests/test_distributed.py:115
MATMUL_REL_TOL = 0.01  # tests/test_torch_op_cost.py
LOSS_TOL = 1e-6
RANKS_TIMEOUT = 600.0  # seconds; the group takes ~30 s
NAMES = tuple(c[0] for c in ranks.PREFILL_CASES)

JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
sys.path.insert(0, sys.argv[3])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry as jreg
from repro.distributed.sharding import (batch_shardings, decode_state_shardings,
                                        param_shardings, train_state_shardings)
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.optim.adamw import AdamW, init_adamw_state
from test_torch_op_cost import _jax_dot_flops
assert jax.device_count() == 4
jtr.grad_fence_bf16 = lambda x: x
inp = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {"prefill": {}, "decode": {}}
for name, (arch, ov) in inp["cases"].items():
    cfg = jreg.reduced_config(arch, dtype=jnp.float32, **ov)
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"][name])
    batch = {k: jnp.asarray(v) for k, v in inp["batches"][name].items()}
    psh = param_shardings(params, cfg, mesh, fsdp=False)
    bsh = batch_shardings(batch, cfg, mesh)
    with mesh:
        f = jax.jit(jzoo.make_prefill_fn(cfg), in_shardings=(psh, bsh))
        hlo = f.lower(params, batch).compile().as_text()
        logits = np.asarray(f(params, batch))
    out["prefill"][name] = {"logits": logits, "flops": _jax_dot_flops(hlo)}
    if name not in inp["decode_cases"]:
        continue
    state = jtr.init_decode_state(cfg, inp["batch"], inp["cache"], cache_dtype=jnp.float32)
    ssh = decode_state_shardings(jax.eval_shape(lambda: state), cfg, mesh)
    tsh = batch_shardings({"tokens": jnp.zeros((inp["batch"],), jnp.int32)}, cfg,
                          mesh)["tokens"]
    steps = []
    with mesh:
        f = jax.jit(jzoo.make_decode_fn(cfg), in_shardings=(psh, tsh, ssh),
                    out_shardings=(None, ssh))
        for tok in inp["decode_tokens"]:
            lg, state = f(params, jnp.asarray(tok), state)
            steps.append(np.asarray(lg))
            state = jax.tree_util.tree_map(np.asarray, state)
    out["decode"][name] = np.stack(steps)
cfg = jreg.reduced_config("granite-moe-1b-a400m", dtype=jnp.float32)
params = jax.tree_util.tree_map(jnp.asarray, inp["params"]["granite-moe"])
state = init_adamw_state(params)
batch = {k: jnp.asarray(v) for k, v in inp["train_batch"].items()}
ssh = train_state_shardings(jax.eval_shape(lambda: state), cfg, mesh)
bsh = batch_shardings(jax.eval_shape(lambda: batch), cfg, mesh)
with mesh:
    f = jax.jit(jzoo.make_train_step(cfg, AdamW()), in_shardings=(ssh, bsh),
                out_shardings=(ssh, None))
    out["train_flops"] = _jax_dot_flops(f.lower(state, batch).compile().as_text())
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _batch(cfg, rng) -> dict:
    b, s = ranks.BATCH, ranks.SEQ
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.is_encoder_decoder:
        batch["tokens"] = batch["tokens"][:, :cfg.max_target_len]
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _inputs() -> dict:
    rng = np.random.default_rng(29)
    cases, params, batches = {}, {}, {}
    for name, arch, ov in ranks.PREFILL_CASES:
        jcfg = jreg.reduced_config(arch, dtype=jnp.float32, **ov)
        cases[name] = (arch, ov)
        params[name] = jax.tree_util.tree_map(np.asarray,
                                              jtr.init_model(jcfg, jax.random.PRNGKey(0)))
        batches[name] = _batch(jcfg, rng)
    logits = rng.standard_normal((3, 5, 512)).astype(np.float32) * 3.0
    logits[..., 500:] -= 1e9  # the padded vocabulary, as the head masks it
    labels = rng.integers(0, 500, (3, 5)).astype(np.int64)
    labels[0, :2] = -100
    labels[2, :] = -100  # a row with no label
    train = {k: rng.integers(0, 512, (ranks.TRAIN_ROWS, ranks.SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    train["labels"][1, :4] = -100
    return {"cases": cases, "params": params, "batches": batches,
            "decode_cases": ranks.DECODE_CASES, "batch": ranks.BATCH,
            "cache": ranks.DECODE_CACHE,
            "decode_tokens": rng.integers(0, 512, (ranks.DECODE_STEPS, ranks.BATCH)).astype(
                np.int32),
            "loss_logits": logits, "loss_labels": labels, "train_batch": train}


def _port_unsharded(inp: dict) -> dict:
    out = {}
    for name, _, _ in ranks.PREFILL_CASES:
        cfg = ranks.case_config(name)
        model = lm_params_from_numpy(cfg, inp["params"][name], device="cpu")
        with torch.no_grad():
            out[name] = ttr.forward(model, cfg, inp["batches"][name])[:, -1].numpy()
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inp = _inputs()
    (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "in.pkl"),
         str(tmp / "jax.pkl"), TESTS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "grad_fence_bf16", lambda x: x)
        unsharded = _port_unsharded(inp)
    workdir = tmp / "ranks"
    workdir.mkdir()
    port = spawn(ranks.tp_ranks, 4, device="cpu", backend="gloo", args=(inp, str(workdir)),
                 timeout=RANKS_TIMEOUT)
    stdout, stderr = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    return {"in": inp, "jax": pickle.loads((tmp / "jax.pkl").read_bytes()), "port": port,
            "unsharded": unsharded}


def _close_scaled(got, want, tol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    live = want > -1e8  # the padded vocabulary is at -1e9 on every side
    scale = float(np.abs(want[live]).max())
    assert float(np.abs(got - want)[live].max()) <= tol * scale, \
        (float(np.abs(got - want)[live].max()), scale)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_matches_jax_pjit_and_the_unsharded_port(sides, name):
    want = sides["jax"]["prefill"][name]["logits"]
    cfg = ranks.case_config(name)
    v_local = cfg.padded_vocab // ranks.MESH[1]
    for r in sides["port"]:
        got = r["prefill"][name]
        _close_scaled(got["whole"], want, LOGITS_F32_TOL)
        _close_scaled(got["whole"], sides["unsharded"][name], LOGITS_F32_TOL)
        d, m = r["coord"]
        rows = ranks.BATCH // ranks.MESH[0]
        np.testing.assert_array_equal(  # the rank's own shard: its rows, its vocabulary
            got["local"], got["whole"][d * rows:(d + 1) * rows, m * v_local:(m + 1) * v_local])


@pytest.mark.parametrize("name", ranks.DECODE_CASES)
def test_sharded_decode_matches_jax_pjit(sides, name):
    want = sides["jax"]["decode"][name]
    for r in sides["port"]:
        got = r["decode"][name]
        assert got["logits"].shape == want.shape == (ranks.DECODE_STEPS, ranks.BATCH, 512)
        for step in range(ranks.DECODE_STEPS):
            _close_scaled(got["logits"][step], want[step], DECODE_TOL)
    windows = sides["port"][0]["decode"][name]["windows"]
    assert windows == (["k", "v"] if name == "internlm2-kv1" else [])


def _attention_products(cfg, rows: int, s: int, s_kv: int) -> float:
    """Flops of one attention's score and value products over ``rows`` rows."""
    return 2 * 2.0 * rows * cfg.num_heads * s * s_kv * cfg.head_dim


def _one_hot_einsums(cfg, rows: int, s: int) -> float:
    """Flops of one of JAX's MoE one-hot einsums ("gtke,gtkc,gtk->gtec") over
    ``rows`` rows, every layer: the port scatters them (no product)."""
    cap = min(max(1, int(cfg.capacity_factor * cfg.top_k * s / cfg.num_experts)), s)
    return cfg.num_layers * 2.0 * rows * s * cfg.top_k * cfg.num_experts * cap


def _departures(name: str) -> float:
    """Per device, JAX's prefill dot flops minus the port's rank's, where the
    two programs differ at these shapes, named (the rest is held to 1%):

    * MoE: JAX builds dispatch and combine with one-hot einsums, which GSPMD
      divides over the 4 devices; the port scatters them (no product);
    * RWKV-6, Mamba2: GSPMD runs the scan's steps (dots in JAX) on every head
      of the device's rows; the port's plain scan (the kernel's CPU version)
      on the rank's heads, as ``head_shard`` pins them;
    * zamba2: JAX's count reaches no branch of ``lax.cond``, so its hybrid's
      shared block (attention and SwiGLU, on the rank's heads and hidden
      width in the port) is the port's alone;
    * internvl2: JAX's head runs over the prefix positions too (it slices
      them off the logits after the head; the port before it).
    """
    cfg = ranks.case_config(name)
    dp, mp = ranks.MESH
    b, s = ranks.BATCH, ranks.SEQ
    out = 0.0
    if cfg.is_moe:
        out += 2 * _one_hot_einsums(cfg, b, s) / (dp * mp)
    if cfg.rwkv or cfg.family == "hybrid":
        heads = cfg.d_model // 64 if cfg.rwkv else 2 * cfg.d_model // 64
        steps = cfg.num_layers * s * 2.0 * b * heads * 64 * (64 if cfg.rwkv else cfg.ssm_state)
        out += steps / dp - steps / (dp * mp)
    if cfg.family == "hybrid":
        rows = b // dp
        t = rows * s
        per_use = (2 * 2.0 * t * cfg.d_model * cfg.num_heads * cfg.head_dim / mp  # q, o
                   + 2 * 2.0 * t * cfg.d_model * cfg.num_kv_heads * cfg.head_dim / mp  # k, v
                   + _attention_products(cfg, rows, s, s) / mp
                   + 3 * 2.0 * t * cfg.d_model * cfg.d_ff / mp)
        out -= cfg.num_layers // cfg.shared_attn_every * per_use
    if cfg.frontend == "vision_stub":
        out += 2.0 * (b // dp) * cfg.num_prefix_embeds * cfg.d_model * cfg.padded_vocab / mp
    return out


@pytest.mark.parametrize("name", NAMES)
def test_rank_matmul_flops_match_jax_partitioned_dots(sides, name):
    want = sides["jax"]["prefill"][name]["flops"]
    named = _departures(name)
    for r in sides["port"]:
        got = r["prefill"][name]["flops"]
        assert abs(got + named - want) <= MATMUL_REL_TOL * want, (got, named, want)


def test_train_step_matmul_flops_match_jax_partitioned_dots(sides):
    """Named: GSPMD computes the step's causal attention products on every
    row of the batch (replicated over data; forward, remat's recompute and
    the backward's four products), and JAX's one-hot einsums (forward,
    recompute, and the combine's gradient)."""
    want = sides["jax"]["train_flops"]
    cfg = ranks.case_config("granite-moe")
    dp, mp = ranks.MESH
    rows, s = ranks.TRAIN_ROWS, ranks.SEQ
    attn = cfg.num_layers * _attention_products(cfg, rows, s, s) / mp
    named = 4 * (attn - attn / dp) + 5 * _one_hot_einsums(cfg, rows, s) / (dp * mp)
    for r in sides["port"]:
        got = r["train"]["flops"]
        assert abs(got + named - want) <= MATMUL_REL_TOL * want, (got, named, want)


def test_vocab_parallel_loss_matches_cross_entropy(sides):
    inp = sides["in"]
    logits = torch.from_numpy(inp["loss_logits"]).requires_grad_()
    want = ttr.cross_entropy_loss(logits, torch.from_numpy(inp["loss_labels"]))
    want.backward()
    v_local = logits.shape[-1] // ranks.MESH[1]
    for r in sides["port"]:
        got = r["loss"]
        assert abs(got["loss"] - float(want)) <= LOSS_TOL * abs(float(want))
        i = got["index"]
        np.testing.assert_allclose(got["grad"], logits.grad[..., i * v_local:(i + 1) * v_local],
                                   rtol=1e-5, atol=1e-7)
    assert float(want) > 0 and (inp["loss_labels"][2] < 0).all()


def _calls(records) -> list:
    return sorted((r["kind"], tuple(r["axes"]), r["group"], r["result_bytes"]) for r in records)


@pytest.mark.parametrize("kind,name", [("prefill", n) for n in NAMES]
                         + [("decode", n) for n in ranks.DECODE_CASES])
def test_traced_serving_collectives_equal_the_meta_runs(sides, kind, name):
    """Rank 0's traced calls, call for call, are those the dry run's rank
    records on ``meta`` for the same config, weights' dtype, batch and
    mesh: the one source of a cell's collectives holds for every family."""
    traced, meta = sides["port"][0]["traced"][kind, name]
    assert _calls(traced) == _calls(meta)
    assert any(r["axes"] == ("model",) for r in meta)
    if name == "internlm2-kv1":  # a sequence-sharded cache gathers the heads
        assert any(r["kind"] == "all-gather" for r in meta) == (kind == "decode")


@pytest.mark.parametrize("name", ["internlm2", "internlm2-kv1", "internlm2-h3", "granite-moe"])
def test_dry_run_rank_counts_the_ranks_prefill(sides, name):
    """The configs whose batch is ``input_specs``' (whisper's and internvl2's
    are not) and that run no scan."""
    cfg = ranks.case_config(name)
    spec = ShapeSpec("x", "prefill", ranks.SEQ, ranks.BATCH)
    batch = sides["in"]["batches"][name]
    assert {k: v.shape for k, v in tzoo.input_specs(cfg, spec).items()} == \
        {k: v.shape for k, v in batch.items()}
    meta = dryrun.dryrun_cell(cfg, spec, MeshShape(ranks.MESH, ("data", "model")))
    assert meta["status"] == "ok" and "model-axis shard" in meta["port_path"]
    for r in sides["port"]:
        assert r["prefill"][name]["count"] == meta["flops_per_chip"]


def test_spawn_stops_ranks_that_hang_in_a_collective():
    """A collective one rank calls and the others never do hangs: ``spawn``'s
    time limit stops the ranks and raises."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(ranks.hanging_ranks, 2, device="cpu", backend="gloo", timeout=15.0)
    assert time.monotonic() - t0 < 60


def test_compressed_step_sums_whole_gradients_and_gathers_the_model_shards():
    """With the optimiser's compressor every gradient takes the data group's
    ``all_reduce`` (no ``reduce_scatter``): one call over the model-local
    float32 gradients and the loss; each model-sharded leaf is then gathered
    whole over ``model``.  The calls a rank's run on ``meta`` records."""
    import collections

    from repro_torch.distributed.sharding import P, spec_leaves, train_state_shardings
    from repro_torch.optim import AdamW, Int8ErrorFeedback
    from repro_torch.tree import tree_leaves

    cfg = ranks.case_config("granite-moe")
    mesh = MeshShape(ranks.MESH, ("data", "model"))
    c = dryrun.cell_setup(cfg, ShapeSpec("x", "train", ranks.SEQ, ranks.TRAIN_ROWS), mesh,
                          num_microbatches=1)
    opt = AdamW(compressor=Int8ErrorFeedback())
    c["state"] = opt.compressor.init_state(c["state"])
    c["specs"] = train_state_shardings(c["state"], cfg, mesh)
    calls = dryrun.rank_collectives(cfg, "train", c, mesh, optimizer=opt)
    leaves = tree_leaves(c["state"]["params"])
    on_model = ["model" in P(*sp).axes() for sp in spec_leaves(c["specs"]["params"])]
    assert any(on_model) and not all(on_model)
    local = sum(p.numel() // (ranks.MESH[1] if m else 1) for p, m in zip(leaves, on_model))
    data = [(r["kind"], r["result_bytes"]) for r in calls if r["axes"] == ("data",)]
    assert [kind for kind, _ in data] == ["all-gather", "all-reduce"]
    assert data[1][1] == 4.0 * (local + 1)
    gathered = collections.Counter(r["result_bytes"] for r in calls
                                   if r["kind"] == "all-gather" and r["axes"] == ("model",))
    whole = collections.Counter(4.0 * p.numel() for p, m in zip(leaves, on_model) if m)
    assert not whole - gathered


@pytest.mark.parametrize("heads,kv,want", [
    (6, 3, {0: [0, 0, 1], 1: [1, 2, 2]}),  # neither whole groups nor part of one
    (4, 1, {0: [0], 1: [0]}),  # part of one group: one KV head
    (8, 2, {0: [0], 1: [1]})])  # whole groups (KV divides the axis: the rank's own)
def test_kv_for_heads_takes_the_kv_heads_of_the_ranks_queries(heads, kv, want):
    """Query head i of the rank's ``[r·H/tp, (r+1)·H/tp)`` reads KV head
    ``i // (H/KV)``: the KV heads the rank takes, with the flash kernel's
    ``h % kv == 0``."""
    import dataclasses

    from repro_torch.distributed import tensor_parallel as tp

    cfg = dataclasses.replace(ranks.case_config("internlm2"), num_heads=heads, num_kv_heads=kv)
    for r, idx in want.items():
        k = torch.arange(float(kv)).view(1, 1, kv, 1)
        if kv % 2 == 0:  # sharded on the axis: the rank holds its own KV heads already
            k = k[:, :, r * kv // 2:(r + 1) * kv // 2]
        with tp.scope(tp.ModelAxis(2, r, None, records=[])):
            got = tp.kv_for_heads(k, heads // 2, cfg)
        assert got[0, 0, :, 0].tolist() == [float(i) for i in idx]
        assert (heads // 2) % got.shape[2] == 0
