"""The port's sharded LM paths against the JAX package's, on 4 gloo ranks on the CPU.

JAX's side runs once, in a subprocess with 4 forced host devices (as
``tests/test_distributed.py`` runs its cases); the port's side once, in one
group of 4 ranks (``tests/torch_dist_ranks.py::lm_ranks``), which the
tests below read.  Inputs are drawn with numpy from a seed; the weights are
JAX ``init_model``'s.  Tolerances:

* local slices: each rank's slice of a placed tensor is the slice JAX's
  ``NamedSharding.devices_indices_map`` gives the device at the same mesh
  coordinate (equal);
* the sharded train step on (2, 2) (reduced granite-moe, float32, the bf16
  cotangent fence out of both sides as in ``test_torch_train.py``, labels
  of -100 planted, one microbatch row holding none; 1 and 2 microbatches,
  and 2 under "dp_only"): every leaf of the state after 2 AdamW steps
  within 1e-4 in norm of JAX's pjit step on a (2, 2) mesh and of the
  port's unsharded ``make_train_step``, and the metrics within 1e-4
  (``test_torch_train.py``'s float32 step tolerance); 2 SGD steps, and one
  AdamW step with the int8 compressor (held as ``test_torch_train.py``
  holds it), against both as well;
* the elastic restore onto (4, 1), (1, 4) and (2, 2): equal, for the port's
  checkpoint and for one JAX wrote from its sharded state;
* ``train(state_shardings=)``: its losses, over a save, a new run and a
  resume, within 1e-4 of JAX's ``train(state_shardings=)`` on the same
  mesh and of the port's unsharded loop (``test_torch_train_loop.py``);
* the sharded decode, 12 steps on 4 windows of 4, positions crossing two
  window edges: 3e-4 against JAX's (``tests/test_distributed.py:115``);
* ``compressed_psum``: within 5% of the exact sum (JAX's ``:141``) and
  within float32 rounding (1e-6) of JAX's own result;
* ``ring_allgather_matmul``: within 2e-4 of JAX's (``:159``).
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

import torch_dist_ranks as ranks
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.distributed import spawn
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW
from repro_torch.runtime.train_loop import TrainLoopConfig, train

SRC = str(Path(__file__).resolve().parents[1] / "src")
STEP_TOL = 1e-4
LOSS_TOL = 1e-4
DECODE_TOL = 3e-4
PSUM_TOL = 5e-2
RING_TOL = 2e-4
INT8_FLIPS = 1e-3  # test_torch_train.py
EF_TOL = 1e-2  # test_torch_train.py
SLICE_CASES = [((8, 6), ("data", "model")), ((8, 6), (("data", "model"), None)),
               ((8, 6), ("model", "data")), ((4, 6, 2), (None, "data", None)),
               ((8,), ("model",)), ((6, 4), (None, None))]
RUNS = tuple(run[0] for run in ranks.LM_RUNS)

JAX_SIDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as JP
from repro.configs import registry as jreg
from repro.distributed.collectives import compressed_psum, ring_allgather_matmul
from repro.distributed.decode import sharded_decode_attention
from repro.distributed.layout import layout_scope
from repro.distributed.sharding import batch_shardings, train_state_shardings
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.data.lm_data import SyntheticLMStream
from repro.optim.adamw import AdamW, init_adamw_state
from repro.optim.grad_compress import Int8ErrorFeedback
from repro.runtime.checkpoint import save_checkpoint
from repro.runtime.train_loop import TrainLoopConfig, train
assert jax.device_count() == 4
jtr.grad_fence_bf16 = lambda x: x
inp = pickle.load(open(sys.argv[1], "rb"))
out = {"slices": [], "runs": {}}
mesh = jax.make_mesh((2, 2), ("data", "model"))
for shape, spec in inp["slice_cases"]:
    idx = NamedSharding(mesh, JP(*spec)).devices_indices_map(tuple(shape))
    out["slices"].append({(i, j): tuple(slice(*s.indices(n)[:2]) for s, n in
                                        zip(idx[mesh.devices[i, j]], shape))
                          for i in range(2) for j in range(2)})
cfg = jreg.reduced_config("granite-moe-1b-a400m", dtype=jnp.float32, **inp["lm_tiny"])
params = jax.tree_util.tree_map(jnp.asarray, inp["params"])


def run_state(label):  # tests/torch_dist_ranks.py::lm_run_state
    if label.startswith("sgd"):
        return None, {"params": params, "lr": jnp.asarray(0.05, jnp.float32)}
    if label.startswith("int8ef"):
        opt = AdamW(compressor=Int8ErrorFeedback())
        return opt, opt.compressor.init_state(init_adamw_state(params, lr=1e-2))
    return AdamW(), init_adamw_state(params, lr=1e-2)


for label, mb, layout, key in inp["runs"]:
    with layout_scope(layout):
        batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in inp[key]]
        opt, state = run_state(label)
        ssh = train_state_shardings(jax.eval_shape(lambda: state), cfg, mesh)
        bsh = batch_shardings(jax.eval_shape(lambda: batches[0]), cfg, mesh)
        step = jzoo.make_train_step(cfg, opt, num_microbatches=mb)
        metrics = []
        with mesh:
            f = jax.jit(step, in_shardings=(ssh, bsh), out_shardings=(ssh, None))
            for b in batches:
                # numpy between steps: under jax 0.9's Explicit mesh axes, a second
                # call with the first's sharded outputs fails to trace the embedding
                # gather (ShardingTypeError); the values are the same
                state, m = f(jax.tree_util.tree_map(np.asarray, state), b)
                metrics.append({k: float(v) for k, v in m.items()})
    out["runs"][label] = {"metrics": metrics, "state": jax.tree_util.tree_map(np.asarray, state)}
    if label == "mb2":
        save_checkpoint(inp["jax_ckpt"], 2, state, extra_metadata={"from": "jax 2x2"})
lcfg = jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32, **inp["loop_tiny"])
lparams = jax.tree_util.tree_map(jnp.asarray, inp["loop_params"])
lstate = init_adamw_state(lparams)
# Auto axes: the loop feeds the jitted step its own sharded outputs, which
# Explicit axes refuse (see above), and its retries then replay for ever
amesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
lssh = train_state_shardings(jax.eval_shape(lambda: lstate), lcfg, amesh)
hist, resumed = [], []
for total in (4, 6):  # a save, a new run and a resume onto the shardings
    loop = TrainLoopConfig(total_steps=total, log_every=1, save_every=2, lr=1e-2,
                           num_microbatches=2, checkpoint_dir=inp["jax_loop_dir"])
    with amesh:
        res = train(lcfg, loop, stream=SyntheticLMStream(lcfg.vocab_size, 16, 4, seed=1),
                    optimizer=AdamW(), init_params_fn=lambda: lparams, state_shardings=lssh)
    hist += res["history"]
    resumed.append(res["resumed_from"])
out["loop"] = {"history": hist, "resumed": resumed,
               "sharded": res["state"]["m"]["final_ln"].sharding.spec}
dcfg = jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32, **inp["decode_tiny"])
mesh4 = jax.make_mesh((4,), ("model",))
aparams = {k: jnp.asarray(v) for k, v in inp["attn_params"].items()}
b = inp["decode_x"].shape[1]
ks = jnp.zeros((b, inp["decode_smax"], dcfg.num_kv_heads, dcfg.head_dim), jnp.float32)
vs = ks
pos = jnp.asarray(inp["decode_pos"])
outs = []
decode = jax.jit(lambda x, k, v, p: sharded_decode_attention(aparams, dcfg, mesh4, x, k, v, p))
for x in inp["decode_x"]:
    o, ks, vs = decode(jnp.asarray(x), ks, vs, pos)
    outs.append(np.asarray(o))
    pos = pos + 1
out["decode"] = {"out": np.stack(outs), "k": np.asarray(ks), "v": np.asarray(vs)}
mesh_d = jax.make_mesh((4,), ("data",))
x = jnp.asarray(inp["psum_x"])
out["psum"] = np.asarray(shard_map(lambda a: compressed_psum(a, "data"), mesh=mesh_d,
                                   in_specs=JP("data", None), out_specs=JP("data", None))(x))
out["psum_exact"] = np.asarray(shard_map(lambda a: jax.lax.psum(a, "data"), mesh=mesh_d,
                                         in_specs=JP("data", None),
                                         out_specs=JP("data", None))(x))
out["ring"] = np.asarray(shard_map(
    lambda a, w: ring_allgather_matmul(a, w, "model", 4), mesh=mesh4,
    in_specs=(JP(None, None), JP(None, "model")), out_specs=JP(None, None),
    check_rep=False)(jnp.asarray(inp["ring_x"]), jnp.asarray(inp["ring_w"])))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _batches(rng, n: int, b: int, s: int = 16, vocab: int = 64) -> list[dict]:
    out = []
    for _ in range(n):
        tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
        labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
        labels[0, :5] = -100
        labels[b - 1, :] = -100  # one rank's row of the last microbatch holds no label
        out.append({"tokens": tokens, "labels": labels})
    return out


def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)
    jcfg = jreg.reduced_config("granite-moe-1b-a400m", dtype=jnp.float32, **ranks.LM_TINY)
    dcfg = jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32, **ranks.DECODE_TINY)
    lcfg = jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32, **ranks.LOOP_TINY)
    return {
        "slice_cases": SLICE_CASES,
        "lm_tiny": ranks.LM_TINY,
        "decode_tiny": ranks.DECODE_TINY,
        "params": jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0))),
        "batches": _batches(rng, 2, 4),
        "batches8": _batches(rng, 2, 8),
        "batches1": _batches(rng, 1, 4),
        "runs": list(ranks.LM_RUNS),
        "jax_ckpt": str(tmp / "jax_ckpt"),
        "loop_tiny": ranks.LOOP_TINY,
        "loop_params": jax.tree_util.tree_map(np.asarray, jtr.init_model(lcfg,
                                                                           jax.random.PRNGKey(0))),
        "jax_loop_dir": str(tmp / "jax_loop"),
        "attn_params": {k: np.asarray(v) for k, v in
                        jattn.init_attention(jax.random.PRNGKey(0), dcfg).items()},
        "decode_x": rng.standard_normal((12, 2, 1, dcfg.d_model)).astype(np.float32),
        "decode_pos": np.array([0, 3], np.int32),  # the windows' edges at 4 and 8
        "decode_smax": 16,
        "psum_x": rng.standard_normal((4, 64)).astype(np.float32),
        "ring_x": rng.standard_normal((16, 32)).astype(np.float32),
        "ring_w": rng.standard_normal((32, 64)).astype(np.float32),
    }


def _port_unsharded(inp: dict) -> dict:
    """The port's unsharded step on the same inputs, and its unsharded loop."""
    cfg = treg.reduced_config("granite-moe-1b-a400m", dtype=torch.float32, **ranks.LM_TINY)
    out = {}
    for label, mb, _, key in ranks.LM_RUNS:
        opt, state = ranks.lm_run_state(label, lm_params_from_numpy(cfg, inp["params"],
                                                                    device="cpu"))
        step = tzoo.make_train_step(cfg, opt, num_microbatches=mb, device="cpu")
        metrics = []
        for batch in inp[key]:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[label] = {"metrics": metrics, "state": tree_to_numpy(state)}
    dcfg = treg.reduced_config("internlm2-1.8b", dtype=torch.float32, **ranks.DECODE_TINY)
    aparams = {k: torch.from_numpy(np.array(v)) for k, v in inp["attn_params"].items()}
    k = torch.zeros((2, inp["decode_smax"], dcfg.num_kv_heads, dcfg.head_dim))
    v = torch.zeros_like(k)
    pos = torch.from_numpy(inp["decode_pos"]).long()
    outs = []
    for x in inp["decode_x"]:
        o, k, v = tattn.decode_attention(aparams, dcfg, torch.from_numpy(x), k, v, pos)
        outs.append(o.numpy())
        pos = pos + 1
    out["decode"] = np.stack(outs)
    lcfg = treg.reduced_config("internlm2-1.8b", dtype=torch.float32, **ranks.LOOP_TINY)
    loop = TrainLoopConfig(total_steps=6, log_every=1, save_every=100, lr=1e-2,
                           num_microbatches=2, checkpoint_dir=str(inp["loop_dir"]))
    out["loop"] = train(lcfg, loop, stream=SyntheticLMStream(lcfg.vocab_size, 16, 4, seed=1),
                        optimizer=AdamW(), init_params_fn=lambda: lm_params_from_numpy(
                            lcfg, inp["loop_params"], device="cpu"), device="cpu")["history"]
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_lm")
    inp = _inputs(tmp)
    inp["loop_dir"] = tmp / "unsharded_loop"
    (tmp / "in.pkl").write_bytes(pickle.dumps({k: v for k, v in inp.items() if k != "loop_dir"}))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "in.pkl"),
         str(tmp / "jax.pkl")], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "grad_fence_bf16", lambda x: x)  # out, as on the other sides
        unsharded = _port_unsharded(inp)
    stdout, stderr = jax_proc.communicate(timeout=400)
    assert jax_proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr[-4000:]}"
    jax_out = pickle.loads((tmp / "jax.pkl").read_bytes())
    workdir = tmp / "ranks"
    workdir.mkdir()
    port = spawn(ranks.lm_ranks, 4, device="cpu", backend="gloo", args=(
        {k: v for k, v in inp.items() if k != "loop_dir"}, str(workdir)))
    return {"in": inp, "jax": jax_out, "port": port, "unsharded": unsharded}


def _close_tree(got, want, tol: float, flips: float = 0.0, where: str = "") -> None:
    """Each leaf within ``tol`` of ``want`` in norm: ``||got - want|| / ||want||``.
    With ``flips`` > 0, instead elementwise within ``tol`` of the leaf's
    largest magnitude on all but that share of its elements
    (``test_torch_train.py``'s rule for the int8 compressor)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close_tree(got[k], want[k], tol, flips, f"{where}/{k}")
        return
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert got.shape == want.shape, where
    if flips:
        off = np.abs(got - want) > tol * float(np.abs(want).max())
        assert off.mean() <= flips, (where, int(off.sum()), off.size)
    else:
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        assert rel <= tol, (where, rel)


def _equal_tree(got, want) -> None:
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_local_slices_match_jax_devices_indices_map(sides):
    full = {i: np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            for i, (shape, _) in enumerate(SLICE_CASES)}
    for rank in sides["port"]:
        for i, (local, round_trip) in enumerate(rank["slices"]):
            want = full[i][sides["jax"]["slices"][i][rank["coord"]]]
            np.testing.assert_array_equal(local, want, err_msg=str((SLICE_CASES[i], rank["coord"])))
            assert round_trip
    assert sorted(r["coord"] for r in sides["port"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("label", RUNS)
def test_sharded_train_step_matches_jax_pjit_and_the_unsharded_step(sides, label):
    got = sides["port"][0]["runs"][label]
    for other in ("jax", "unsharded"):
        want = sides[other]["runs"][label] if other == "jax" else sides[other][label]
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert set(gm) == set(wm)
            for key in wm:
                np.testing.assert_allclose(gm[key], wm[key], rtol=STEP_TOL, err_msg=(other, key))
        if label.startswith("int8ef"):  # int8 rounding flips, as test_torch_train.py holds them
            _close_tree(got["state"]["params"], want["state"]["params"], STEP_TOL, where=other)
            _close_tree({k: got["state"][k] for k in ("m", "v")},
                        {k: want["state"][k] for k in ("m", "v")}, STEP_TOL, INT8_FLIPS, other)
            _close_tree(got["state"]["ef_buffer"], want["state"]["ef_buffer"], EF_TOL,
                        INT8_FLIPS, other)
        else:
            _close_tree(got["state"], want["state"], STEP_TOL, where=other)
    for rank in sides["port"]:  # every rank saw the same metrics
        assert rank["runs"][label]["metrics"] == got["metrics"]
    if "step" in got["state"]:
        assert int(got["state"]["step"]) == len(sides["in"][dict(
            (run[0], run[3]) for run in ranks.LM_RUNS)[label]])


def test_sharded_step_refuses_zero1_moments(sides):
    assert "zero1" in sides["port"][0]["zero1_refused"]


@pytest.mark.parametrize("shape", [(4, 1), (1, 4), (2, 2)])
def test_elastic_restore_across_mesh_shapes(sides, shape):
    for rank in sides["port"]:
        port = rank["restores"][(shape, "port")]
        assert port["placed"] and port["equal"] and port["meta"] == {"from": "2x2"}
    assert sides["port"][0]["saved_on_disk"]


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_restore_of_a_jax_sharded_checkpoint(sides, shape):
    got = sides["port"][0]["restores"][(shape, "jax")]
    assert got["placed"] and got["meta"] == {"from": "jax 2x2"}
    _equal_tree(got["state"], sides["jax"]["runs"]["mb2"]["state"])


def test_train_resumes_under_state_shardings(sides):
    loop, want = sides["port"][0]["loop"], sides["jax"]["loop"]
    assert loop["resumed"] == want["resumed"] == [None, 4] and loop["sharded"] == "DTensor"
    assert [h["step"] for h in loop["history"]] == [h["step"] for h in want["history"]] \
        == list(range(1, 7))
    for ref in ([h["loss"] for h in want["history"]],
                [h["loss"] for h in sides["unsharded"]["loop"]]):
        np.testing.assert_allclose([h["loss"] for h in loop["history"]], ref, rtol=LOSS_TOL)


def test_sharded_decode_matches_jax_and_the_unsharded_decode(sides):
    want = sides["jax"]["decode"]
    s_local = sides["in"]["decode_smax"] // 4
    for rank in sides["port"]:
        for ref in (want["out"], sides["unsharded"]["decode"]):
            np.testing.assert_allclose(rank["decode"]["out"], ref, rtol=DECODE_TOL,
                                       atol=DECODE_TOL)
        r = rank["rank"]
        for key in ("k", "v"):
            np.testing.assert_allclose(rank["decode"][key],
                                       want[key][:, r * s_local:(r + 1) * s_local],
                                       rtol=DECODE_TOL, atol=DECODE_TOL)
    # row 0 ends at position 11: the last window never held one of its keys
    assert not np.any(sides["port"][3]["decode"]["k"][0])
    assert np.all(np.any(sides["port"][3]["decode"]["k"][1], axis=(1, 2)) == [1, 1, 1, 0])


def test_compressed_psum_matches_jax(sides):
    exact = sides["jax"]["psum_exact"]
    for rank in sides["port"]:
        r = rank["rank"]
        got = rank["psum"][0]
        assert np.abs(got - exact[r]).max() / np.abs(exact[r]).max() < PSUM_TOL
        np.testing.assert_allclose(got, sides["jax"]["psum"][r], rtol=1e-6, atol=1e-6)


def test_ring_allgather_matmul_matches_jax(sides):
    inp = sides["in"]
    dense = inp["ring_x"] @ inp["ring_w"]
    for rank in sides["port"]:
        np.testing.assert_allclose(rank["ring"], sides["jax"]["ring"], rtol=RING_TOL,
                                   atol=RING_TOL)
        np.testing.assert_allclose(rank["ring"], dense, rtol=RING_TOL, atol=RING_TOL)
