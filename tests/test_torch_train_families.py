"""Training the RWKV-6, hybrid (Mamba2), encoder-decoder and VLM families:
the port's train step against the JAX package's, on the CPU.

Each family at its ``reduced_config`` (rwkv6-3b 3 layers, zamba2-1.2b 4
with the shared block after layers 1 and 3, whisper-base 3 encoder and 3
decoder layers, internvl2-26b 3), weights from JAX ``init_model`` carried
over by ``repro_torch.convert``, batches from ``SyntheticLMStream`` with
``frames`` (whisper) and ``prefix_embeds`` (internvl2) drawn with numpy, as
JAX's ``input_specs`` gives them.  Attention runs the blocked path (the
flash plain version with its log-sum-exp, the recomputing backward), the
recurrences their plain loops, differentiated by autograd, as the CPU path
of ``kernels.recurrence.ops`` does.  Tolerances, as
``tests/test_torch_train.py`` holds the dense and MoE families:

* float32 AdamW train steps, 2 microbatches, 2 steps at lr 1e-3 (the bf16
  cotangent fence out of both sides): loss and gradient norm 1e-4
  relative; every parameter leaf and both moments 1e-4 in norm (measured:
  1.1e-5 at most).  Not lr 1e-2 as for the dense family: AdamW's first
  update moves each element by about lr whatever its gradient's size, so
  an element whose gradient is float32 noise in either framework moves by
  a full step, and the second step's gradients carry it (measured at 1e-2:
  2.5e-4 on internvl2's embedding, 1.2e-4 on zamba2's a_log moment).
  rwkv6-3b is held at 1e-3 (measured: 3.2e-4): its reduced config's
  gradients amplify the rounding of the WKV output about 150-fold (a
  relative perturbation of 1e-7 of it, one float32 rounding, moves the
  largest leaf's gradient by 1.5e-5, of 1e-6 by 2.1e-4), and the two
  frameworks' float32 scans round differently (their gradients of the scan
  itself agree within 2e-6 on this model's inputs).  No float32 scan can
  be held to 1e-4 here: the port's own CPU steps with the scans' step
  loops in float64 lie 1.7e-4-4.0e-3 from its float32 ones (3 such steps
  from ``init_model`` seeds 0-2, ``scripts/torch_family_step_gaps.py``);
* one bf16 SGD step (``cast_params_bf16``, bf16 compute, the fence in):
  the loss within 2e-2 relative and each parameter's update within 5e-2 in
  norm, as for the dense family, except where JAX's own bf16 update lies
  farther from its float32 one: rwkv6-3b 0.25 (measured: port to JAX
  0.205; JAX's bf16 to its float32 0.235) and zamba2-1.2b 0.1 (0.061 on
  a_log; JAX's own 0.060).  In every family the port's bf16 update is also
  held to JAX's float32 update: no farther than 1.25 times JAX's bf16
  update is (measured ratios 0.74-0.97);
* the three remat policies: gradients within 1e-6 of one another;
* checkpoints of every family's train state cross between the packages
  array-equal, ``shared_attn``, ``encoder`` and ``cross`` included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import init_adamw_state as jinit_adamw
from repro.runtime import checkpoint as jckpt
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy, tree_to_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW, init_adamw_state
from repro_torch.runtime import checkpoint as tckpt

FAMILIES = ["rwkv6-3b", "zamba2-1.2b", "whisper-base", "internvl2-26b"]
STEP_TOL = 1e-4
RWKV_STEP_TOL = 1e-3  # the module's docstring says why
BF16_LOSS_TOL = 2e-2
BF16_UPDATE_TOL = 5e-2
BF16_FAMILY_TOL = {"rwkv6-3b": 0.25, "zamba2-1.2b": 0.1}  # the module's docstring says why
BF16_TO_F32_RATIO = 1.25
ADAMW_LR = 1e-3  # the module's docstring says why not 1e-2
SEQ = 32
FRAMES = 40  # whisper's encoder length: not the decoder's
PREFIX = 8  # internvl2's patch embeddings before the text


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, as tests/test_torch_recurrence.py
    says why: the recurrences' plain step loops under autograd are many
    small operations, slow when each process of a parallel run spreads them
    over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch: str, dtype: str = "float32", **over):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    over = dict(attention_impl="blocked", **over)
    return jreg.reduced_config(arch, dtype=jdt, **over), treg.reduced_config(arch, dtype=tdt, **over)


def _batches(cfg, n: int, seed: int = 2, batch: int = 4) -> list[dict]:
    """n batches of the family's inputs: tokens and labels, and frames or
    patch embeddings, float32 numpy."""
    stream = SyntheticLMStream(cfg.vocab_size, SEQ, batch, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = next(stream)
        if cfg.is_encoder_decoder:
            b["frames"] = rng.standard_normal((batch, FRAMES, cfg.d_model)).astype(np.float32)
        if cfg.frontend == "vision_stub":
            b["prefix_embeds"] = rng.standard_normal((batch, PREFIX, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


def _close_tree(got, want, tol: float, where: str = "") -> None:
    """Each leaf within ``tol`` of ``want``: ||got - want|| / ||want||."""
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], tol, f"{where}/{k}")
        return
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    assert rel <= tol, (where, rel)


def _no_fence(monkeypatch) -> None:
    """The bf16 cotangent fence out of both sides (tests/test_torch_train.py
    says why; its own test holds it to JAX's)."""
    monkeypatch.setattr(jtr, "grad_fence_bf16", lambda x: x)
    monkeypatch.setattr(ttr, "grad_fence_bf16", lambda x: x)


@pytest.mark.parametrize("arch", FAMILIES)
def test_adamw_train_steps_match_jax(arch, monkeypatch):
    _no_fence(monkeypatch)
    jcfg, tcfg = _configs(arch)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(1)))
    jstate = jinit_adamw(params, lr=ADAMW_LR)
    tstate = train_state_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jstate),
                                    device="cpu")
    jstep = jax.jit(jzoo.make_train_step(jcfg, JAdamW(), num_microbatches=2))
    tstep = tzoo.make_train_step(tcfg, AdamW(), num_microbatches=2, device="cpu")
    tol = RWKV_STEP_TOL if tcfg.rwkv else STEP_TOL
    for batch in _batches(jcfg, 2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=tol, err_msg=key)
    _close_tree(tree_to_numpy(tstate), jax.tree_util.tree_map(np.asarray, jstate), tol)
    assert int(tstate["step"]) == 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_sgd_step_matches_jax(arch):
    """bf16 compute over float32 masters, the fence in: the update each
    parameter took, port against JAX."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(1)))
    batch = _batches(jcfg, 1, seed=4)[0]
    jstep = jax.jit(jzoo.make_train_step(jcfg, None, cast_params_bf16=True))
    jstate, jm = jstep({"params": params, "lr": jnp.asarray(0.05, jnp.float32)},
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tzoo.make_train_step(tcfg, None, cast_params_bf16=True, device="cpu")
    tstate, tm = tstep({"params": lm_params_from_numpy(tcfg, params, device="cpu"),
                        "lr": torch.tensor(0.05)}, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_LOSS_TOL)
    delta = lambda t: jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float32) - b,  # noqa: E731
                                             t, params)
    got = delta(tree_to_numpy(tstate["params"]))
    _close_tree(got, delta(jstate["params"]), BF16_FAMILY_TOL.get(arch, BF16_UPDATE_TOL))
    # Both sides' distance to JAX's float32 update: the port's bf16 step is
    # no farther from it than JAX's own bf16 step is.
    jcfg32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    f32, _ = jax.jit(jzoo.make_train_step(jcfg32, None, cast_params_bf16=True))(
        {"params": params, "lr": jnp.asarray(0.05, jnp.float32)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    want32 = jax.tree_util.tree_leaves(delta(f32["params"]))
    gap = lambda side: max(  # noqa: E731
        float(np.linalg.norm(a - b) / np.linalg.norm(b))
        for a, b in zip(jax.tree_util.tree_leaves(side), want32))
    assert gap(got) <= BF16_TO_F32_RATIO * gap(delta(jstate["params"])), (
        gap(got), gap(delta(jstate["params"])))


def test_hybrid_shared_block_gathers_its_gradient_from_every_use(monkeypatch):
    """zamba2's one shared block runs after layers 1 and 3: its gradient is
    the sum of both uses' (JAX's through its lax.cond), so it differs from a
    model whose block runs once, and equals JAX's (float32, the fence out)."""
    _no_fence(monkeypatch)
    jcfg, tcfg = _configs("zamba2-1.2b")
    assert tcfg.num_layers // tcfg.shared_attn_every == 2
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(3)))
    batch = _batches(jcfg, 1, seed=5, batch=2)[0]
    jg = jax.grad(jzoo.make_loss_fn(jcfg))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_params_from_numpy(tcfg, params, device="cpu")
    loss = tzoo.make_loss_fn(tcfg)(model, batch)
    tg = dict(zip([id(p) for p in model.parameters()],
                  torch.autograd.grad(loss, list(model.parameters()))))
    shared = model.shared_attn.params()
    got = jax.tree_util.tree_map(lambda p: tg[id(p)].numpy(), shared)
    _close_tree(got, jg["shared_attn"], 1e-4)
    once = dataclasses.replace(tcfg, num_layers=2)
    model_once = ttr.Transformer(once, {**model.params(), "layers": model.params()["layers"][:2]})
    g_once = torch.autograd.grad(tzoo.make_loss_fn(once)(model_once, batch),
                                 [model_once.shared_attn.attn.wq])[0]
    assert float((g_once - tg[id(shared["attn"]["wq"])]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_policies_give_the_same_gradients(arch):
    _, base = _configs(arch)
    batch = _batches(base, 1, seed=6, batch=2)[0]
    model = tzoo.init_model(base, seed=3, device="cpu")
    grads = {}
    for policy in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        loss = tzoo.make_loss_fn(cfg)(model, batch)
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
    for policy in ("dots", "full"):
        for a, b in zip(grads[policy], grads["none"]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_checkpoints_cross_between_the_packages(tmp_path, arch):
    """JAX writes, the port restores; the port writes, JAX restores:
    array-equal, every stack (layers, encoder layers, cross) split on the
    way in and stacked on the way out, the shared block as it is."""
    jcfg, tcfg = _configs(arch)
    jstate = jinit_adamw(jtr.init_model(jcfg, jax.random.PRNGKey(0)), lr=1e-3)
    rng = np.random.default_rng(0)
    jstate = jax.tree_util.tree_map(  # moments and step away from their zeros
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)) if a.ndim else a,
        jstate)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    jckpt.save_checkpoint(tmp_path / "jax", 5, jstate, extra_metadata={"stream_step": 5})
    target = init_adamw_state(tzoo.init_model(tcfg, seed=1, device="cpu"))
    restored, meta = tckpt.restore_checkpoint(tmp_path / "jax", target)
    assert meta == {"stream_step": 5}
    assert isinstance(restored["params"], ttr.Transformer)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    got = tree_to_numpy(restored)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    tckpt.save_checkpoint(tmp_path / "port", 6, restored)
    back, _ = jckpt.restore_checkpoint(tmp_path / "port", jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifest = (tmp_path / "port" / "0000000006" / "manifest.json").read_text()
    for key in {"zamba2-1.2b": ["params/shared_attn/attn/wq", "params/layers/mamba/w_in"],
                "whisper-base": ["params/encoder/layers/attn/wq", "params/cross/attn/wk",
                                 "m/encoder/final_ln"],
                "rwkv6-3b": ["params/layers/rwkv/w_lora_b", "v/layers/rwkv/u_bonus"],
                "internvl2-26b": ["params/layers/attn/wo"]}[arch]:
        assert key in manifest, key


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "internvl2-26b"])
def test_launcher_trains_the_families_jax_trains(tmp_path, arch, capsys):
    """``launch/train.py`` trains, resumes and checkpoints what JAX's trains:
    tokens and labels from the stream."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq-len", "16", "--save-every", "2", "--log-every", "2",
            "--checkpoint-dir", str(tmp_path)]
    assert tlaunch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] done: final loss" in out
    assert tckpt.latest_step(tmp_path) == 4


def test_launcher_refuses_whisper_without_frames(tmp_path):
    with pytest.raises(SystemExit, match="audio frames"):
        tlaunch.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path)])
