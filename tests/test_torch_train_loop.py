"""The port's checkpoints and fault-tolerant training loop against the JAX
package's, on the CPU.

``tests/test_runtime.py``'s checkpoint and loop checks, on the port; a
checkpoint written by either package restored in the other, array-equal;
and JAX's ``train()`` and the port's from the same initial weights (JAX
``init_model``), 10 AdamW steps in float32, their logged losses within 1e-4
relative (the float32 train step's tolerance, ``tests/test_torch_train.py``;
the bf16 cotangent fence out of both sides, as there).  The MoE family's
loops run 6 steps: later, a float32 difference between the two sides can
flip a top-k choice that is a near tie, and AdamW's normalised update
carries it (this draw: 7e-4 at step 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.lm_data import SyntheticLMStream as JStream
from repro.models import transformer as jtr
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import init_adamw_state as jinit_adamw
from repro.runtime import checkpoint as jckpt
from repro.runtime import train_loop as jloop
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy, tree_to_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.launch import train as tlaunch
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW, init_adamw_state
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.runtime.train_loop import TrainLoopConfig, train

LOSS_TOL = 1e-4
TINY = dict(num_layers=1, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16,
            vocab_size=64)


def _leaves_equal(a, b):
    a, b = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}},
             "step": torch.tensor(7, dtype=torch.int32)}
    tckpt.save_checkpoint(tmp_path, 7, state, extra_metadata={"stream_step": 3})
    restored, meta = tckpt.restore_checkpoint(tmp_path, state)
    assert meta["stream_step"] == 3
    _leaves_equal(tree_to_numpy(state), tree_to_numpy(restored))
    assert restored["step"].dtype == torch.int32
    # the elastic restore is held in test_torch_distributed_lm.py; it needs its mesh
    with pytest.raises(ValueError, match="mesh"):
        tckpt.restore_checkpoint(tmp_path, state, shardings={})


def test_checkpoint_atomicity_and_gc(tmp_path):
    state = {"x": torch.zeros(2)}
    mgr = tckpt.CheckpointManager(tmp_path, keep=2, save_every=1)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, state)
    assert tckpt.latest_step(tmp_path) == 4
    assert len([p for p in tmp_path.iterdir() if p.is_dir()]) == 2  # only `keep` survive
    (tmp_path / "0000000099.tmp").mkdir()  # a stale .tmp never counts
    assert tckpt.latest_step(tmp_path) == 4
    assert tckpt.latest_step(tmp_path / "none") is None


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_train_state_checkpoints_cross_between_the_packages(tmp_path, arch):
    """JAX writes, the port restores; the port writes, JAX restores: array-equal,
    the layer stack split on the way in and stacked on the way out."""
    jcfg = jreg.reduced_config(arch, num_layers=2, dtype=jnp.float32)
    tcfg = treg.reduced_config(arch, num_layers=2, dtype=torch.float32)
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
    assert len(restored["m"]["layers"]) == tcfg.num_layers
    _leaves_equal(tree_to_numpy(restored), jax.tree_util.tree_map(np.asarray, jstate))

    tckpt.save_checkpoint(tmp_path / "port", 6, restored)
    back, _ = jckpt.restore_checkpoint(tmp_path / "port", jstate)
    _leaves_equal(back, jstate)
    manifest = (tmp_path / "port" / "0000000006" / "manifest.json").read_text()
    assert "params/layers/attn/wq" in manifest


def test_train_loop_runs_and_loss_drops(tmp_path):
    cfg = treg.reduced_config("internlm2-1.8b", num_layers=2, d_model=64, d_ff=128,
                              num_heads=2, num_kv_heads=2, head_dim=32, vocab_size=128)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    loop = TrainLoopConfig(total_steps=30, log_every=10, save_every=10,
                           checkpoint_dir=str(tmp_path), lr=1e-2)
    res = train(cfg, loop, stream=stream, device="cpu")
    losses = [h["loss"] for h in res["history"]]
    assert losses[-1] < losses[0], losses


def test_train_loop_resumes_from_checkpoint(tmp_path):
    cfg = treg.reduced_config("granite-moe-1b-a400m", **TINY)
    mk = lambda: SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)  # noqa
    loop = TrainLoopConfig(total_steps=10, save_every=5, checkpoint_dir=str(tmp_path))
    train(cfg, loop, stream=mk(), device="cpu")
    loop2 = TrainLoopConfig(total_steps=15, save_every=5, checkpoint_dir=str(tmp_path))
    res = train(cfg, loop2, stream=mk(), device="cpu")
    assert res["resumed_from"] == 10
    assert int(res["state"]["step"]) == 15


def test_train_loop_survives_injected_faults(tmp_path):
    cfg = treg.reduced_config("internlm2-1.8b", **TINY)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    faults = {"n": 0}

    def fault_hook(step):
        # one transient failure at step 3, twice (forcing a retry), once at 7
        if step == 3 and faults["n"] < 2:
            faults["n"] += 1
            raise RuntimeError("injected preemption")
        if step == 7 and faults["n"] == 2:
            faults["n"] += 1
            raise RuntimeError("injected node loss")

    loop = TrainLoopConfig(total_steps=10, save_every=5, checkpoint_dir=str(tmp_path),
                           max_step_retries=2)
    res = train(cfg, loop, stream=stream, fault_hook=fault_hook, device="cpu")
    assert int(res["state"]["step"]) == 10
    assert faults["n"] == 3


def test_a_retried_step_replays_from_the_state_before_it(tmp_path):
    """Faults that exhaust the retries with no checkpoint to restore raise;
    and a step retried after a fault gives the losses of a run without one."""
    cfg = treg.reduced_config("internlm2-1.8b", **TINY, dtype=torch.float32)
    mk = lambda: SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)  # noqa
    loop = lambda d: TrainLoopConfig(total_steps=4, log_every=1, save_every=100,  # noqa
                                     checkpoint_dir=str(tmp_path / d))
    clean = train(cfg, loop("a"), stream=mk(), device="cpu")

    def once(step, seen=set()):
        if step == 2 and step not in seen:
            seen.add(step)
            raise RuntimeError("injected")

    faulted = train(cfg, loop("b"), stream=mk(), fault_hook=once, device="cpu")
    assert [h["loss"] for h in faulted["history"]] == [h["loss"] for h in clean["history"]]

    def always(step):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        train(cfg, loop("c"), stream=mk(), fault_hook=always, device="cpu")
    # the sharded loop is held in test_torch_distributed_lm.py; it needs its mesh
    with pytest.raises(ValueError, match="state_shardings"):
        train(cfg, loop("d"), stream=mk(), state_shardings={}, device="cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_train_loop_losses_match_jax(tmp_path, monkeypatch, arch):
    monkeypatch.setattr(jtr, "grad_fence_bf16", lambda x: x)
    monkeypatch.setattr(ttr, "grad_fence_bf16", lambda x: x)
    over = dict(num_layers=2, attention_impl="blocked")
    jcfg = jreg.reduced_config(arch, dtype=jnp.float32, **over)
    tcfg = treg.reduced_config(arch, dtype=torch.float32, **over)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    steps = 6 if tcfg.is_moe else 10
    loop = lambda d: TrainLoopConfig(total_steps=steps, log_every=1, save_every=5,  # noqa
                                     lr=1e-2, num_microbatches=2,
                                     checkpoint_dir=str(tmp_path / d))
    want = jloop.train(jcfg, loop("jax"), stream=JStream(jcfg.vocab_size, 32, 4, seed=1),
                       optimizer=JAdamW(), init_params_fn=lambda: jax.tree_util.tree_map(
                           jnp.asarray, params))
    got = train(tcfg, loop("port"), stream=SyntheticLMStream(tcfg.vocab_size, 32, 4, seed=1),
                optimizer=AdamW(), init_params_fn=lambda: lm_params_from_numpy(
                    tcfg, params, device="cpu"), device="cpu")
    assert [h["step"] for h in got["history"]] == list(range(1, steps + 1))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=LOSS_TOL)
    # JAX's loop's last checkpoint restores into the port's state.
    restored, _ = tckpt.restore_checkpoint(tmp_path / "jax", got["state"])
    assert int(restored["step"]) == 5 * (steps // 5)


def test_launcher_runs_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq-len", "16", "--microbatches", "2", "--compress-grads",
            "--save-every", "3", "--checkpoint-dir", str(tmp_path)]
    assert tlaunch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] done: final loss" in out and "device=cpu" in out
    # A second run in the same directory resumes at step 3 and has nothing left to train.
    assert tlaunch.main(argv) == 0
    assert "resumed from step 3, no steps left" in capsys.readouterr().out


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.reduced_config("granite-moe-1b-a400m", **TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        tzoo.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        train(cfg, TrainLoopConfig(checkpoint_dir=str(tmp_path)),
              stream=SyntheticLMStream(cfg.vocab_size, 8, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                      "--checkpoint-dir", str(tmp_path)])
    state = train_state_from_numpy(cfg, {"step": np.int32(0)}, device="cpu")
    assert state["step"].dtype == torch.int32
