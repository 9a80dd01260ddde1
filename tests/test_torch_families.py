"""The RWKV-6, hybrid (Mamba2), encoder-decoder and vision-frontend families of
the port against the JAX package's, on the CPU.

For each family's ``reduced_config`` in float32, weights come from JAX
``init_model`` and are carried over by ``convert.lm_params_from_numpy``;
inputs (tokens, whisper's frames, internvl2's patch embeddings) are drawn
with numpy from a seed.  Tolerances: forward and decode logits within
``LOGITS_TOL`` (1e-4) of the largest |logit| (JAX's and the port's float32
sums in another order, over 2-4 layers); teacher-forced decode against the
port's own forward within 3e-2, as ``tests/test_arch_smoke.py`` holds
JAX's; shapes, dtypes and the servers' completed tokens exactly.  On the
CPU the recurrences run their plain loops and attention its plain version,
the CUDA kernels' oracles on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.runtime.serve_loop import BatchServer as JServer, ServeConfig as JServeConfig
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.runtime.serve_loop import BatchServer, ServeConfig

FAMILIES = ["rwkv6-3b", "zamba2-1.2b", "whisper-base", "internvl2-26b"]
LOGITS_TOL = 1e-4
TEACHER_FORCED_TOL = 3e-2  # tests/test_arch_smoke.py::test_decode_matches_forward
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arch, **overrides):
    jcfg = jreg.reduced_config(arch, dtype=jnp.float32, **overrides)
    tcfg = treg.reduced_config(arch, dtype=torch.float32, **overrides)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, params, device="cpu")


def _batch(cfg, b, s, seed):
    """tokens (b, s); whisper's frames (b, s + 5, d); internvl2's
    num_prefix_embeds patch embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((b, s + 5, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _close_scaled(got: torch.Tensor, want, tol: float = LOGITS_TOL) -> None:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("impl", ["auto", "blocked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, impl):
    """``blocked`` sends every attention through the flash path (the plain
    version here): whisper's encoder non-causal, its cross-attention with 12
    queries against 17 keys, zamba2's shared block and internvl2 causal."""
    jcfg, tcfg, params, model = _pair(arch, attention_impl=impl)
    batch = _batch(tcfg, 2, 12, seed=1)
    want = np.asarray(jtr.forward(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = ttr.forward(model, tcfg, batch)
    assert got.shape == want.shape == (2, 12, tcfg.padded_vocab)
    v = tcfg.vocab_size
    _close_scaled(got[..., :v], want[..., :v])
    prefill = tzoo.make_prefill_fn(tcfg, device="cpu")  # JAX's prefill: forward's last row
    last = prefill(model, {k: torch.from_numpy(a) for k, a in batch.items()})
    _close_scaled(last[:, :v], want[:, -1, :v])


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_model_trees_match_jax_and_round_trip(arch):
    """The port's own init has JAX's tree (keys, shapes, dtypes), and JAX's
    weights come back from the port unchanged (``tree_to_numpy``)."""
    jcfg, tcfg, params, model = _pair(arch)
    assert jax.tree_util.tree_structure(tree_to_numpy(model)) == \
        jax.tree_util.tree_structure(params)
    for got, want in zip(jax.tree_util.tree_leaves(tree_to_numpy(model)),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, want)
    own = tree_to_numpy(tzoo.init_model(tcfg, seed=1, device="cpu"))
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), params)
    assert jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), own) == shapes


def _decode_inputs(cfg, b, max_seq, seed):
    """Both sides' decode states; whisper's cross caches filled with the same
    draws, as tests/test_arch_smoke.py fills JAX's."""
    jstate = jtr.init_decode_state(cfg[0], b, max_seq, cache_dtype=jnp.float32)
    tstate = ttr.init_decode_state(cfg[1], b, max_seq, cache_dtype=torch.float32, device="cpu")
    if cfg[1].is_encoder_decoder:
        rng = np.random.default_rng(seed)
        for key in ("cross_k", "cross_v"):
            a = rng.standard_normal(jstate[key].shape).astype(np.float32)
            jstate[key] = jnp.asarray(a)
            tstate[key] = torch.from_numpy(a)
    return jstate, tstate


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_jax_token_by_token(arch):
    jcfg, tcfg, params, model = _pair(arch)
    steps, b = 8, 2
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (steps, b), dtype=np.int32)
    jstate, tstate = _decode_inputs((jcfg, tcfg), b, 12, seed=3)
    jdecode = jax.jit(jzoo.make_decode_fn(jcfg))
    tdecode = tzoo.make_decode_fn(tcfg, device="cpu")
    v = tcfg.vocab_size
    for t in range(steps):
        want, jstate = jdecode(params, jnp.asarray(toks[t]), jstate)
        got, out_state = tdecode(model, toks[t], tstate)
        assert out_state is tstate and got.shape == (b, tcfg.padded_vocab)
        _close_scaled(got[:, :v], np.asarray(want)[:, :v])
    assert set(tstate) == set(jstate)
    for key, want in jstate.items():
        _close_scaled(tstate[key], want, 1e-4) if key != "pos" else \
            np.testing.assert_array_equal(tstate[key].numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward_teacher_forced(arch):
    """The port's decode against its own forward.  whisper's cross caches are
    filled from the encoder by ``fill_cross_cache`` on frames of the cache's
    length, which is what its forward attends to; internvl2 decodes text
    without a prefix."""
    _, tcfg, _, model = _pair(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 6), dtype=np.int64)
    batch = {"tokens": toks}
    state = ttr.init_decode_state(tcfg, 2, 8, cache_dtype=torch.float32, device="cpu")
    if tcfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((2, tcfg.max_target_len, tcfg.d_model)).astype(
            np.float32)
        with torch.inference_mode():
            ttr.fill_cross_cache(model, tcfg, batch["frames"], state)
        with pytest.raises(ValueError, match="cross cache"):
            ttr.fill_cross_cache(model, tcfg, batch["frames"][:, :3], state)
    with torch.inference_mode():
        full = ttr.forward(model, tcfg, batch)
    decode = tzoo.make_decode_fn(tcfg, device="cpu")
    outs = [decode(model, toks[:, t], state)[0] for t in range(6)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=TEACHER_FORCED_TOL, atol=TEACHER_FORCED_TOL)
    assert state["pos"].tolist() == [6, 6]


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_decode_state_shapes_and_dtypes_match_jax(arch, cache_dtype):
    jdt, tdt = DTYPES[cache_dtype]
    jcfg, tcfg = jreg.reduced_config(arch), treg.reduced_config(arch)
    want = jtr.init_decode_state(jcfg, 3, 10, cache_dtype=jdt)
    got = tzoo.init_decode_state(tcfg, 3, 10, cache_dtype=tdt, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, key
        assert not got[key].any()


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(jreg.ARCHITECTURES))
def test_input_specs_match_jax(arch, shape):
    """Every arch at every shape, at full size: meta tensors, no storage."""
    want = jzoo.input_specs(jreg.get_config(arch), jshapes.SHAPES[shape])
    got = tzoo.input_specs(treg.get_config(arch), tshapes.SHAPES[shape])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = {}
    for name, val in got.items():
        for key, t in (val.items() if isinstance(val, dict) else [(None, val)]):
            path = (jax.tree_util.DictKey(name),) + (
                () if key is None else (jax.tree_util.DictKey(key),))
            flat_got[path] = t
    assert set(flat_got) == set(flat_want)
    for path, w in flat_want.items():
        t = flat_got[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, path


def _drain(srv, requests):
    for rid, prompt in requests:
        srv.submit(rid, prompt)
    return srv.run_until_drained()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_batch_server_reuses_slots_as_jax(arch):
    """Seven requests through three slots, so slots are reused; the port's
    completed tokens equal JAX's, and a reused slot's equal a fresh
    server's."""
    jcfg, tcfg, params, model = _pair(arch)
    requests = [(f"r{i}", [1 + i % 5, 7, 3 + i][: 2 + i % 2]) for i in range(7)]
    sc = dict(max_slots=3, max_len=10, eos_id=-1)
    want = _drain(JServer(jcfg, params, JServeConfig(**sc)), requests)
    got = _drain(BatchServer(tcfg, model, ServeConfig(**sc), device="cpu"), requests)
    assert sorted(d["id"] for d in got) == [f"r{i}" for i in range(7)]
    assert got == want
    fresh = _drain(BatchServer(tcfg, model, ServeConfig(**sc), device="cpu"), requests[-1:])
    assert fresh[0]["tokens"] == {d["id"]: d["tokens"] for d in got}[requests[-1][0]]


def test_reset_slot_zeroes_a_reused_rwkv_slot():
    """A second request in a reused slot decodes as in a fresh server: the
    slot's WKV and token-shift states are zeroed when it is admitted (with
    only ``pos`` reset, the first request's state leaks into the second)."""
    _, tcfg, _, model = _pair("rwkv6-3b")
    sc = ServeConfig(max_slots=1, max_len=10, eos_id=-1)
    reused = {d["id"]: d["tokens"] for d in _drain(
        BatchServer(tcfg, model, sc, device="cpu"), [("a", [5, 9, 2]), ("b", [4, 4])])}
    fresh = _drain(BatchServer(tcfg, model, sc, device="cpu"), [("b", [4, 4])])
    assert reused["b"] == fresh[0]["tokens"]
    srv = BatchServer(tcfg, model, sc, device="cpu")
    for key in ("wkv", "x_prev_t", "x_prev_c"):
        srv.state[key].fill_(1.0)
    srv.submit("c", [1])
    srv._admit()
    assert all(not srv.state[key][:, 0].any() for key in ("wkv", "x_prev_t", "x_prev_c"))


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "whisper-base"])
def test_remat_policies_cover_the_new_layer_bodies(arch, policy):
    """Under each ``remat_policy`` the new layer bodies give the same logits
    and input gradients on the CPU (the plain recurrences under autograd;
    on the card the scan kernels' backward kernels)."""
    _, tcfg, params, _ = _pair(arch)
    batch = _batch(tcfg, 1, 6, seed=5)
    tree = ttr.Transformer(tcfg, lm_params_from_numpy(tcfg, params, device="cpu").params())
    ref_cfg = dataclasses.replace(tcfg, remat_policy="none")
    grads = {}
    for cfg in (ref_cfg, dataclasses.replace(tcfg, remat_policy=policy)):
        tree.zero_grad()
        logits = ttr.forward(tree, cfg, batch)
        logits[..., : cfg.vocab_size].float().square().mean().backward()
        grads[cfg.remat_policy] = (logits.detach(), tree.embed.grad.clone())
    torch.testing.assert_close(grads[policy][0], grads["none"][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[policy][1], grads["none"][1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_refused_naming_its_item(arch):
    """Refused until ROADMAP item 13; now every family trains: ``make_loss_fn``
    and ``make_train_step`` take it, and one SGD step on the CPU (the plain
    recurrences under autograd) gives a finite loss and moves every weight
    the loss reaches (tests/test_torch_train_families.py holds the steps to
    JAX's)."""
    cfg = treg.reduced_config(arch)
    batch = _batch(cfg, 2, 6, seed=7)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    model = tzoo.init_model(cfg, seed=0, device="cpu")
    loss = tzoo.make_loss_fn(cfg)(model, batch)
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    before = [p.detach().clone() for p in model.parameters()]
    state, metrics = tzoo.make_train_step(cfg, device="cpu")({"params": model, "lr": 1e-2}, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = [not torch.equal(a, b) for a, b in zip(before, state["params"].parameters())]
    assert sum(moved) >= len(moved) - 2, moved  # all but weights no gradient reaches
    assert not hasattr(ttr, "check_trainable")


def test_launcher_serves_the_recurrent_families_and_refuses_whisper(capsys):
    for arch in ("rwkv6-3b", "zamba2-1.2b", "internvl2-26b"):
        assert tlaunch.main(["--arch", arch, "--reduced", "--requests", "3", "--max-len", "8",
                             "--device", "cpu"]) == 0
        assert capsys.readouterr().out.startswith("[serve] 3 requests,")
    with pytest.raises(SystemExit, match="audio frames"):
        tlaunch.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])
