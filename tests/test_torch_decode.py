"""The port's LM decode and continuous-batching server against the JAX package's,
on the CPU.

Weights come from JAX ``init_model`` on a reduced internlm2-1.8b config in
float32, carried over by ``repro_torch.convert.lm_params_from_numpy``;
inputs are drawn with numpy from a seed.  Tolerances: ``F32_TOL`` (2e-5)
on attention outputs and caches and ``LOGITS_F32_TOL`` (1e-4) on logits,
as ``tests/test_torch_models.py`` holds the forward pass; teacher-forced
decode against the prefill at 3e-2, as ``tests/test_arch_smoke.py`` holds
JAX's.  The servers' completed tokens must be equal, in the five scenarios
of ``tests/test_runtime.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.runtime.serve_loop import BatchServer as JServer, ServeConfig as JServeConfig
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.runtime.serve_loop import BatchServer, ServeConfig

F32_TOL = 2e-5
LOGITS_F32_TOL = 1e-4  # tests/test_torch_models.py
TEACHER_FORCED_TOL = 3e-2  # tests/test_arch_smoke.py::test_decode_matches_forward

# tests/test_runtime.py's server config, in float32 on both sides.
TINY = dict(num_layers=1, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, head_dim=16,
            vocab_size=64)


def _configs(**overrides):
    return (jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32, **overrides),
            treg.reduced_config("internlm2-1.8b", dtype=torch.float32, **overrides))


def _models(**overrides):
    jcfg, tcfg = _configs(**overrides)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, params, device="cpu")


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kv_heads,rope_pos", [(2, None), (1, None), (4, [3, 9, 0]),
                                               (2, 5)])
def test_decode_attention_matches_jax(kv_heads, rope_pos):
    """Three slots at positions that differ (one at 0, one at the cache's
    end); the cache holds stale rows past every position."""
    jcfg, tcfg = _configs(num_kv_heads=kv_heads)
    params = {k: np.array(v) for k, v in
              jattn.init_attention(jax.random.PRNGKey(kv_heads), jcfg).items()}
    rng = np.random.default_rng(kv_heads)
    b, s_cache = 3, 12
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s_cache, kv_heads, jcfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([4, 0, s_cache - 1], np.int32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    kw = {} if rope_pos is None else {"rope_pos": rope_pos}
    want, wk, wv = jattn.decode_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                          jnp.asarray(cv), jnp.asarray(pos), **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    trp = kw and {"rope_pos": torch.as_tensor(rope_pos)}
    got, gk, gv = tattn.decode_attention(tp, tcfg, torch.from_numpy(x), tk, tv,
                                         torch.from_numpy(pos), **trp)
    assert got.shape == (b, 1, jcfg.d_model) and got.dtype == torch.float32
    assert gk is tk and gv is tv  # written in place
    _close(got, want, F32_TOL)
    _close(gk, wk, F32_TOL)
    _close(gv, wv, F32_TOL)

    # Without the cache write and without RoPE (the cross-attention form).
    want, _, _ = jattn.decode_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                        jnp.asarray(cv), s_cache - 1, update_cache=False,
                                        rope=False)
    tk = torch.from_numpy(ck.copy())
    got, gk, _ = tattn.decode_attention(tp, tcfg, torch.from_numpy(x), tk,
                                        torch.from_numpy(cv.copy()), s_cache - 1,
                                        update_cache=False, rope=False)
    _close(got, want, F32_TOL)
    np.testing.assert_array_equal(gk.numpy(), ck)


def test_project_qkv_positions_and_compute_kv_match_jax():
    jcfg, tcfg = _configs()
    params = {k: np.array(v) for k, v in jattn.init_attention(jax.random.PRNGKey(3), jcfg).items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = np.random.default_rng(2).standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    positions = np.array([[7, 8, 9, 10, 11], [0, 3, 6, 9, 12]])
    for kw in ({}, {"positions": positions}, {"rope": False}):
        want = jattn._project_qkv(jp, jcfg, jnp.asarray(x),
                                  **{k: jnp.asarray(v) if k == "positions" else v
                                     for k, v in kw.items()})
        got = tattn.project_qkv(tp, tcfg, torch.from_numpy(x),
                                **{k: torch.from_numpy(v) if k == "positions" else v
                                   for k, v in kw.items()})
        for g, w in zip(got, want):
            _close(g, w, F32_TOL)
    for g, w in zip(tattn.compute_kv(tp, tcfg, torch.from_numpy(x)),
                    jattn.compute_kv(jp, jcfg, jnp.asarray(x))):
        _close(g, w, F32_TOL)


def test_lse_partial_raises_naming_its_item():
    """``lse_partial``, once refused (naming ROADMAP item 10), now ported: the
    normalised local output and its lse against JAX's, with and without the
    cache write, and for a window that holds no key (mask position -1)."""
    jcfg, tcfg = _configs()
    params = {k: np.array(v) for k, v in jattn.init_attention(jax.random.PRNGKey(0), jcfg).items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(4)
    cache_k, cache_v = (rng.standard_normal((3, 6, tcfg.num_kv_heads, tcfg.head_dim))
                        .astype(np.float32) for _ in range(2))
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    for pos, rope_pos, update in (([0, 2, 5], None, True), ([-1, 3, 5], [4, 9, 13], False)):
        want = jattn.decode_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(cache_k),
                                      jnp.asarray(cache_v), jnp.asarray(pos),
                                      update_cache=update, lse_partial=True,
                                      rope_pos=None if rope_pos is None else jnp.asarray(rope_pos))
        got = tattn.decode_attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(cache_k.copy()),
                                     torch.from_numpy(cache_v.copy()), torch.tensor(pos),
                                     update_cache=update, lse_partial=True,
                                     rope_pos=None if rope_pos is None else torch.tensor(rope_pos))
        assert len(got) == 4
        for g, w in zip(got, want):
            _close(g, w, F32_TOL)
        assert got[1].dtype == torch.float32 and got[0].shape == (3, 1, tcfg.num_heads,
                                                                 tcfg.head_dim)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_init_decode_state_shapes_and_dtypes(cache_dtype):
    jcfg, tcfg = _configs()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache_dtype]
    want = jtr.init_decode_state(jcfg, 3, 10, cache_dtype=jdt)
    got = tzoo.init_decode_state(tcfg, 3, 10, cache_dtype=tdt, device="cpu")
    assert set(got) == set(want) == {"pos", "k", "v"}
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == np.dtype(w.dtype).name, key
        assert not got[key].any()


def test_decode_step_matches_jax_token_by_token():
    """Ten steps of two sequences, GQA (4 heads over 2 KV heads) and a
    vocabulary of 500 padded to 512, each step's logits at LOGITS_F32_TOL."""
    jcfg, tcfg, params, model = _models(num_heads=4, num_kv_heads=2, head_dim=32,
                                        vocab_size=500)
    assert tcfg.padded_vocab == 512
    steps, b = 10, 2
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (steps, b), dtype=np.int32)
    jstate = jtr.init_decode_state(jcfg, b, 16, cache_dtype=jnp.float32)
    tstate = ttr.init_decode_state(tcfg, b, 16, cache_dtype=torch.float32, device="cpu")
    jdecode = jax.jit(jzoo.make_decode_fn(jcfg))
    tdecode = tzoo.make_decode_fn(tcfg, device="cpu")
    for t in range(steps):
        want, jstate = jdecode(params, jnp.asarray(toks[t]), jstate)
        got, out_state = tdecode(model, toks[t], tstate)
        assert out_state is tstate
        assert got.shape == (b, 512) and got.dtype == torch.float32
        _close(got[:, :500], np.asarray(want)[:, :500], LOGITS_F32_TOL)
        assert (got[:, 500:] < -9e8).all()
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    _close(tstate["k"], jstate["k"], F32_TOL)
    _close(tstate["v"], jstate["v"], F32_TOL)


def test_decode_matches_forward_teacher_forced():
    """The port's decode against its own prefill, as tests/test_arch_smoke.py
    holds JAX's (float32, 3e-2)."""
    _, tcfg, _, model = _models()
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (1, 6), dtype=np.int64)
    full = ttr.forward(model, tcfg, {"tokens": toks}).detach()
    state = ttr.init_decode_state(tcfg, 1, 8, cache_dtype=torch.float32, device="cpu")
    decode = tzoo.make_decode_fn(tcfg, device="cpu")
    outs = [decode(model, toks[:, t], state)[0] for t in range(6)]
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), full.numpy(),
                               rtol=TEACHER_FORCED_TOL, atol=TEACHER_FORCED_TOL)
    assert state["pos"].tolist() == [6]


def _servers(max_slots, max_len, eos_id=-1):
    """A JAX server and the port's on the same float32 weights."""
    jcfg, tcfg, params, model = _models(**TINY)
    return (JServer(jcfg, params, JServeConfig(max_slots=max_slots, max_len=max_len,
                                               eos_id=eos_id)),
            BatchServer(tcfg, model, ServeConfig(max_slots=max_slots, max_len=max_len,
                                                 eos_id=eos_id), device="cpu"))


def _drain(srv, requests):
    for rid, prompt in requests:
        srv.submit(rid, prompt)
    return srv.run_until_drained()


def test_batch_server_continuous_batching_matches_jax():
    requests = [(f"r{i}", [1 + i, 2, 3]) for i in range(5)]  # more requests than slots
    jsrv, tsrv = _servers(2, 12)
    want, got = _drain(jsrv, requests), _drain(tsrv, requests)
    assert sorted(d["id"] for d in got) == [f"r{i}" for i in range(5)]
    assert all(len(d["tokens"]) > 0 for d in got)
    assert got == want


def test_server_slot_reuse_matches_fresh_decode_and_jax():
    prompt = [5, 9, 2]
    jsrv, tsrv = _servers(1, 10)
    reused = {d["id"]: d["tokens"] for d in _drain(tsrv, [("a", [3, 3]), ("b", prompt)])}
    want = {d["id"]: d["tokens"] for d in _drain(jsrv, [("a", [3, 3]), ("b", prompt)])}
    _, fresh_srv = _servers(1, 10)
    fresh = {d["id"]: d["tokens"] for d in _drain(fresh_srv, [("b", prompt)])}
    assert reused["b"] == fresh["b"]
    assert reused == want


def test_batch_server_eos_on_first_decoded_token_matches_jax():
    prompt = [4, 2]
    _, probe = _servers(1, 10)
    first_tok = _drain(probe, [("p", prompt)])[0]["tokens"][0]
    jsrv, tsrv = _servers(1, 10, eos_id=first_tok)
    got = {d["id"]: d["tokens"] for d in _drain(tsrv, [("a", prompt), ("b", prompt)])}
    want = {d["id"]: d["tokens"] for d in _drain(jsrv, [("a", prompt), ("b", prompt)])}
    assert got == want == {"a": [first_tok], "b": [first_tok]}


def test_batch_server_queue_longer_than_slots_matches_jax():
    jsrv, tsrv = _servers(2, 8)
    for srv in (jsrv, tsrv):
        for i in range(7):
            srv.submit(f"q{i}", [1 + i % 5, 2])
    ticks = 0
    while (any(tsrv.slots) or tsrv.queue) and ticks < 500:
        tsrv.tick()
        assert sum(s is not None for s in tsrv.slots) <= 2
        ticks += 1
    ids = [d["id"] for d in tsrv.completed]
    assert sorted(ids) == sorted(f"q{i}" for i in range(7))
    assert len(ids) == len(set(ids))
    assert tsrv.completed == jsrv.run_until_drained()


def test_batch_server_all_slots_finish_same_tick_matches_jax():
    jsrv, tsrv = _servers(3, 6)
    for srv in (jsrv, tsrv):
        for i in range(6):
            srv.submit(f"w{i}", [3, 5])
    waves, ticks = [], 0
    while (any(tsrv.slots) or tsrv.queue) and ticks < 500:
        before = len(tsrv.completed)
        tsrv.tick()
        if len(tsrv.completed) > before:
            waves.append(len(tsrv.completed) - before)
        ticks += 1
    assert waves == [3, 3]
    assert len({len(d["tokens"]) for d in tsrv.completed}) == 1
    assert tsrv.completed == jsrv.run_until_drained()


def test_batch_server_refuses_prompts_the_cache_cannot_hold():
    _, tsrv = _servers(1, 4)
    for prompt in ([], [1, 2, 3, 4, 5]):
        with pytest.raises(ValueError, match="max_len"):
            tsrv.submit("x", prompt)


def test_launch_serve_main_on_cpu(capsys):
    assert tlaunch.main(["--arch", "internlm2-1.8b", "--reduced", "--requests", "3",
                         "--max-len", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[serve] 3 requests,") and "tok/s" in out


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.reduced_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="cuda"):
        tzoo.make_decode_fn(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tzoo.init_decode_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "internlm2-1.8b", "--reduced"])
    model = tzoo.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchServer(cfg, model, ServeConfig())


@pytest.mark.parametrize("arch,item", [("granite-moe-1b-a400m", "item 2"), ("rwkv6-3b", "item 10"),
                                       ("zamba2-1.2b", "item 10"), ("whisper-base", "item 10"),
                                       ("internvl2-26b", "item 10")])
def test_unported_families_raise_naming_their_item(arch, item, capsys):
    """``item``: the ROADMAP item that ported the family's decode.  Every
    family decodes at reduced_config and the launcher serves it, except
    whisper, which it refuses as JAX's does (a token prompt carries no
    audio frames); the families of item 10 train since item 13: one SGD
    step on the CPU."""
    cfg = treg.reduced_config(arch)
    state = tzoo.init_decode_state(cfg, 2, 4, device="cpu")
    logits, state = tzoo.make_decode_fn(cfg, device="cpu")(
        tzoo.init_model(cfg, seed=0, device="cpu"), np.array([1, 2]), state)
    assert logits.shape == (2, cfg.padded_vocab) and state["pos"].tolist() == [1, 1]
    assert bool(torch.isfinite(logits).all())
    if cfg.is_encoder_decoder:
        with pytest.raises(SystemExit, match="audio frames"):
            tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu"])
    else:
        assert tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests",
                             "2"]) == 0
        assert capsys.readouterr().out.startswith("[serve] 2 requests,")
    if item == "item 10":
        batch = {"tokens": np.array([[1, 2, 3]]), "labels": np.array([[2, 3, 4]])}
        if cfg.is_encoder_decoder:
            batch["frames"] = np.ones((1, 4, cfg.d_model), np.float32)
        _, metrics = tzoo.make_train_step(cfg, device="cpu")(
            {"params": tzoo.init_model(cfg, seed=0, device="cpu"), "lr": 1e-3}, batch)
        assert np.isfinite(float(metrics["loss"]))
