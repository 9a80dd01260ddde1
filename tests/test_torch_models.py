"""The port's LM slice (configs, layers, attention, dense forward) against the
JAX package, on the CPU.

Inputs are drawn with numpy from a seed and weights come from JAX
``init_model``, carried over by ``repro_torch.convert.lm_params_from_numpy``,
so both sides compute from identical numbers.

Tolerances:

* float32: 1e-4 on logits of magnitude ~5 (the two frameworks' float32
  matmuls and softmaxes differ in summation order only; measured gaps are
  ~1e-5), 2e-5 on attention and layer outputs, as the flash tests use.
* bfloat16 logits and attention outputs: ``max |port - jax| <=
  BF16_SCALE_TOL * max |jax|``.  bfloat16 keeps 8 significant bits, and the
  two frameworks round at different places in each of a layer's ~10 bf16
  steps (XLA may keep excess precision across fused elementwise ops; the
  Pallas-free blocked path rounds probabilities, the plain version does
  not).  JAX's own blocked and dense paths differ by 1.8% (3 layers) to
  2.7% (24 layers) of the logits' largest magnitude, so no elementwise
  tolerance below that can hold; 5% leaves a factor of two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.data.lm_data import SyntheticLMStream as JaxStream
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr

F32_TOL = 2e-5
LOGITS_F32_TOL = 1e-4
BF16_SCALE_TOL = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _same_config(jcfg, tcfg) -> None:
    for f in dataclasses.fields(jcfg):
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert _dtype_name(jv) == _dtype_name(tv), f.name
        else:
            assert jv == tv, f.name
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.is_moe, tcfg.is_attention_free, tcfg.sub_quadratic) == (
        jcfg.is_moe, jcfg.is_attention_free, jcfg.sub_quadratic)


def _pair_configs(**overrides):
    jo = dict(overrides)
    to = dict(overrides)
    if "dtype" in overrides:
        jo["dtype"], to["dtype"] = DTYPES[overrides["dtype"]]
    return (jreg.reduced_config("internlm2-1.8b", **jo),
            treg.reduced_config("internlm2-1.8b", **to))


def _bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= BF16_SCALE_TOL * scale, (gap, scale)


@pytest.mark.parametrize("arch", sorted(jreg.ARCHITECTURES))
def test_configs_match_jax_registry(arch):
    _same_config(jreg.get_config(arch), treg.get_config(arch))
    _same_config(jreg.reduced_config(arch), treg.reduced_config(arch))
    _same_config(jreg.reduced_config(arch, num_kv_heads=1, attention_impl="blocked"),
                 treg.reduced_config(arch, num_kv_heads=1, attention_impl="blocked"))
    jshape = {k: (v if isinstance(v, str) else dataclasses.astuple(v))
              for k, v in jshapes.applicable_shapes(jreg.get_config(arch)).items()}
    tshape = {k: (v if isinstance(v, str) else dataclasses.astuple(v))
              for k, v in tshapes.applicable_shapes(treg.get_config(arch)).items()}
    assert jshape == tshape


def test_internlm2_full_size():
    cfg = treg.get_config("internlm2-1.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.padded_vocab) == (24, 2048, 16, 8, 128, 8192, 92544,
                                                             92672)
    assert abs(cfg.param_count() - 1.889e9) < 1e6
    with pytest.raises(KeyError):
        treg.get_config("nope")


def test_lm_stream_matches_jax():
    for step in (0, 3):
        a = JaxStream(500, 33, 3, seed=7).skip_to(step)
        b = SyntheticLMStream(500, 33, 3, seed=7).skip_to(step)
        for x, y in zip(next(a).values(), next(b).values()):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    sw = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    got = [tlayers.rms_norm(xt, torch.from_numpy(w), 1e-5),
           tlayers.swiglu({k: torch.from_numpy(v) for k, v in sw.items()}, xt),
           tlayers.RMSNorm(torch.from_numpy(w))(xt, 1e-5),
           tlayers.SwiGLU({k: torch.from_numpy(v) for k, v in sw.items()})(xt)]
    want = [jlayers.rms_norm(xj, jnp.asarray(w), 1e-5),
            jlayers.swiglu({k: jnp.asarray(v) for k, v in sw.items()}, xj)]
    want += want
    for g, wnt in zip(got, want):
        assert g.dtype == tdt
        g, wnt = g.detach().float().numpy(), np.asarray(wnt, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, wnt, rtol=F32_TOL, atol=F32_TOL)
        else:
            _bf16_close(g, wnt)

    q = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    jc, js = jlayers.rope_frequencies(32, jnp.arange(9), 1e4)
    tc, ts = tlayers.rope_frequencies(32, torch.arange(9), 1e4)
    got = tlayers.apply_rope(torch.from_numpy(q).to(tdt), tc, ts).float().numpy()
    want = np.asarray(jlayers.apply_rope(jnp.asarray(q, jdt), jc, js), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        _bf16_close(got, want)


def test_rope_tables_at_32k_positions():
    """float32 pow may differ by an ulp in a few frequencies (measured 7.6e-6 at 32k)."""
    pos = np.arange(32_768)
    for hd in (32, 64, 128):
        jc, js = jlayers.rope_frequencies(hd, jnp.asarray(pos), 1e4)
        tc, ts = tlayers.rope_frequencies(hd, torch.from_numpy(pos), 1e4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_heads,causal", [(2, True), (1, True), (4, False)])
def test_attention_paths_match_jax(dtype, kv_heads, causal):
    jcfg, tcfg = _pair_configs(num_kv_heads=kv_heads, dtype=dtype)
    params = {k: np.array(v) for k, v in
              jattn.init_attention(jax.random.PRNGKey(kv_heads), jcfg).items()}
    x = np.random.default_rng(1).standard_normal((2, 77, jcfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_blocked = np.asarray(jattn.attention(jp, jcfg, xj, causal=causal, impl="blocked"),
                              np.float32)
    want_dense = np.asarray(jattn.attention(jp, jcfg, xj, causal=causal, impl="dense"),
                            np.float32)
    for impl in ("blocked", "dense", "auto"):  # auto: 77 tokens take the dense path
        got = tattn.attention(tparams, tcfg, xt, causal=causal, impl=impl)
        assert got.shape == x.shape and got.dtype == tdt
        for want in (want_blocked, want_dense):
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
            else:
                _bf16_close(got.float().numpy(), want)
    with pytest.raises(ValueError, match="impl"):
        tattn.attention(tparams, tcfg, xt, impl="flash")


def _forward_pair(dtype, **overrides):
    jcfg, tcfg = _pair_configs(num_kv_heads=2, attention_impl="blocked", dtype=dtype, **overrides)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    model = lm_params_from_numpy(tcfg, params, device="cpu")
    tokens = next(SyntheticLMStream(jcfg.vocab_size, 96, 2, seed=0))["tokens"]
    want = np.asarray(jtr.forward(params, jcfg, {"tokens": jnp.asarray(tokens)}), np.float32)
    return jcfg, tcfg, params, model, tokens, want


def test_forward_f32_matches_jax():
    """float32 at 1e-4, with a vocabulary of 500 padded to 512 (masked to -1e9)."""
    jcfg, tcfg, params, model, tokens, want = _forward_pair("float32", vocab_size=500)
    assert tcfg.padded_vocab == 512
    got = ttr.forward(model, tcfg, {"tokens": tokens})
    assert got.shape == (2, 96, 512) and got.dtype == torch.float32
    got = got.detach().numpy()
    np.testing.assert_allclose(got[..., :500], want[..., :500], rtol=LOGITS_F32_TOL,
                               atol=LOGITS_F32_TOL)
    np.testing.assert_allclose(got[..., 500:], want[..., 500:], rtol=1e-6)
    assert (got[..., 500:] < -9e8).all()

    prefill = tzoo.make_prefill_fn(tcfg, device="cpu")
    last = prefill(model, {"tokens": torch.from_numpy(tokens)})
    want_last = np.asarray(jzoo.make_prefill_fn(jcfg)(params, {"tokens": jnp.asarray(tokens)}))
    np.testing.assert_allclose(last.numpy(), want_last, rtol=LOGITS_F32_TOL, atol=LOGITS_F32_TOL)


def test_forward_bf16_matches_jax():
    jcfg, tcfg, params, model, tokens, want = _forward_pair("bfloat16")
    got = ttr.forward(model, tcfg, {"tokens": tokens})
    assert got.dtype == torch.bfloat16
    _bf16_close(got.detach().float().numpy(), want)
    dense = ttr.forward(model, dataclasses.replace(tcfg, attention_impl="dense"),
                        {"tokens": tokens})
    _bf16_close(dense.detach().float().numpy(), want)


def test_init_model_shapes_and_determinism():
    cfg = treg.reduced_config("internlm2-1.8b", num_kv_heads=2)
    a = tzoo.init_model(cfg, seed=3, device="cpu")
    b = tzoo.init_model(cfg, seed=3, device="cpu")
    jshapes_ = jax.tree_util.tree_map(
        lambda x: x.shape, jax.eval_shape(lambda: jtr.init_model(
            jreg.reduced_config("internlm2-1.8b", num_kv_heads=2), jax.random.PRNGKey(0))))
    lp = a.layers[0]
    assert tuple(a.embed.shape) == jshapes_["embed"]["emb"]
    assert tuple(a.lm_head.shape) == jshapes_["lm_head"]["emb"]
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(getattr(lp.attn, name).shape) == jshapes_["layers"]["attn"][name][1:]
    for name in ("w_gate", "w_up", "w_down"):
        assert tuple(getattr(lp.ffn, name).shape) == jshapes_["layers"]["ffn"][name][1:]
    assert len(a.layers) == cfg.num_layers
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and pa.dtype == torch.float32 and pa.requires_grad  # trainable
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    # The weights are drawn at the JAX package's scales.
    assert abs(float(lp.attn.wq.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b", "zamba2-1.2b",
                                  "whisper-base", "internvl2-26b"])
def test_unported_families_raise(arch):
    """Every family builds and prefills at reduced_config (the MoE family
    since ROADMAP item 2, the other four since item 10's first part); the
    four raised naming ROADMAP item 13 until it ported their training, and
    now give a finite, differentiable loss."""
    cfg = treg.reduced_config(arch)
    model = tzoo.init_model(cfg, seed=0, device="cpu")
    batch = {"tokens": np.zeros((1, 5))}
    if cfg.is_encoder_decoder:
        batch["frames"] = np.ones((1, 7, cfg.d_model), np.float32)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = np.ones((1, 3, cfg.d_model), np.float32)
    last = tzoo.make_prefill_fn(cfg, device="cpu")(model, batch)
    assert last.shape == (1, cfg.padded_vocab) and bool(torch.isfinite(last).all())
    if cfg.is_moe:
        return
    batch["labels"] = np.ones((1, 5), np.int64)
    loss = tzoo.make_loss_fn(cfg)(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    assert bool(torch.isfinite(loss)) and all(g is None or bool(torch.isfinite(g).all())
                                              for g in grads)
