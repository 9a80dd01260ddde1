"""The port's MoE family against the JAX package's, on the CPU.

``moe_layer``'s weights come from JAX ``init_moe`` and its inputs are drawn
with numpy from a seed, so both sides compute from identical numbers.
Tolerances: 2e-4 on the layer's output and the aux loss in float32, as
``tests/test_moe.py`` holds JAX's layer against its direct oracle; the
dispatch one-hot tensor equal, entry for entry, to the one JAX builds (the
same slots and the same drops); the combine weights at 1e-6 (float32
gates); reduced granite-moe-1b-a400m logits at 1e-4 (``LOGITS_F32_TOL`` of
``tests/test_torch_models.py``), decode logits token by token at 1e-4 and
the caches at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

MOE_TOL = 2e-4  # tests/test_moe.py
LOGITS_F32_TOL = 1e-4
F32_TOL = 2e-5
ARCH = "granite-moe-1b-a400m"


def _configs(**overrides):
    return (jreg.reduced_config(ARCH, dtype=jnp.float32, **overrides),
            treg.reduced_config(ARCH, dtype=torch.float32, **overrides))


def _layer(seed, shape, **overrides):
    jcfg, tcfg = _configs(**overrides)
    params = {k: np.asarray(v) for k, v in jmoe.init_moe(jax.random.PRNGKey(seed), jcfg).items()}
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jcfg, tcfg, params, x


def _jax_dispatch(params, cfg, x):
    """JAX's one-hot dispatch and combine tensors, built by its own
    formulas (src/repro/models/moe.py, moe_layer) on its own gating."""
    g, tg, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    logits = jnp.einsum("gtd,de->gte", x, params["router"])
    _, top_vals, top_idx = jmoe._top_k_gating(logits.reshape(g * tg, e), k)
    top_vals, top_idx = top_vals.reshape(g, tg, k), top_idx.reshape(g, tg, k)
    capacity = min(max(1, int(cfg.capacity_factor * k * tg / e)), tg)
    onehot_i = jax.nn.one_hot(top_idx, e, dtype=jnp.int32)
    flat = onehot_i.reshape(g, tg * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(g, tg, k, e) * onehot_i).sum(-1)
    keep = pos < capacity
    onehot_e = jax.nn.one_hot(top_idx, e, dtype=x.dtype)
    onehot_c = jax.nn.one_hot(pos, capacity, dtype=x.dtype)
    disp = jnp.einsum("gtke,gtkc,gtk->gtec", onehot_e, onehot_c, keep.astype(x.dtype))
    comb = jnp.einsum("gtke,gtkc,gtk->gtec", onehot_e, onehot_c, top_vals * keep)
    return np.asarray(disp), np.asarray(comb), int((~keep).sum())


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])  # 8.0: nothing dropped
def test_moe_layer_matches_jax(group, capacity_factor):
    jcfg, tcfg, params, x = _layer(
        group, (2, 32, 16), d_model=16, num_experts=4, top_k=2, moe_d_ff=8,
        capacity_factor=capacity_factor, moe_group_size=group, param_dtype=jnp.float32)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got = tmoe.moe_layer(tparams, tcfg, torch.from_numpy(x))
    want = jmoe.moe_layer({k: jnp.asarray(v) for k, v in params.items()}, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL, atol=MOE_TOL)

    xg = x.reshape(-1, group, 16)
    disp, comb, _, _ = tmoe.dispatch(tparams, tcfg, torch.from_numpy(xg))
    jdisp, jcomb, dropped = _jax_dispatch({k: jnp.asarray(v) for k, v in params.items()}, jcfg,
                                          jnp.asarray(xg))
    np.testing.assert_array_equal(disp.numpy(), jdisp)
    np.testing.assert_allclose(comb.numpy(), jcomb, rtol=1e-6, atol=1e-6)
    kept = int(disp.sum())
    assert kept == x.shape[0] * x.shape[1] * tcfg.top_k - dropped
    if capacity_factor == 8.0:
        assert dropped == 0
    elif group == 32:
        assert dropped > 0  # the case exercises drops


def test_moe_layer_matches_direct_oracle_when_no_drops():
    """tests/test_moe.py's per-token oracle, on the port's layer."""
    jcfg, tcfg, params, x = _layer(
        1, (2, 32, 16), d_model=16, num_experts=4, top_k=2, moe_d_ff=8, capacity_factor=8.0,
        moe_group_size=8)
    got = tmoe.moe_layer({k: torch.from_numpy(v) for k, v in params.items()}, tcfg,
                         torch.from_numpy(x)).numpy()
    xt = x.reshape(-1, 16)
    gates = torch.softmax(torch.from_numpy(xt @ params["router"]), -1)
    vals, idx = torch.topk(gates, 2)
    vals = vals / vals.sum(-1, keepdim=True)
    want = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(2):
            e = int(idx[t, j])
            h = xt[t]
            gate = torch.nn.functional.silu(torch.from_numpy(h @ params["w_gate"][e])).numpy()
            want[t] += float(vals[t, j]) * ((gate * (h @ params["w_up"][e])) @ params["w_down"][e])
    np.testing.assert_allclose(got.reshape(-1, 16), want, rtol=MOE_TOL, atol=MOE_TOL)


def test_aux_loss_and_gradients_match_jax():
    jcfg, tcfg, params, x = _layer(
        3, (4, 128, 16), d_model=16, num_experts=8, top_k=2, moe_d_ff=8)
    tparams = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y, aux = tmoe.moe_layer(tparams, tcfg, torch.from_numpy(x), return_aux=True)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jy, jaux = jmoe.moe_layer(jp, jcfg, jnp.asarray(x), return_aux=True)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=MOE_TOL)
    assert 0.7 < float(aux.detach()) < 2.0  # near 1 for a balanced random router (tests/test_moe.py)

    def jloss(p):
        out, a = jmoe.moe_layer(p, jcfg, jnp.asarray(x), return_aux=True)
        return jnp.sum(out**2) + a

    jgrads = jax.jit(jax.grad(jloss))(jp)
    grads = torch.autograd.grad((y**2).sum() + aux, list(tparams.values()))
    for (name, g) in zip(tparams, grads):
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=MOE_TOL,
                                   atol=MOE_TOL * float(np.abs(want).max()), err_msg=name)


def _models(**overrides):
    jcfg, tcfg = _configs(num_kv_heads=2, **overrides)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, params, device="cpu")


@pytest.mark.parametrize("impl", ["blocked", "dense"])
def test_reduced_granite_forward_matches_jax(impl):
    jcfg, tcfg, params, model = _models(attention_impl=impl)
    assert isinstance(model.layers[0].ffn, tmoe.MoE)
    tokens = next(SyntheticLMStream(jcfg.vocab_size, 64, 2, seed=0))["tokens"]
    want = np.asarray(jax.jit(jtr.forward, static_argnums=1)(
        params, jcfg, {"tokens": jnp.asarray(tokens)}))
    with torch.inference_mode():
        got = ttr.forward(model, tcfg, {"tokens": tokens}).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGITS_F32_TOL, atol=LOGITS_F32_TOL)


def test_reduced_granite_decode_matches_jax_token_by_token():
    jcfg, tcfg, params, model = _models()
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 6), dtype=np.int32)
    jstate = jtr.init_decode_state(jcfg, 3, 8, cache_dtype=jnp.float32)
    tstate = ttr.init_decode_state(tcfg, 3, 8, cache_dtype=torch.float32, device="cpu")
    decode = tzoo.make_decode_fn(tcfg, device="cpu")
    jdecode = jax.jit(jtr.decode_step, static_argnums=1)
    for t in range(6):
        want, jstate = jdecode(params, jcfg, jnp.asarray(toks[:, t]), jstate)
        got, tstate = decode(model, toks[:, t], tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGITS_F32_TOL,
                                   atol=LOGITS_F32_TOL)
    np.testing.assert_allclose(tstate["k"].numpy(), np.asarray(jstate["k"]), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tstate["v"].numpy(), np.asarray(jstate["v"]), rtol=F32_TOL,
                               atol=F32_TOL)
