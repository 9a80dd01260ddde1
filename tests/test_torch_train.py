"""The port's training path against the JAX package's, on the CPU: the loss,
the bf16 cotangent fence, the flash plain version's log-sum-exp, the blocked
attention's recomputing backward, the train step and the remat policies.

Weights come from JAX ``init_model`` (carried over by
``repro_torch.convert``) and inputs are drawn with numpy from a seed.
Tolerances:

* float32 loss and its gradient: 1e-5 (one float32 reduction in another order);
* the log-sum-exp against JAX's ``_blocked_fwd_impl``: 2e-5, as
  ``tests/test_attention.py`` holds the blocked forward;
* blocked-attention gradients: 2e-4, as ``tests/test_attention.py:41``;
* float32 train steps (loss and gradient norm 1e-4 relative; parameters,
  AdamW moments after two steps: ``||port - jax|| / ||jax||`` per leaf
  within 1e-4), with the bf16 cotangent fence out of both sides (it is not
  float32 arithmetic; its own test holds it exactly);
* with the int8 compressor, one step: loss, gradient norm and parameters as
  above; the moments within 1e-4 of each leaf's largest magnitude, and the
  error-feedback buffer within 1e-2 of its own (it is the rounding residue,
  1/254 of the gradient's range, and carries the gradient's float32
  difference whole), on all but 0.1% of the elements: those that one side
  rounded to the neighbouring int8 step, as a float32 difference of 1e-7
  can move an element across a rounding boundary (measured: 3e-5 of them);
* bf16 train steps (``cast_params_bf16`` with ``dtype=bfloat16``, SGD): the
  loss within 2e-2 relative, and the update the two steps made to each
  parameter within 5e-2 in norm (bf16 keeps 8 bits, and the two frameworks
  round at different places, as ``tests/test_torch_models.py`` says of
  ``BF16_SCALE_TOL``).  In the MoE family, where bf16 rounding of the
  router's logits flips top-k choices that are near ties, so that a few
  tokens take another expert in each framework: each update within 0.15 in
  norm, and elementwise within 1e-1 of the leaf's largest update on all but
  2% of its elements (measured: 0.108 and 0.78%, the bf16 cotangent fence
  in; JAX's own bf16 update lies 0.07-0.10 from its float32 one, the
  port's 0.03-0.05).  Not AdamW: its first steps scale every element to
  about lr whatever its size, so bf16 noise on a small gradient moves its
  parameter by a full step;
* the three remat policies: gradients within 1e-6 of one another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import init_adamw_state as jinit_adamw
from repro.optim.grad_compress import Int8ErrorFeedback as JInt8
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy, tree_to_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW, Int8ErrorFeedback, init_adamw_state
from repro_torch.tree import tree_leaves

LOSS_TOL = 1e-5
LSE_TOL = 2e-5
GRAD_TOL = 2e-4  # tests/test_attention.py:41
STEP_TOL = 1e-4
BF16_LOSS_TOL = 2e-2
BF16_UPDATE_TOL = 5e-2
BF16_MOE_UPDATE_TOL = 0.15
BF16_MOE_STEP = 1e-1  # of the leaf's largest update
BF16_MOE_FLIPS = 2e-2
INT8_FLIPS = 1e-3
EF_TOL = 1e-2


def test_cross_entropy_loss_matches_jax_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, 6] = -100
    want = jtr.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    jgrad = jax.grad(lambda lg: jtr.cross_entropy_loss(lg, jnp.asarray(labels)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = ttr.cross_entropy_loss(lt, labels)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    (grad,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=LOSS_TOL, atol=1e-7)
    assert float(grad[0, :4].abs().max()) == 0.0  # ignored rows take no gradient
    everything_ignored = ttr.cross_entropy_loss(lt, np.full((3, 7), -100))
    assert float(everything_ignored) == 0.0  # divides by max(#valid, 1)


def test_grad_fence_bf16_rounds_the_cotangent_like_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(64).astype(np.float32)
    g = (rng.standard_normal(64) * 1.2345).astype(np.float32)
    _, vjp = jax.vjp(jlayers.grad_fence_bf16, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tlayers.grad_fence_bf16(xt)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), g)  # the fence did round


def _qkv(b, s, h, kvh, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kvh", [(96, 4, 2), (70, 6, 1)])
def test_plain_lse_matches_jax_blocked_forward(causal, s, h, kvh):
    q, k, v = _qkv(2, s, h, kvh, 16, seed=s + h)
    jout, jlse = jattn._blocked_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                         32, 48)
    nq, b, _, bq = jlse.shape
    want = np.asarray(jlse).transpose(1, 2, 0, 3).reshape(b, h, nq * bq)[:, :, :s]
    out, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                     return_lse=True)
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=LSE_TOL, atol=LSE_TOL)
    np.testing.assert_array_equal(
        out.numpy(), flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                           causal=causal).numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,kvh,bq,bkv", [(64, 4, 2, 16, 32), (70, 6, 1, 32, 32),
                                             (96, 4, 4, 32, 48)])
def test_blocked_attention_gradients_match_jax_custom_vjp(causal, s, h, kvh, bq, bkv):
    q, k, v = _qkv(2, s, h, kvh, 16, seed=3 + s)
    w = np.random.default_rng(9).standard_normal((2, s, h, 16)).astype(np.float32)

    def jloss(q, k, v):
        return (jattn._blocked_attention(q, k, v, causal, bq, bkv) * jnp.asarray(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.blocked_attention(*ts, causal, bq, bkv)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wnt, name in zip(got, want, "qkv"):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    # and against autograd through the dense path
    dense = torch.autograd.grad((tattn._dense_attention(*ts, causal=causal)
                                 * torch.from_numpy(w)).sum(), ts)
    for g, d in zip(got, dense):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_blocked_attention_saves_nothing_of_s2_size():
    """The counterpart of tests/test_attention.py::test_blocked_vjp_no_s2_residuals:
    every tensor autograd saves through a blocked attention layer is far
    below S x S (and the dense path's would not be)."""
    s = 512
    jcfg = jreg.reduced_config("internlm2-1.8b", dtype=jnp.float32)
    tcfg = treg.reduced_config("internlm2-1.8b", dtype=torch.float32, attention_block_q=128,
                               attention_block_kv=128)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in jattn.init_attention(jax.random.PRNGKey(0), jcfg).items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, s, tcfg.d_model))
                         .astype(np.float32)).requires_grad_()
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    for impl in ("blocked", "dense"):
        sizes.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tattn.attention(params, tcfg, x, impl=impl)
        biggest = max(sizes)
        if impl == "blocked":
            assert biggest < s * s, f"S^2-scale residual saved: {biggest} elements"
            grads = torch.autograd.grad(out.square().sum(), [x, *params.values()])
            assert all(torch.isfinite(g).all() for g in grads)
        else:
            assert biggest >= s * s  # the check can see an S^2 residual


# -- the train step --------------------------------------------------------

TRAIN_CASES = {
    # id: (arch, optimizer, microbatches, cast_params_bf16, compute dtype, compressor)
    "internlm2-sgd-mb1": ("internlm2-1.8b", "sgd", 1, False, "float32", False),
    "internlm2-adamw-mb2": ("internlm2-1.8b", "adamw", 2, True, "float32", False),
    "internlm2-sgd-mb2-bf16cast": ("internlm2-1.8b", "sgd", 2, True, "bfloat16", False),
    "granite-moe-adamw-mb1": ("granite-moe-1b-a400m", "adamw", 1, False, "float32", False),
    "granite-moe-adamw-mb2-int8ef": ("granite-moe-1b-a400m", "adamw", 2, True, "float32", True),
    "granite-moe-sgd-mb1-bf16cast": ("granite-moe-1b-a400m", "sgd", 1, True, "bfloat16", False),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close_tree(got: dict, want: dict, tol: float, flips: float = 0.0, where: str = "") -> None:
    """Each leaf within ``tol`` of ``want``: ``||got - want|| / ||want||``.
    With ``flips`` > 0, instead elementwise within ``tol`` of the leaf's
    largest magnitude on all but that share of its elements."""
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], tol, flips, f"{where}/{k}")
        return
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    if flips:
        off = np.abs(got - want) > tol * float(np.abs(want).max())
        assert off.mean() <= flips, (where, int(off.sum()), off.size)
    else:
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        assert rel <= tol, (where, rel)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case, monkeypatch):
    arch, opt, n_mb, cast, dtype, compress = TRAIN_CASES[case]
    jdt, tdt = DTYPES[dtype]
    if dtype == "float32":
        # The fence rounds cotangents to bf16, so a float32 difference of
        # 1e-7 can move a gradient below it by a bf16 step (2^-8); its own
        # test above holds it to JAX's.  Out of both sides here.
        monkeypatch.setattr(jtr, "grad_fence_bf16", lambda x: x)
        monkeypatch.setattr(ttr, "grad_fence_bf16", lambda x: x)
    over = dict(num_layers=2, attention_impl="blocked")
    jcfg = jreg.reduced_config(arch, dtype=jdt, **over)
    tcfg = treg.reduced_config(arch, dtype=tdt, **over)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(1)))
    stream = SyntheticLMStream(jcfg.vocab_size, 32, 4, seed=2)
    # One step with the compressor: AdamW normalises each dequantised element,
    # so an element that one side rounds to 0 and the other to one int8 step
    # moves by lr, and a second step's gradients would carry that; the
    # compressor's own arithmetic is held exactly in test_torch_optim.py.
    batches = [next(stream) for _ in range(1 if compress else 2)]
    if opt == "sgd":
        jopt = topt = None
        jstate = {"params": params, "lr": jnp.asarray(0.05, jnp.float32)}
        tstate = {"params": lm_params_from_numpy(tcfg, params, device="cpu"),
                  "lr": torch.tensor(0.05)}
    else:
        jopt = JAdamW(compressor=JInt8() if compress else None)
        topt = AdamW(compressor=Int8ErrorFeedback() if compress else None)
        jstate = jinit_adamw(params, lr=1e-2)
        tstate = train_state_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, jstate),
                                        device="cpu")
    jstep = jax.jit(jzoo.make_train_step(jcfg, jopt, num_microbatches=n_mb,
                                         cast_params_bf16=cast))
    tstep = tzoo.make_train_step(tcfg, topt, num_microbatches=n_mb, cast_params_bf16=cast,
                                 device="cpu")
    bf16 = dtype == "bfloat16"
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for key in jm:
            tol = BF16_LOSS_TOL if bf16 else STEP_TOL
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=tol, err_msg=key)
    want = jax.tree_util.tree_map(np.asarray, jstate)
    got = tree_to_numpy(tstate)
    if bf16:  # held by the update the steps made, not by the weights' size
        delta = lambda t: jax.tree_util.tree_map(lambda a, b: a - b, t, params)  # noqa: E731
        if tcfg.is_moe:  # bf16 router logits flip near-tied top-k choices
            _close_tree(delta(got["params"]), delta(want["params"]), BF16_MOE_UPDATE_TOL)
            _close_tree(delta(got["params"]), delta(want["params"]), BF16_MOE_STEP,
                        flips=BF16_MOE_FLIPS)
        else:
            _close_tree(delta(got["params"]), delta(want["params"]), BF16_UPDATE_TOL)
    elif compress:
        _close_tree(got["params"], want["params"], STEP_TOL)
        _close_tree(got, {k: want[k] for k in ("m", "v")}, STEP_TOL, flips=INT8_FLIPS)
        _close_tree(got["ef_buffer"], want["ef_buffer"], EF_TOL, flips=INT8_FLIPS)
    else:
        _close_tree(got, want, STEP_TOL)
    if opt == "adamw":
        assert int(tstate["step"]) == len(batches) and tstate["step"].dtype == torch.int32


def test_train_step_refuses_weights_on_another_device():
    cfg = treg.reduced_config("internlm2-1.8b", num_layers=1)
    model = tzoo.init_model(cfg, seed=0, device="cpu")
    step = tzoo.make_train_step(cfg, None, device="cpu")
    batch = next(SyntheticLMStream(cfg.vocab_size, 8, 2))
    with pytest.raises(ValueError, match="train step runs on"):
        step({"params": model.to("meta"), "lr": 0.1}, batch)
    with pytest.raises(ValueError, match="multiple of 3"):
        tzoo.make_train_step(cfg, None, num_microbatches=3, device="cpu")(
            {"params": tzoo.init_model(cfg, seed=0, device="cpu"), "lr": 0.1}, batch)


def test_train_step_raises_before_updating_on_a_non_finite_loss():
    cfg = treg.reduced_config("granite-moe-1b-a400m", num_layers=1, dtype=torch.float32)
    state = init_adamw_state(tzoo.init_model(cfg, seed=0, device="cpu"), lr=1e-2)
    with torch.no_grad():
        state["params"].final_ln.weight.fill_(float("nan"))
    before = tree_to_numpy(state)
    step = tzoo.make_train_step(cfg, AdamW(), device="cpu")
    with pytest.raises(FloatingPointError):
        step(state, next(SyntheticLMStream(cfg.vocab_size, 8, 2)))
    after = tree_to_numpy(state)
    for a, b in zip(tree_leaves(before), tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_remat_policies_give_the_same_gradients(arch):
    base = treg.reduced_config(arch, num_layers=2, dtype=torch.float32, attention_impl="blocked")
    batch = next(SyntheticLMStream(base.vocab_size, 32, 2, seed=5))
    model = tzoo.init_model(base, seed=3, device="cpu")
    grads = {}
    for policy in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        loss = tzoo.make_loss_fn(cfg)(model, batch)
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
    for policy in ("dots", "full"):
        for a, b in zip(grads[policy], grads["none"]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
