"""The training path on the card: the flash kernels' log-sum-exp, gradients
through the blocked attention, a reduced MoE train step against the CPU,
and a reduced ``train()`` with injected faults and a resume.

Needs an NVIDIA GPU; skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py

Tolerances:

* the kernels' lse against the plain version's on the same inputs: 1e-4
  absolute and relative (float32 sums of the same bf16 or float32
  products, in another order, and ``ex2.approx``); the output with lse
  asked for bit for bit the output without it;
* gradients through ``blocked_attention`` (kernel forward, plain backward)
  against autograd through the plain dense attention in float32 on the same
  inputs, ``||got - want|| / ||want||`` per gradient: 1e-4 for float32
  inputs, 2e-2 for bf16 (each side rounds scores, probabilities and
  products to bf16 at 2^-9 of each element);
* a reduced granite-moe-1b-a400m config, 3 AdamW steps with 2 microbatches
  in float32 on the card and on the CPU, the bf16 cotangent fence out of
  both: losses and gradient norms within 1e-4 relative, every parameter
  leaf within 1e-4 in norm (TF32 off);
* the same config as full-width training runs it (bf16 compute, the fence
  in, MoE routing, remat "full"), one SGD step at lr 1 on the card and on
  the CPU: each leaf's update within 0.25 in norm, and within 1e-1 of the
  leaf's largest update on all but 3% of its elements; the card's update no
  farther from the float32 config's than 1.25 x the CPU's.  bf16 rounds the
  router's logits differently on each side, so near-tied top-k choices flip
  and a few tokens take another expert: measured on the card (this test's
  shape and chip_smoke.py's), 0.02-0.17 in norm, at most 1.4% of elements
  off, ratio <= 1.12, each side 0.03-0.25 from the float32 update.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.convert import tree_to_numpy
from repro_torch.data.lm_data import SyntheticLMStream
from repro_torch.kernels.flash_attention import kernel as fkmod
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW, init_adamw_state
from repro_torch.runtime.train_loop import TrainLoopConfig, train

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STEP_TOL = 1e-4
BF16_STEP_TOL = 0.25
BF16_STEP_ELEM = 1e-1  # of the leaf's largest update
BF16_STEP_FLIPS = 3e-2
BF16_F32_RATIO = 1.25


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, dtype, b, s, h, kvh, d, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.bfloat16, 32), (torch.float32, 64)])
@pytest.mark.parametrize("s", [1, 65, 200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_lse_matches_plain(cuda, dtype, d, s, causal):
    q, k, v = _qkv(cuda, dtype, 2, s, 4, 2, d, seed=s + d)
    _, want = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    routed = fkmod.variant_for(dtype, d)
    for variant in {routed, "mma"} if dtype == torch.bfloat16 else {routed}:
        before = fkmod.flash_attention_cuda.launches
        out, lse = fkmod.flash_attention_cuda(q, k, v, causal=causal, variant=variant,
                                              return_lse=True)
        assert fkmod.flash_attention_cuda.launches == before + 1
        assert lse.shape == (2, 4, s) and lse.dtype == torch.float32 and lse.is_contiguous()
        torch.testing.assert_close(lse, want, rtol=LSE_TOL, atol=LSE_TOL)
        plain_out = fkmod.flash_attention_cuda(q, k, v, causal=causal, variant=variant)
        assert torch.equal(out, plain_out), variant


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,kvh,causal", [(256, 4, 2, True), (300, 6, 1, True),
                                            (200, 4, 4, False)])
def test_blocked_attention_gradients_on_the_card(cuda, dtype, s, h, kvh, causal):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, dtype, 2, s, h, kvh, 64, seed=s))
    w = torch.randn((2, s, h, 64), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    before = fkmod.flash_attention_cuda.launches
    out = tattn.blocked_attention(q, k, v, causal, 128, 64)
    assert fkmod.flash_attention_cuda.launches == before + 1
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((tattn._dense_attention(*ref, causal=causal) * w).sum(), ref)
    for g, wnt, name in zip(got, want, "qkv"):
        assert g.dtype == dtype and g.shape == wnt.shape
        rel = float((g.float() - wnt).norm() / wnt.norm())
        assert rel <= GRAD_TOL[dtype], (name, rel)
    with pytest.raises(NotImplementedError, match="backward"):
        fkmod.flash_attention_cuda(q, k, v)  # the direct call has no backward


def test_reduced_moe_train_steps_match_the_cpu(cuda, monkeypatch):
    # The bf16 cotangent fence rounds to bf16, so a float32 difference of 1e-7
    # below it moves a gradient by a bf16 step; out of both sides here, as in
    # tests/test_torch_train.py, which holds the fence itself to JAX's.
    monkeypatch.setattr(ttr, "grad_fence_bf16", lambda x: x)
    cfg = reduced_config("granite-moe-1b-a400m", dtype=torch.float32, attention_impl="blocked")
    batches = [next(SyntheticLMStream(cfg.vocab_size, 64, 4, seed=i)) for i in range(3)]
    runs = {}
    for dev in ("cpu", cuda):
        state = init_adamw_state(tzoo.init_model(cfg, seed=0, device="cpu").to(dev), lr=1e-3)
        step = tzoo.make_train_step(cfg, AdamW(), num_microbatches=2, device=dev)
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({key: float(val) for key, val in m.items()})
        runs[str(dev)] = (metrics, tree_to_numpy(state))
    (cpu_m, cpu_s), (card_m, card_s) = runs["cpu"], runs[str(cuda)]
    for a, b in zip(card_m, cpu_m):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=STEP_TOL, err_msg=key)
    got, want = tree_to_numpy(card_s["params"]), cpu_s["params"]

    def walk(g, w, where=""):
        if isinstance(w, dict):
            for key in w:
                walk(g[key], w[key], f"{where}/{key}")
            return
        assert np.linalg.norm(g - w) <= STEP_TOL * np.linalg.norm(w), where

    walk(got, want)


def _leaves(tree: dict, where: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{where}/{key}")
        else:
            yield f"{where}/{key}", np.array(val, np.float32)  # a copy


def test_reduced_bf16_moe_train_step_matches_the_cpu(cuda):
    cfg = reduced_config("granite-moe-1b-a400m", attention_impl="blocked")
    batch = next(SyntheticLMStream(cfg.vocab_size, 64, 4, seed=3))
    updates = {}
    for label, step_cfg, dev in (("card", cfg, cuda), ("cpu", cfg, "cpu"),
                                 ("f32", dataclasses.replace(cfg, dtype=torch.float32), "cpu")):
        model = tzoo.init_model(cfg, seed=0, device="cpu").to(dev)
        before = dict(_leaves(tree_to_numpy(model)))
        launched = fkmod.flash_attention_cuda.launches
        state, _ = tzoo.make_train_step(step_cfg, None, device=dev)(
            {"params": model, "lr": 1.0}, batch)
        if label == "card":  # each layer's forward and its "full" recompute
            assert fkmod.flash_attention_cuda.launches - launched == 2 * cfg.num_layers
        updates[label] = {k: v - before[k] for k, v in _leaves(tree_to_numpy(state["params"]))}
    for key, want in updates["cpu"].items():
        got, f32 = updates["card"][key], updates["f32"][key]
        diff = np.abs(got - want)
        assert np.linalg.norm(diff) <= BF16_STEP_TOL * np.linalg.norm(want), key
        assert (diff > BF16_STEP_ELEM * np.abs(want).max()).mean() <= BF16_STEP_FLIPS, key
        assert np.linalg.norm(got - f32) <= BF16_F32_RATIO * np.linalg.norm(want - f32), key


def test_reduced_train_loop_on_the_card_survives_faults_and_resumes(cuda, tmp_path):
    """tests/test_runtime.py's faults on the card: step 3 fails twice (replayed
    from the live state), step 7 once more than the retries allow (restored
    from step 5's checkpoint); a second loop resumes from step 10."""
    cfg = reduced_config("granite-moe-1b-a400m", num_layers=2)
    mk = lambda: SyntheticLMStream(cfg.vocab_size, 32, 4)  # noqa: E731
    faults = {"n": 0}

    def fault_hook(step):
        if step == 3 and faults["n"] < 2:
            faults["n"] += 1
            raise RuntimeError("injected preemption")
        if step == 7 and faults["n"] == 2:
            faults["n"] += 1
            raise RuntimeError("injected node loss")

    loop = lambda n: TrainLoopConfig(total_steps=n, log_every=1, save_every=5,  # noqa: E731
                                     max_step_retries=2, checkpoint_dir=str(tmp_path))
    first = train(cfg, loop(10), stream=mk(), fault_hook=fault_hook, device=cuda)
    assert faults["n"] == 3 and int(first["state"]["step"]) == 10
    assert first["state"]["params"].embed.device.type == "cuda"
    second = train(cfg, loop(15), stream=mk(), device=cuda)
    assert second["resumed_from"] == 10 and int(second["state"]["step"]) == 15
    assert all(np.isfinite(h["loss"]) for h in first["history"] + second["history"])
