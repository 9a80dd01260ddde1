"""The port's optimiser, schedules and int8 error feedback against the JAX
package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides.
Tolerances: AdamW's parameters and moments over 3 steps at 1e-6 relative
(the same float32 operations, with ``pow`` in two libraries), the
schedules at 1e-6, int8 codes and scales equal and the error-feedback
buffers equal, element for element (the same float32 arithmetic, ``round``
half to even on both sides).  The descent and bias checks are
``tests/test_runtime.py``'s, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedules as jsched
from repro_torch.optim import (
    AdamW,
    Int8ErrorFeedback,
    dequantize_int8,
    global_norm,
    init_adamw_state,
    quantize_int8,
    warmup_cosine,
)
from repro_torch.optim import schedules as tsched

TOL = 1e-6


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((5, 4)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(7) * scale).astype(np.float32)}}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _assert_tree(got, want, tol=TOL):
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], tol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=tol, atol=tol)


@pytest.mark.parametrize("clip_norm,schedule", [(1.0, True), (1e9, False)])
def test_adamw_three_steps_match_jax(clip_norm, schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    sched = (jsched.warmup_cosine(2, 5), warmup_cosine(2, 5)) if schedule else (None, None)
    jopt = jadamw.AdamW(clip_norm=clip_norm, schedule=sched[0])
    topt = AdamW(clip_norm=clip_norm, schedule=sched[1])
    jstate = jadamw.init_adamw_state(_jax(params), lr=0.1)
    tstate = init_adamw_state(_torch(params), lr=0.1)
    assert tstate["step"].dtype == torch.int32 and tstate["lr"].dtype == torch.float32
    for _ in range(3):
        grads = _tree(rng, scale=3.0)
        jstate, jm = jopt.apply_gradients(jstate, _jax(grads))
        tstate, tm = topt.apply_gradients(tstate, _torch(grads))
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL)
        np.testing.assert_allclose(float(global_norm(_torch(grads))),
                                   float(jadamw.global_norm(_jax(grads))), rtol=TOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for key in ("params", "m", "v"):
        _assert_tree(tstate[key], jstate[key])


def test_adamw_descends_quadratic():
    """tests/test_runtime.py's quadratic, on the port's ``AdamW.step``."""
    opt = AdamW(weight_decay=0.0, clip_norm=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    state = init_adamw_state({"w": torch.zeros(3)}, lr=0.1)
    for _ in range(200):
        _, state, _ = opt.step(state, None, lambda p, batch: torch.sum((p["w"] - target) ** 2))
    torch.testing.assert_close(state["params"]["w"], target, atol=0.15, rtol=0)


def test_schedules_match_jax_step_by_step():
    for jf, tf in ((jsched.warmup_cosine(10, 100), warmup_cosine(10, 100)),
                   (jsched.warmup_cosine(3, 7, min_ratio=0.3), warmup_cosine(3, 7, min_ratio=0.3)),
                   (jsched.constant(), tsched.constant())):
        for step in range(0, 120):
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(jnp.asarray(step, jnp.int32))),
                                       rtol=TOL, atol=TOL)
    f = warmup_cosine(10, 100)
    assert float(f(torch.tensor(0))) == pytest.approx(0.0)
    assert float(f(torch.tensor(10))) == pytest.approx(1.0)
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)


def test_quantize_int8_matches_jax():
    x = np.random.default_rng(1).standard_normal(301).astype(np.float32) * 3
    x[7] = 0.5 * float(np.abs(x).max()) / 127.0 * 3  # a value on a rounding boundary's side
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))
    lin = torch.linspace(-3, 3, 301)
    q, s = quantize_int8(lin)
    assert float((dequantize_int8(q, s) - lin).abs().max()) <= float(s) * 0.5 + 1e-9


def test_int8_error_feedback_matches_jax_over_steps():
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jc, tc = jgc.Int8ErrorFeedback(), Int8ErrorFeedback()
    jstate = jc.init_state({"params": _jax(params)})
    tstate = tc.init_state({"params": _torch(params)})
    for _ in range(4):
        grads = _tree(rng, scale=1e-3)
        jg, jstate = jc.compress_tree(_jax(grads), jstate)
        tg, tstate = tc.compress_tree(_torch(grads), tstate)
        _assert_tree(tg, jg, tol=0)
        _assert_tree(tstate["ef_buffer"], jstate["ef_buffer"], tol=0)


def test_int8_error_feedback_shares_a_scale_across_a_layer_stack():
    """JAX holds a layer stack as one array, so one scale covers every
    layer's leaf of a name; the port's per-layer tensors share it."""
    rng = np.random.default_rng(3)
    layers = [(rng.standard_normal(6) * s).astype(np.float32) for s in (1.0, 100.0)]
    jg, _ = jgc.Int8ErrorFeedback().compress_tree(
        {"layers": {"w": jnp.asarray(np.stack(layers))}},
        {"params": {"layers": {"w": jnp.zeros((2, 6))}}})
    tg, _ = Int8ErrorFeedback().compress_tree(
        {"layers": [{"w": torch.from_numpy(a)} for a in layers]},
        {"params": {"layers": [{"w": torch.zeros(6)} for _ in layers]}})
    got = np.stack([d["w"].numpy() for d in tg["layers"]])
    np.testing.assert_array_equal(got, np.asarray(jg["layers"]["w"]))


def test_int8_error_feedback_reduces_bias():
    """tests/test_runtime.py's check, on the port."""
    g_true = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32)
                              * 1e-3)
    comp = Int8ErrorFeedback()
    state = comp.init_state({"params": {"w": torch.zeros(256)}})
    acc = torch.zeros(256)
    for _ in range(50):
        gc, state = comp.compress_tree({"w": g_true}, state)
        acc = acc + gc["w"]
    torch.testing.assert_close(acc, g_true * 50, rtol=0.05, atol=1e-4)
