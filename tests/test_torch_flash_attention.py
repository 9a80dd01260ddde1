"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.flash_attention``
runs the CUDA kernel's plain PyTorch version.  It is held against JAX
``flash_attention`` (the Pallas kernel in interpret mode) and JAX
``attention_ref`` over the cases of tests/test_flash_kernel.py, with its
tolerances: 2e-5 for float32, 3e-2 for bfloat16, and besides, each output
row within ROW_TOLS of its own norm (``max_row_error``), a limit that keeps
its meaning on rows whose outputs are smaller than 3e-2.  Inputs are drawn
with numpy from a seed and handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import attention as jattn
from repro_torch.configs import registry as treg
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref, max_row_error
from repro_torch.models import attention as tattn

F32_TOL = 2e-5
BF16_TOL = 3e-2
ROW_TOLS = {"float32": 1e-4, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _mk(b, s, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _head_major(x, h):
    """(B, S, KV, D) numpy -> (B*H, S, D) with KV heads repeated, as the JAX wrapper does."""
    b, s, kvh, d = x.shape
    x = np.repeat(x, h // kvh, axis=2)
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kvh,d,causal",
    [
        (2, 256, 2, 2, 32, True),
        (2, 256, 2, 2, 32, False),
        (2, 256, 4, 1, 32, True),
        (2, 256, 4, 1, 32, False),
        (1, 256, 4, 2, 64, True),
        (1, 200, 2, 2, 32, False),  # S not a multiple of the blocks
        (1, 200, 4, 2, 32, True),
    ],
)
def test_port_matches_pallas_kernel_and_ref(b, s, h, kvh, d, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    qn, kn, vn = _mk(b, s, h, kvh, d, seed=h + s)
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (qn, kn, vn)), causal=causal)
    assert got.shape == (b, s, h, d) and got.dtype == tdt

    jq, jk, jv = (jnp.asarray(x, jdt) for x in (qn, kn, vn))
    pallas = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_kv=128 if s % 128 == 0 else 64,
                       interpret=True)
    np.testing.assert_allclose(_to_np(got), np.asarray(pallas, np.float32), rtol=tol, atol=tol)
    assert max_row_error(got, torch.from_numpy(np.array(pallas, np.float32))) <= ROW_TOLS[dtype]

    want = jax_attention_ref(
        jnp.asarray(_head_major(qn, h), jdt).astype(jnp.float32),
        jnp.asarray(_head_major(kn, h), jdt).astype(jnp.float32),
        jnp.asarray(_head_major(vn, h), jdt).astype(jnp.float32),
        causal=causal,
    )
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_to_np(got), want, rtol=tol, atol=tol)
    assert max_row_error(got, torch.from_numpy(np.ascontiguousarray(want))) <= ROW_TOLS[dtype]


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref_and_chunks_exactly(causal):
    qn, kn, vn = (x[0].transpose(1, 0, 2) for x in _mk(1, 130, 3, 3, 16, seed=5))
    got = attention_ref(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (qn, kn, vn)),
                        causal=causal)
    want = jax_attention_ref(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    for chunk in (1, 7, 64, 130, 500):
        chunked = attention_ref(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (qn, kn, vn)),
            causal=causal, q_chunk=chunk)
        torch.testing.assert_close(chunked, got, rtol=1e-6, atol=1e-6)


def test_single_token_and_first_causal_row():
    """S = 1 attends to itself only; with causal masking the first row sees one key."""
    qn, kn, vn = _mk(2, 1, 4, 2, 32, seed=1)
    got = flash_attention(*(torch.from_numpy(x) for x in (qn, kn, vn)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.repeat(vn, 2, axis=2), rtol=1e-6, atol=1e-6)
    qn, kn, vn = _mk(1, 65, 2, 2, 32, seed=2)
    got = flash_attention(*(torch.from_numpy(x) for x in (qn, kn, vn)), causal=True)
    np.testing.assert_allclose(got.numpy()[:, 0], vn[:, 0], rtol=1e-6, atol=1e-6)
    assert np.isfinite(got.numpy()).all()


def test_plain_version_takes_strided_inputs():
    """The projections hand the kernel views; the plain version takes them too."""
    qn, kn, vn = _mk(1, 40, 4, 2, 32, seed=3)
    q = torch.from_numpy(qn)
    wide = torch.from_numpy(np.concatenate([kn, vn], axis=3))  # (B, S, KV, 2D)
    k, v = wide[..., :32], wide[..., 32:]
    got = flash_attention_plain(q, k, v, causal=True)
    want = flash_attention_plain(q, k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_layout_checks_raise():
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 8, 4, 2, 32, seed=4))
    with pytest.raises(ValueError, match="KV heads"):
        flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v[:, :, :1].expand(1, 8, 3, 32))
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, k.double(), v.double())
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize(
    "dtype,head_dim,variant",
    [
        (torch.bfloat16, 128, "wgmma"),  # the prefill's path
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 32, "mma"),
        (torch.float32, 128, "f32"),
        (torch.float32, 64, "f32"),
        (torch.float32, 32, "f32"),
    ],
)
def test_variant_for_routes_by_dtype_and_head_dim(dtype, head_dim, variant):
    assert tkernel.variant_for(dtype, head_dim) == variant


def test_variant_for_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tkernel.variant_for(torch.float16, 128)


# Cross-attention: S_q queries against S_kv keys, not causal (whisper's 448
# decoder positions against its encoder's frames, cut to CPU sizes).
CROSS_SHAPES = [(448 // 8, 1500 // 8), (1, 1000 // 8), (129, 64), (7, 300), (64, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,skv", CROSS_SHAPES)
def test_plain_version_takes_a_key_length_of_its_own(s, skv, dtype):
    """``flash_attention`` and ``attention_ref`` with S_kv != S_q against
    JAX's ``attention_ref`` (a materialised float32 softmax over every key)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + skv)
    b, h, kvh, d = 2, 4, 2, 32
    qn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, skv, kvh, d)).astype(np.float32) for _ in range(2))
    got = flash_attention(*(torch.from_numpy(x).to(tdt) for x in (qn, kn, vn)), causal=False)
    assert got.shape == (b, s, h, d) and got.dtype == tdt
    want = jax_attention_ref(*(jnp.asarray(_head_major(x, h), jdt).astype(jnp.float32)
                               for x in (qn, kn, vn)), causal=False)
    want = np.asarray(want).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_to_np(got), want, rtol=tol, atol=tol)
    assert max_row_error(got, torch.from_numpy(np.ascontiguousarray(want))) <= ROW_TOLS[dtype]
    ref = attention_ref(*(torch.from_numpy(np.ascontiguousarray(_head_major(x, h))).to(tdt)
                          .float() for x in (qn, kn, vn)), causal=False, q_chunk=5)
    np.testing.assert_allclose(ref.numpy().reshape(b, h, s, d).transpose(0, 2, 1, 3), want,
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("impl", ["blocked", "dense"])
@pytest.mark.parametrize("s,skv", [(12, 17), (56, 187), (1, 5)])
def test_attention_kv_override_matches_jax(s, skv, impl):
    """``attention(kv_override=compute_kv(enc), rope=False)``, whisper's
    cross-attention, against JAX's, float32 at 2e-5; and ``rope=True``
    with an override rotates q alone, as JAX's does."""
    jcfg = jreg.reduced_config("whisper-base", dtype=jnp.float32)
    tcfg = treg.reduced_config("whisper-base", dtype=torch.float32)
    params = {k: np.array(v) for k, v in jattn.init_attention(jax.random.PRNGKey(s), jcfg).items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(skv)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, skv, jcfg.d_model)).astype(np.float32)
    jkv = jattn.compute_kv(jp, jcfg, jnp.asarray(enc))
    tkv = tattn.compute_kv(tp, tcfg, torch.from_numpy(enc))
    for rope in (False, True):
        want = jattn.attention(jp, jcfg, jnp.asarray(x), causal=False, kv_override=jkv,
                               rope=rope, impl=impl)
        got = tattn.attention(tp, tcfg, torch.from_numpy(x), causal=False, kv_override=tkv,
                              rope=rope, impl=impl)
        np.testing.assert_allclose(_to_np(got), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_causal_call_with_another_key_length_raises():
    q = torch.zeros(1, 4, 2, 32)
    kv = torch.zeros(1, 6, 2, 32)
    with pytest.raises(ValueError, match="as many keys as queries"):
        flash_attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="as many keys as queries"):
        attention_ref(torch.zeros(2, 4, 32), torch.zeros(2, 6, 32), torch.zeros(2, 6, 32),
                      causal=True)
    with pytest.raises(ValueError, match="no keys"):
        flash_attention(q, kv[:, :0], kv[:, :0], causal=False)
