"""The CUDA flash-attention kernels against their plain PyTorch version, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels are built with nvcc
on first use); skipped elsewhere.  Imports no JAX, so it runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_cuda.py

Cases are chip_smoke.py's phase 6: S in {1, 63, 64, 65, 127, 129, 200,
1000}, causal and not, (H, KV) in {(4, 4), (4, 2), (4, 1), (16, 8)}, D in
{64, 128} (and 32), B in {1, 3}, through the kernel ``variant_for`` picks
(wgmma for bf16 at D 64 and 128, mma.sync at 32, the float32 kernel) and,
for bf16, through the mma.sync kernel too.  Each output row must lie
within ROW_TOLS of its own norm (``max_row_error``; chip_smoke.py's
FLASH_ROW_TOL says why), and each element within the JAX flash tests'
tolerances, 2e-5 for float32 and 3e-2 for bfloat16 (the kernels round
probabilities to bf16 for the second product; the plain version keeps them
in float32).  The row limit is the one that sees a fault in long rows,
whose outputs are smaller than 3e-2.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import max_row_error

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
ROW_TOLS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
HEADS = [(4, 4), (4, 2), (4, 1), (16, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, h, kvh, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _check(q, k, v, causal, variant=None):
    """One launch of ``variant`` (default: the routed kernel, through ``flash_attention``)."""
    expected = variant or tkernel.variant_for(q.dtype, q.shape[3])
    before = tkernel.flash_attention_cuda.launches
    before_variant = tkernel.flash_attention_cuda.launches_by_variant[expected]
    if variant is None:
        got = flash_attention(q, k, v, causal=causal)
    else:
        got = tkernel.flash_attention_cuda(q, k, v, causal=causal, variant=variant)
    torch.cuda.synchronize()
    assert tkernel.flash_attention_cuda.launches == before + 1
    assert tkernel.flash_attention_cuda.launches_by_variant[expected] == before_variant + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == q.dtype and got.is_contiguous()
    assert max_row_error(got, want) <= ROW_TOLS[q.dtype]
    tol = TOLS[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


SEQS = [1, 63, 64, 65, 127, 129, 200, 1000]  # 127, 129, 1000: S % 128 != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", SEQS)
def test_kernel_matches_plain_version(cuda, s, causal, dtype):
    for (h, kvh), d, b in itertools.product(HEADS, (32, 64, 128), (1, 3)):
        _check(*_qkv(b, s, h, kvh, d, dtype, cuda, seed=s + h + d), causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", SEQS)
def test_mma_kernel_matches_plain_version_at_wgmma_head_dims(cuda, s, causal):
    """The mma.sync kernel, which bf16 at D 64 and 128 no longer routes to."""
    for (h, kvh), d, b in itertools.product(HEADS, (64, 128), (1, 3)):
        _check(*_qkv(b, s, h, kvh, d, torch.bfloat16, cuda, seed=s + h + d), causal, "mma")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,variant", [(torch.float32, None), (torch.bfloat16, None),
                                           (torch.bfloat16, "mma")], ids=str)
def test_kernel_reads_strided_projections(cuda, dtype, variant, d):
    """q, k, v as views of one fused projection (strided rows), as a model may hand them."""
    b, s, h, kvh = 2, 300, 8, 2
    rng = np.random.default_rng(9)
    fused = torch.from_numpy(rng.standard_normal((b, s, h + 2 * kvh, d)).astype(np.float32))
    fused = fused.to(device=cuda, dtype=dtype)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]
    assert not q.is_contiguous()
    for causal in (True, False):
        _check(q, k, v, causal, variant)


def test_bf16_routes_to_the_wgmma_kernel(cuda):
    q, k, v = _qkv(2, 257, 16, 8, 128, torch.bfloat16, cuda)
    before = dict(tkernel.flash_attention_cuda.launches_by_variant)
    flash_attention(q, k, v, causal=True)
    after = tkernel.flash_attention_cuda.launches_by_variant
    assert {n: after[n] - before[n] for n in after} == {"wgmma": 1, "mma": 0, "f32": 0}


def test_refused_launch_and_bad_inputs_raise(cuda):
    q, k, v = _qkv(1, 70, 4, 2, 64, torch.bfloat16, cuda)
    out = torch.empty_like(q)
    # The C entry points refuse a head_dim they were not built for: the wrapper raises.
    bad = q[..., :48]
    for variant in ("wgmma", "mma"):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            tkernel._launch(bad, k[..., :48], v[..., :48], out[..., :48], causal=True,
                            variant=variant)
    with pytest.raises(ValueError, match="head_dim"):
        tkernel.flash_attention_cuda(*(t[..., :48].contiguous() for t in (q, k, v)))
    with pytest.raises(ValueError, match="variant"):
        tkernel.flash_attention_cuda(q.float(), k.float(), v.float(), variant="wgmma")
    with pytest.raises(ValueError, match="variant"):
        tkernel.flash_attention_cuda(*(t[..., :32].contiguous() for t in (q, k, v)),
                                     variant="wgmma")
    with pytest.raises(TypeError):
        tkernel.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous last"):
        columns = torch.zeros(1, 70, 64, 4, device=cuda, dtype=torch.bfloat16).transpose(2, 3)
        tkernel.flash_attention_cuda(columns, k, v)
    with pytest.raises(ValueError, match="aligned"):
        wide = torch.zeros(1, 70, 4, 72, device=cuda, dtype=torch.bfloat16)
        tkernel.flash_attention_cuda(wide[..., 4:68], k, v)
    with pytest.raises(NotImplementedError, match="backward"):
        tkernel.flash_attention_cuda(q.float().requires_grad_(), k.float(), v.float())
