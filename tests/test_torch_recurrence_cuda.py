"""The CUDA recurrence kernels (``csrc/recurrence.cu``) against their plain
PyTorch versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels are built with nvcc
on first use); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_recurrence_cuda.py

The cases are chip_smoke.py's phase 17 (a): S in {1, 2, 63, 64, 65, 129,
1000} (the kernels stage 32 steps at a time), B in {1, 3}, H in {1, 5, 40},
contiguous inputs and strided views of one projection.  Each output within
1e-4 of the largest |plain| of its (b, h): float32 sums in another order,
over up to 1000 steps of a decaying state.  Two launches bit for bit equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.recurrence import kernel as rkernel
from repro_torch.kernels.recurrence import ops as rops
from repro_torch.kernels.recurrence.ref import ssd_scan_ref, wkv6_scan_ref

pytestmark = pytest.mark.cuda

TOL = 1e-4
SEQS = [1, 2, 63, 64, 65, 129, 1000]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _per_head_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """|got - want| <= TOL * max |want| over each (b, h) of (B, S, H, 64)."""
    scale = want.abs().amax(dim=(1, 3), keepdim=True).clamp_min(1e-30)
    err = float(((got - want).abs() / scale).max())
    assert err <= TOL, err


def wkv_inputs(b, s, h, dev, *, strided: bool, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:  # r, k, v, w as column slices of one fused projection
        fused = torch.randn((b, s, 4 * h * 64 + 32), generator=gen, device=dev)
        r, k, v, w = (fused[..., i * h * 64:(i + 1) * h * 64].view(b, s, h, 64)
                      for i in range(4))
    else:
        r, k, v, w = (torch.randn((b, s, h, 64), generator=gen, device=dev) for _ in range(4))
    w = torch.exp(-torch.exp(w.clamp(max=0.5) - 3.0))
    u = 0.1 * torch.randn((h, 64), generator=gen, device=dev)
    return r, k, v, w, u


def ssd_inputs(b, s, h, dev, *, strided: bool, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:  # dtx, b, c as slices of one conv output
        conv = torch.randn((b, s, h * 64 + 2 * 64), generator=gen, device=dev)
        dtx = conv[..., :h * 64].view(b, s, h, 64)
        bm, cm = conv[..., h * 64:h * 64 + 64], conv[..., h * 64 + 64:]
    else:
        dtx = torch.randn((b, s, h, 64), generator=gen, device=dev)
        bm, cm = (torch.randn((b, s, 64), generator=gen, device=dev) for _ in range(2))
    decay = torch.exp(-2.0 * torch.rand((b, s, h), generator=gen, device=dev))
    return decay, dtx, bm, cm


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", SEQS)
def test_wkv6_kernel_matches_plain(cuda, s, strided):
    for b, h in ((1, 1), (3, 5), (1, 40)):
        args = wkv_inputs(b, s, h, cuda, strided=strided, seed=s * 7 + h)
        before = rkernel.wkv6_scan_cuda.launches
        got = rops.wkv6_scan(*args)
        again = rkernel.wkv6_scan_cuda(*args)
        torch.cuda.synchronize()
        assert rkernel.wkv6_scan_cuda.launches == before + 2
        assert got.shape == (b, s, h, 64) and got.is_contiguous()
        _per_head_close(got, wkv6_scan_ref(*args))
        assert torch.equal(got, again)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", SEQS)
def test_ssd_kernel_matches_plain(cuda, s, strided):
    for b, h in ((1, 1), (3, 5), (1, 40)):
        args = ssd_inputs(b, s, h, cuda, strided=strided, seed=s * 5 + h)
        before = rkernel.ssd_scan_cuda.launches
        got = rops.ssd_scan(*args)
        again = rkernel.ssd_scan_cuda(*args)
        torch.cuda.synchronize()
        assert rkernel.ssd_scan_cuda.launches == before + 2
        _per_head_close(got, ssd_scan_ref(*args))
        assert torch.equal(got, again)


def test_kernels_refuse_what_they_do_not_take(cuda):
    r, k, v, w, u = wkv_inputs(1, 8, 2, cuda, strided=False, seed=0)
    with pytest.raises(NotImplementedError, match="no backward"):
        rkernel.wkv6_scan_cuda(r.requires_grad_(), k, v, w, u)
    with torch.no_grad():  # no graph is being built: the forward runs
        rkernel.wkv6_scan_cuda(r, k, v, w, u)
    r = r.detach()
    with pytest.raises(ValueError, match="contiguous last"):
        rkernel.wkv6_scan_cuda(r.transpose(2, 3), k, v, w, u)
    with pytest.raises(TypeError, match="float32"):
        rkernel.wkv6_scan_cuda(r.bfloat16(), k, v, w, u)
    decay, dtx, bm, cm = ssd_inputs(1, 8, 2, cuda, strided=False, seed=0)
    with pytest.raises(ValueError, match="built for 64"):
        rkernel.ssd_scan_cuda(decay, dtx, bm[..., :32], cm[..., :32])
    with pytest.raises(NotImplementedError, match="no backward"):
        rkernel.ssd_scan_cuda(decay, dtx.requires_grad_(), bm, cm)


def test_a_failed_library_load_raises(cuda, monkeypatch):
    """No plain version stands in for a kernel that does not load."""
    def broken(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(build, "load", broken)
    args = wkv_inputs(1, 4, 1, cuda, strided=False, seed=1)
    before = rkernel.wkv6_scan_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rops.wkv6_scan(*args)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rops.ssd_scan(*ssd_inputs(1, 4, 1, cuda, strided=False, seed=1))
    assert rkernel.wkv6_scan_cuda.launches == before
