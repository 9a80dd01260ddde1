"""The CUDA recurrence kernels (``csrc/recurrence.cu``) against their plain
PyTorch versions, on the card.

Needs an NVIDIA GPU with the CUDA toolkit (the kernels are built with nvcc
on first use); skipped elsewhere.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_recurrence_cuda.py

The cases are chip_smoke.py's phase 17 (a): S in {1, 2, 15, 16, 17, 31, 32,
33, 63, 64, 65, 129, 1000} (the chunked kernels cut 32-step chunks into
16-step sub-chunks), B in {1, 3}, H in {1, 5, 40}, contiguous inputs and
strided views of one projection; strong decays (some exactly 0), none and
one near-zero decay among mild ones; views that start 4 bytes into their
buffer (staged 4 bytes at a time).  Each output within 1e-4 of the largest
|plain| of its (b, h): float32 sums in another order, over up to 1000 steps
of a decaying state.  Two launches bit for bit equal.  The inputs are
drawn by ``kernels/recurrence/draws.py``, as phase 17 (a) draws them.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.recurrence import kernel as rkernel
from repro_torch.kernels.recurrence import ops as rops
from repro_torch.kernels.recurrence.draws import ssd_inputs, wkv_inputs
from repro_torch.kernels.recurrence.ref import ssd_scan_ref, wkv6_scan_ref

pytestmark = pytest.mark.cuda

TOL = 1e-4
SEQS = [1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 129, 1000]
DECAYS = ["strong", "unit", "spike"]
LAYOUTS = ["contiguous", "strided", "misaligned"]


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


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("decay", DECAYS)
def test_kernels_hold_strong_unit_and_spike_decays(cuda, decay, layout):
    """Exactly-0 decays, none, and one near-zero decay among mild ones, in
    contiguous, strided and misaligned views (the last staged 4 bytes at a
    time): every product of decays the chunks form is over one segment."""
    for b, s, h in ((1, 65, 5), (3, 1000, 40)):
        kw = dict(strided=layout == "strided", misaligned=layout == "misaligned", decay=decay)
        for kind, make, kernel, plain in (
                ("wkv6", wkv_inputs, rkernel.wkv6_scan_cuda, wkv6_scan_ref),
                ("ssd", ssd_inputs, rkernel.ssd_scan_cuda, ssd_scan_ref)):
            args = make(b, s, h, cuda, seed=s + h, **kw)
            if layout == "misaligned":
                assert args[1].data_ptr() % 16 == 4
            got, again = kernel(*args), kernel(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all()), (kind, b, s, h)
            _per_head_close(got, plain(*args))
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
