"""The CUDA recurrence kernels (``csrc/recurrence.cu``) and their backward
kernels (``csrc/recurrence_bwd.cu``) against their plain PyTorch versions,
on the card.

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

The backward kernels are held over the same grid (chip_smoke.py's phase 18
(a)) against autograd through the plain step loops (``ref.wkv6_scan_bwd_ref``
and ``ssd_scan_bwd_ref``), against a cotangent dy drawn from the seed: every
gradient within 1e-4 of its (b, h)'s largest |plain| (du: of each head's;
the SSD's per-head dbm and dcm, summed over the heads, of each sequence's),
two launches bit for bit equal, and the inputs they do not take refused;
also their grid's edges (lengths ending inside an odd number of chunks, H =
1 and B = 1) and its residency at the training shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.recurrence import kernel as rkernel
from repro_torch.kernels.recurrence import ops as rops
from repro_torch.kernels.recurrence.draws import ssd_inputs, wkv_inputs
from repro_torch.kernels.recurrence.ref import (
    ssd_scan_bwd_ref,
    ssd_scan_ref,
    wkv6_scan_bwd_ref,
    wkv6_scan_ref,
)

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
        r, k, v, w, u = args
        before = rkernel.wkv6_scan_cuda.launches
        got = rops.wkv6_scan_logw(r, k, v, torch.log(w), u)
        again = rkernel.wkv6_scan_cuda(r, k, v, torch.exp(torch.log(w)), u)
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
        decay, dtx, bm, cm = args
        before = rkernel.ssd_scan_cuda.launches
        got = rops.ssd_scan_logdec(torch.log(decay), dtx, bm, cm)
        again = rkernel.ssd_scan_cuda(torch.exp(torch.log(decay)), dtx, bm, cm)
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
    """Layouts and dtypes the kernels do not take raise; inputs that require
    grad run (the autograd functions of ``ops`` pair each forward kernel with
    its backward kernel: their gradients against the plain version's)."""
    r, k, v, w, u = wkv_inputs(1, 8, 2, cuda, strided=False, seed=0)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, torch.log(w), u)]
    before = rkernel.wkv6_scan_bwd_cuda.launches
    dy = torch.randn((1, 8, 2, 64), device=cuda)
    got = torch.autograd.grad(rops.wkv6_scan_logw(*leaves), leaves, dy)
    assert rkernel.wkv6_scan_bwd_cuda.launches == before + 1
    for g, want in zip(got, wkv6_scan_bwd_ref(r, k, v, w, u, dy)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="contiguous last"):
        rkernel.wkv6_scan_cuda(r.transpose(2, 3), k, v, w, u)
    with pytest.raises(TypeError, match="float32"):
        rkernel.wkv6_scan_cuda(r.bfloat16(), k, v, w, u)
    decay, dtx, bm, cm = ssd_inputs(1, 8, 2, cuda, strided=False, seed=0)
    with pytest.raises(ValueError, match="built for 64"):
        rkernel.ssd_scan_cuda(decay, dtx, bm[..., :32], cm[..., :32])
    leaves = [t.clone().requires_grad_() for t in (torch.log(decay), dtx, bm, cm)]
    before = rkernel.ssd_scan_bwd_cuda.launches
    got = torch.autograd.grad(rops.ssd_scan_logdec(*leaves), leaves, dy)
    assert rkernel.ssd_scan_bwd_cuda.launches == before + 1
    for g, want in zip(got, ssd_scan_bwd_ref(decay, dtx, bm, cm, dy)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4)


def test_a_failed_library_load_raises(cuda, monkeypatch):
    """No plain version stands in for a kernel that does not load."""
    def broken(name):
        raise RuntimeError(f"nvcc failed building {name}")

    monkeypatch.setattr(build, "load", broken)
    r, k, v, w, u = wkv_inputs(1, 4, 1, cuda, strided=False, seed=1)
    decay, dtx, bm, cm = ssd_inputs(1, 4, 1, cuda, strided=False, seed=1)
    before = rkernel.wkv6_scan_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rops.wkv6_scan_logw(r, k, v, torch.log(w), u)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rops.ssd_scan_logdec(torch.log(decay), dtx, bm, cm)
    assert rkernel.wkv6_scan_cuda.launches == before


# -- the backward kernels --------------------------------------------------


def _dy(b, s, h, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randn((b, s, h, 64), generator=gen, device=dev)


def _scaled_error(got: torch.Tensor, want: torch.Tensor, dims) -> float:
    scale = want.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max()) if want.numel() else 0.0


def _bwd_check(kind: str, args, dy) -> None:
    """The backward kernel against its plain version, and a repeat bit for bit."""
    if kind == "wkv6":
        kernel, plain = rkernel.wkv6_scan_bwd_cuda, wkv6_scan_bwd_ref
    else:
        kernel, plain = rkernel.ssd_scan_bwd_cuda, ssd_scan_bwd_ref
    before = kernel.launches
    got, again = kernel(*args, dy), kernel(*args, dy)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = plain(*args, dy)
    if kind == "ssd":  # the shared b and c: each head's share, summed over the heads
        got = (got[0], got[1], got[2].sum(2), got[3].sum(2))
        dims = [(1,), (1, 3), (1, 2), (1, 2)]
    else:
        dims = [(1, 3)] * 4 + [(1,)]
    for i, (g, w, d) in enumerate(zip(got, want, dims)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), (kind, i)
        err = _scaled_error(g, w, d)
        assert err <= TOL, (kind, i, err)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_backward_kernels_match_plain(cuda, kind, s, strided):
    make = wkv_inputs if kind == "wkv6" else ssd_inputs
    for b, h in ((1, 1), (3, 5), (1, 40)):
        args = make(b, s, h, cuda, strided=strided, seed=s * 3 + h)
        _bwd_check(kind, args, _dy(b, s, h, cuda, s))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("decay", DECAYS)
def test_backward_kernels_hold_strong_unit_and_spike_decays(cuda, decay, layout):
    """Exactly-0 decays give finite gradients equal to the plain version's:
    the gradients of the decays are taken in their log, nothing divides."""
    for b, s, h in ((1, 65, 5), (3, 1000, 40)):
        kw = dict(strided=layout == "strided", misaligned=layout == "misaligned", decay=decay)
        for kind, make in (("wkv6", wkv_inputs), ("ssd", ssd_inputs)):
            args = make(b, s, h, cuda, seed=s + h, **kw)
            _bwd_check(kind, args, _dy(b, s, h, cuda, s + h))


@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
@pytest.mark.parametrize("s", [81, 145])
@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_backward_kernels_on_their_grid_edges(cuda, kind, s, layout):
    """Each (b, h) runs on two CTAs, each half of the state's key dimension,
    the chunks staged a chunk ahead in two buffers: lengths that end inside
    a chunk after an odd number of chunks (3 and 5), H = 1 and B = 1 beside
    B = 2, H = 3, in every layout; against the plain version and a repeat,
    bit for bit."""
    make = wkv_inputs if kind == "wkv6" else ssd_inputs
    for b, h in ((1, 1), (2, 3)):
        args = make(b, s, h, cuda, strided=layout == "strided",
                    misaligned=layout == "misaligned", seed=s + 7 * h + b)
        _bwd_check(kind, args, _dy(b, s, h, cuda, s + b))


def test_backward_grid_is_one_wave_at_the_training_shapes(cuda):
    """Two CTAs a (b, h), at most two an SM: 160 CTAs at rwkv6-3b's B = 2,
    H = 40 and 256 at zamba2-1.2b's H = 64, all resident at once."""
    for kind, h in (("wkv6", 40), ("ssd", 64)):
        grid = rkernel.bwd_grid(kind, 2, h)
        assert grid["ctas"] == 4 * h and grid["threads"] == 256
        assert grid["per_sm"] >= 2 and grid["smem_bytes"] <= 113 * 1024
        assert grid["one_wave"], grid


def test_backward_kernels_refuse_what_they_do_not_take(cuda):
    r, k, v, w, u = wkv_inputs(1, 8, 2, cuda, strided=False, seed=0)
    dy = _dy(1, 8, 2, cuda, 0)
    with pytest.raises(ValueError, match="dy must be"):
        rkernel.wkv6_scan_bwd_cuda(r, k, v, w, u, dy[:, :4])
    with pytest.raises(TypeError, match="float32"):
        rkernel.wkv6_scan_bwd_cuda(r, k, v, w, u, dy.double())
    with pytest.raises(ValueError, match="CUDA"):
        rkernel.wkv6_scan_bwd_cuda(r, k, v, w, u, dy.cpu())
    decay, dtx, bm, cm = ssd_inputs(1, 8, 2, cuda, strided=False, seed=0)
    with pytest.raises(ValueError, match="built for 64"):
        rkernel.ssd_scan_bwd_cuda(decay, dtx, bm[..., :32], cm[..., :32], dy)
    with pytest.raises(ValueError, match="contiguous last"):
        rkernel.ssd_scan_bwd_cuda(decay, dtx.transpose(2, 3), bm, cm, dy)
