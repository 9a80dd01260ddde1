"""Wrapper of the hand-written CUDA flash-attention kernel (``csrc/flash_attention.cu``).

``flash_attention_cuda`` launches the kernel that replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py:_kernel`` (line 24).  It
takes CUDA tensors only and checks device, dtype, shape, strides and
alignment, raising on anything the kernel does not take; there is no
fallback.  CPU tensors go to the plain version one level up, in
``ops.flash_attention``.

What bounds the kernel on the H100 is operations, not bytes: a causal
``(b, h)`` needs ``4 * D * S(S+1)/2`` flops against ``8 * S * D`` bytes of
q, k, v and o.  For bfloat16 both products run on the tensor cores
(``mma.sync``) and scores never leave registers; float32 runs on the CUDA
cores in full float32 (see the source's note).

``flash_attention_cuda.launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["HEAD_DIMS", "check_inputs", "flash_attention_cuda"]

HEAD_DIMS = (32, 64, 128)  # the kernel's instantiations
MAX_GRID_YZ = 65_535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The layout both paths take: q (B, S, H, D), k and v (B, S, KV, D), one dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k, v must be (B, S, H, D) and (B, S, KV, D); got shapes {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B={b}, S={s}, KV, D={d})"
        )
    kvh = k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn


def _launch(q, k, v, out, *, causal: bool) -> None:
    """Call the C entry point; raise if the launch is refused."""
    b, s, h, d = q.shape
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p),
            b, s, h, k.shape[2], d, int(causal), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = build.load("flash_attention").flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash-attention kernel launch failed: cudaError_t {err} ({msg})")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Launch the kernel; returns a contiguous ``(B, S, H, D)`` tensor in q's dtype.

    q is ``(B, S, H, D)``, k and v ``(B, S, KV, D)``, all float32 or all
    bfloat16 on one CUDA device, with a contiguous last dimension, the
    other strides multiples of 16 bytes and 16-byte aligned data.  The
    kernel runs on the current stream and is not synchronised.  There is no
    backward: inputs that require grad under grad mode are refused.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(
                f"flash_attention_cuda needs CUDA tensors, got {name} on {t.device}; "
                "CPU tensors take the plain version (ops.flash_attention)"
            )
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    check_inputs(q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}; the kernel takes float32 or bfloat16")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}; the kernel is built for {HEAD_DIMS}")
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ or s >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
        if any(st % align for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: strides {t.stride()} and data pointer must be 16-byte aligned"
            )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash-attention kernel has no backward yet")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, causal=causal)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
