"""Wrapper of the hand-written CUDA flash-attention kernels (``csrc/*.cu``).

``flash_attention_cuda`` launches a kernel that replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py:_kernel`` (line 24).  It
takes CUDA tensors only and checks device, dtype, shape, strides and
alignment, raising on anything the kernels do not take; there is no
fallback.  CPU tensors go to the plain version one level up, in
``ops.flash_attention``.

Three kernels, picked by ``variant_for(dtype, head_dim)`` and never by
whether a launch succeeds:

* ``"wgmma"``: bfloat16 at head_dim 64 or 128 (the prefill's path),
  ``csrc/flash_attention_sm90.cu``: TMA loads, a producer warp and wgmma;
* ``"mma"``: bfloat16 at head_dim 32, ``csrc/flash_attention.cu``
  (``mma.sync``);
* ``"f32"``: float32, ``csrc/flash_attention.cu`` on the CUDA cores.

What bounds the bf16 kernels on the H100 is operations, not bytes: a causal
``(b, h)`` needs ``4 * D * S(S+1)/2`` flops against ``8 * S * D`` bytes of
q, k, v and o.  Scores never leave registers (see the sources' notes).

Each kernel stores each row's log-sum-exp beside the output when the
caller asks for it (``return_lse``), for the recomputing backward of
``models.attention.blocked_attention``; otherwise it stores nothing more.

``flash_attention_cuda.launches`` counts the kernel launches of this
process, and ``flash_attention_cuda.launches_by_variant`` counts them per
variant.

**Custom ops.** The launch runs inside two ``torch.library.custom_op``s,
``repro_torch::flash_attention_fwd`` and ``repro_torch::flash_attention_fwd_lse``
(the same kernel storing each row's log-sum-exp too).  Each has the launch
as its CUDA implementation, a fake implementation that gives the outputs'
shapes only (``flash_attention_cuda`` takes ``meta`` tensors too and
reaches it with them, checks and all, launching nothing), and a
flop formula, ``attention_flops``: the two products' ``4 D`` flops for
each (query, key) pair the mask leaves.  So ``torch.utils.flop_counter`` and
``perf.op_cost`` read the kernel as one op, on meta tensors and on the card
alike, where a launch through ctypes alone would be invisible to them.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

__all__ = ["HEAD_DIMS", "QUERY_TILE", "VARIANTS", "WGMMA_HEAD_DIMS", "attention_flops",
           "check_inputs", "cta_rows", "flash_attention_cuda", "reset_launch_counts",
           "variant_for"]

HEAD_DIMS = (32, 64, 128)  # the head dims some kernel is built for
WGMMA_HEAD_DIMS = (64, 128)  # flash_attention_sm90.cu's instantiations
VARIANTS = ("wgmma", "mma", "f32")
MAX_GRID_YZ = 65_535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows per CTA: flash_attention_sm90.cu BM, flash_attention.cu BQ and F_BQ.
QUERY_TILE = {"wgmma": 128, "mma": 64, "f32": 64}


def cta_rows(batch: int, seq: int, heads: int, variant: str, causal: bool):
    """The launch grid of ``variant`` as its source decodes ``blockIdx``:
    yields ``(b, h, q0, q1)`` per CTA, the query rows ``[q0, q1)`` of head
    ``h`` of batch ``b`` whose output rows it stores.  ``wgmma``'s grid is
    1-D, ``(b, h)`` fastest; the others' is ``(query tile, h, b)``; a causal
    grid runs its tiles from the last."""
    tile = QUERY_TILE[variant]
    n_tiles = -(-seq // tile)
    for x in range(n_tiles * batch * heads):
        if variant == "wgmma":
            bh, qt = x % (batch * heads), x // (batch * heads)
            b, h = divmod(bh, heads)
        else:
            qt, rest = x % n_tiles, x // n_tiles
            h, b = rest % heads, rest // heads
        if causal:
            qt = n_tiles - 1 - qt
        yield b, h, qt * tile, min(seq, (qt + 1) * tile)


def variant_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes ``dtype`` at ``head_dim``: "wgmma", "mma" or "f32"."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma"
    raise TypeError(f"dtype {dtype}; the kernels take float32 or bfloat16")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> None:
    """The layout both paths take: q (B, S, H, D), k and v (B, S_kv, KV, D), one
    dtype.  A non-causal call may have S_kv != S (cross-attention, S_kv >= 1);
    a causal one needs S_kv = S."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k, v must be (B, S, H, D) and (B, S_kv, KV, D); got shapes {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    skv = k.shape[1]
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[3]) != (b, d):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be (B={b}, S_kv, KV, D={d})"
        )
    if causal and skv != s:
        raise ValueError(f"causal attention: k {tuple(k.shape)} and v must be (B={b}, S={s}, "
                         f"KV, D={d}), as many keys as queries")
    if skv < 1 and s > 0:
        raise ValueError("attention over no keys: S_kv = 0")
    kvh = k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


# variant -> library; ``<library>_launch`` takes the same arguments in each,
# flash_attention.cu's with an is_bf16 flag before the stream.
_LIBRARIES = {"wgmma": "flash_attention_sm90", "mma": "flash_attention", "f32": "flash_attention"}


def _library(variant: str) -> tuple[ctypes.CDLL, str]:
    name = _LIBRARIES[variant]
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        flags = [i] if name == "flash_attention" else []
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, *flags, p]
        fn.restype = ctypes.c_int
        err_string = getattr(lib, f"{name}_error_string")
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p
    return lib, name


def _launch(q, k, v, out, *, causal: bool, variant: str, lse: torch.Tensor | None = None) -> None:
    """Call the variant's C entry point; raise if the launch is refused.
    ``lse``, if given, is a contiguous float32 ``(B, H, S)`` tensor that takes
    each row's log-sum-exp."""
    b, s, h, d = q.shape
    skv = k.shape[1]
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib, name = _library(variant)
    flags = [_DTYPES[q.dtype]] if name == "flash_attention" else []
    with torch.cuda.device(q.device):
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), b, s,
            skv, h, k.shape[2], d, int(causal), *flags,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(
            f"flash-attention kernel ({variant}) launch failed: cudaError_t {err} ({msg})")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    variant: str | None = None,
    return_lse: bool = False,
):
    """Launch a kernel; returns a contiguous ``(B, S, H, D)`` tensor in q's dtype,
    and with ``return_lse`` also each row's log-sum-exp of the ``D^-0.5``-scaled
    scores, ``m + log(max(l, 1e-30))``, as a contiguous float32 ``(B, H, S)``
    tensor (the kernel stores it beside the output; without ``return_lse`` it
    stores nothing more).

    q is ``(B, S, H, D)``, k and v ``(B, S_kv, KV, D)`` (S_kv = S when
    causal; any S_kv >= 1 otherwise), all float32 or all
    bfloat16 on one CUDA device, with a contiguous last dimension, the
    other strides multiples of 16 bytes and 16-byte aligned data.  The
    kernel is ``variant_for(dtype, D)``; ``variant="mma"`` asks for the
    ``mma.sync`` kernel at any bf16 head dim instead (to hold it against
    the wgmma one).  It runs on the current stream and is not synchronised.
    The call has no backward: inputs that require grad under grad mode are
    refused; the differentiable path is ``models.attention.blocked_attention``.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(
                f"flash_attention_cuda needs CUDA (or meta) tensors, got {name} on {t.device}; "
                "CPU tensors take the plain version (ops.flash_attention)"
            )
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    check_inputs(q, k, v, causal=causal)
    b, s, h, d = q.shape
    routed = variant_for(q.dtype, d)
    if variant is None:
        variant = routed
    elif variant not in (routed, "mma") or (variant == "mma" and q.dtype != torch.bfloat16):
        raise ValueError(f"variant {variant!r} does not take {q.dtype} at head_dim {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}; the kernels are built for {HEAD_DIMS}")
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ or s >= 2**31 or k.shape[1] >= 2**31:
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
        raise NotImplementedError(
            "flash_attention_cuda has no backward: differentiate through "
            "repro_torch.models.attention.blocked_attention")
    return _call_op(q, k, v, causal, variant, return_lse)


def _call_op(q, k, v, causal: bool, variant: str, return_lse: bool):
    if return_lse:
        return tuple(torch.ops.repro_torch.flash_attention_fwd_lse(q, k, v, causal, variant))
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, variant)


def _run(q, k, v, causal: bool, variant: str, return_lse: bool):
    """Allocate the outputs and launch (the custom ops' CUDA implementation)."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() != 0:
        _launch(q, k, v, out, causal=causal, variant=variant, lse=lse)
        flash_attention_cuda.launches += 1
        flash_attention_cuda.launches_by_variant[variant] += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(), device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  variant: str) -> torch.Tensor:
    return _run(q, k, v, causal, variant, False)[0]


@torch.library.custom_op("repro_torch::flash_attention_fwd_lse", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    return _run(q, k, v, causal, variant, True)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, variant):
    return q.new_empty(q.shape)


@_flash_fwd_lse_op.register_fake
def _(q, k, v, causal, variant):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


def attention_flops(b: int, s: int, h: int, d: int, causal: bool, s_kv: int | None = None) -> int:
    """Two products of 2 D flops for each (query, key) pair the inputs need:
    for causal attention only the triangle, S(S+1)/2 pairs per (b, h); a
    non-causal call every pair of its S x S_kv."""
    s_kv = s if s_kv is None else s_kv
    pairs = s * (s + 1) // 2 if causal else s * s_kv
    return 4 * d * pairs * b * h


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd,
                        torch.ops.repro_torch.flash_attention_fwd_lse])
def _flash_flops(q_shape, k_shape, v_shape, causal, variant, *args, out_shape=None, **kwargs):
    b, s, h, d = q_shape
    return attention_flops(b, s, h, d, causal, k_shape[1])


def reset_launch_counts() -> None:
    """Set the launch count and every per-variant count to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_launch_counts()
