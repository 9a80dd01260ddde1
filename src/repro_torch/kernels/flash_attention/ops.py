"""Flash attention over the model's layout, dispatched by device.

``flash_attention(q, k, v, causal=...)`` takes the JAX wrapper's layout,
q ``(B, S, H, D)`` and k/v ``(B, S_kv, KV, D)`` (S_kv = S when causal; a
non-causal call, cross-attention, may take any S_kv >= 1), and returns ``(B, S, H, D)`` in
q's dtype, with ``return_lse`` also the float32 ``(B, H, S)`` row
log-sum-exp.  CUDA tensors launch a hand-written kernel (``kernel.py``),
which reads the layout through strides, indexes KV heads for grouped-query
attention and masks the ragged sequence tail itself; it raises on anything
it does not take.  ``meta`` tensors take the same wrapper to the kernel's
custom op, whose fake implementation gives the shapes and whose flop
formula the dry run reads.  CPU tensors run the plain version (``ref.py``)
after the JAX wrapper's GQA repeat and head-major reshape.

The TPU wrapper's ``block_q``, ``block_kv`` and ``interpret`` are not part
of this API: each CUDA kernel picks its own tiles (128 x 128 for bf16 at
head_dim 64 and 128, 64 x 64 at 32), and there is no interpreter.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import check_inputs, flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_plain"]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int | None = None,
    return_lse: bool = False,
):
    """The plain version over the model's layout, on any device; with
    ``return_lse`` also the float32 ``(B, H, S)`` row log-sum-exp."""
    b, s, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * h, skv, d)
    vf = v.transpose(1, 2).reshape(b * h, skv, d)
    out = attention_ref(qf, kf, vf, causal=causal, q_chunk=q_chunk, return_lse=return_lse)
    if return_lse:
        out, lse = out
    out = out.reshape(b, h, s, d).transpose(1, 2).contiguous()
    return (out, lse.reshape(b, h, s)) if return_lse else out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    return_lse: bool = False,
):
    """Attention forward; ``(B, S, H, D)`` x ``(B, S_kv, KV, D)`` -> ``(B, S, H, D)``,
    and with ``return_lse`` the float32 ``(B, H, S)`` row log-sum-exp of the
    scaled scores (natural log), which the recomputing backward reads."""
    if q.device.type in ("cuda", "meta"):
        return flash_attention_cuda(q, k, v, causal=causal, return_lse=return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on 'cuda', 'meta' or 'cpu' tensors, got {q.device}")
    check_inputs(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal, return_lse=return_lse)
