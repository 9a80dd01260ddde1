"""Plain PyTorch version of the MTTKRP kernel, over the same plan buffers.

The counterpart of both ``repro.kernels.mttkrp.ref.mttkrp_plan_ref`` and
the chunked XLA fallback ``repro.kernels.mttkrp.compiled``: gather the
non-output factor rows, take the Hadamard product with the values in
float32, and ``index_add_`` into an exact ``(I_mode, R)`` accumulator.
It is what ``mttkrp_from_plan`` runs on CPU tensors and what the kernel
is compared with on the card; it is no yardstick of speed.

The nonzero stream is processed in chunks of ``nnz_chunk`` so the live
product stays ``nnz_chunk x R`` (times the restart batch) at Table II
sizes.  Padding entries carry value 0 at a real row, so they add an exact
0.0 and the scatter never leaves ``[0, I_mode)``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import torch

if TYPE_CHECKING:
    from repro_torch.kernels.mttkrp.ops import PlanBuffers

__all__ = ["DEFAULT_NNZ_CHUNK", "mttkrp_plan_ref"]

DEFAULT_NNZ_CHUNK = 1 << 22


def mttkrp_plan_ref(
    plan_bufs: "PlanBuffers",
    factors: Sequence[torch.Tensor],
    mode: int,
    i_out: int,
    *,
    nnz_chunk: int = DEFAULT_NNZ_CHUNK,
) -> torch.Tensor:
    """MTTKRP from plan buffers; ``(..., i_out, R)`` float32.

    ``factors`` are ``(I_k, R)`` or batched ``(B, I_k, R)``; the output
    carries the same leading batch shape.
    """
    indices, values = plan_bufs.indices, plan_bufs.values
    lead = tuple(factors[0].shape[:-2])
    rank = int(factors[0].shape[-1])
    out = torch.zeros(lead + (i_out, rank), dtype=torch.float32, device=values.device)
    nnz_pad = int(values.shape[0])
    for lo in range(0, nnz_pad, nnz_chunk):
        idx = indices[lo : lo + nnz_chunk]
        prod = values[lo : lo + nnz_chunk].to(torch.float32)[:, None]
        prod = prod.expand(lead + (idx.shape[0], rank))
        for k, f in enumerate(factors):
            if k != mode:
                prod = prod * f.index_select(-2, idx[:, k]).to(torch.float32)
        out.index_add_(-2, idx[:, mode], prod)
    return out
