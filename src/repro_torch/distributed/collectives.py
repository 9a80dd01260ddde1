"""Manual collective building blocks (port of ``repro.distributed.collectives``).

JAX writes them inside ``shard_map`` over a named axis; the port runs them
on every rank of a ``torch.distributed`` group (``launch.mesh.axis_group``
gives the group of a mesh axis):

  * ``compressed_psum``      — int8 with one shared scale, summed in int32
    (4x fewer reduction bytes than float32; pairs with
    ``optim.grad_compress``'s error feedback);
  * ``ring_allgather_matmul`` — ``x @ all-gather(w_shard)`` as a ring: each
    hop's product overlaps the transfer of the next shard.

Both are collectives around plain PyTorch arithmetic and a plain matmul,
as JAX's are around ``jnp``: no kernel of the port is involved.  On gloo,
the ring's point-to-point transfers go through host buffers (gloo's
``send`` and ``recv`` take CPU tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["compressed_psum", "ring_allgather_matmul"]


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantised sum of ``x`` over ``group`` with one shared scale.

    Each rank quantises its contribution with the group's largest
    ``max|x| / 127 + 1e-12`` (an ``all_reduce`` MAX: per-rank scales would
    not commute with the sum); the int8 values are summed in int32 (no
    overflow below 2^23 ranks) and dequantised.  Lossy, as JAX's: callers
    pair it with error feedback."""
    scale = (x.abs().max().float() / 127.0 + 1e-12).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    return q_sum.float() * scale


def ring_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group, axis_size: int):
    """``x @ all-gather(w_shard)``, the ``w`` shards rotating around a ring.

    ``x`` (m, k) is the same on every rank, ``w_shard`` (k, n_local) is this
    rank's column block.  At hop i the rank holds the shard of rank
    ``(idx - i) % n`` and writes its product into that block of the output,
    while the shard moves on to rank ``idx + 1`` (one batched send and
    receive a hop, waited on before the next hop's product).  Returns
    (m, n_local * axis_size)."""
    n = axis_size
    if dist.get_world_size(group) != n:
        raise ValueError(f"axis_size {n} but the group has {dist.get_world_size(group)} ranks")
    idx = dist.get_rank(group)
    m, n_local = x.shape[0], w_shard.shape[1]
    out = torch.empty((n, m, n_local), dtype=torch.promote_types(x.dtype, w_shard.dtype),
                      device=x.device)
    staged = dist.get_backend(group) == "gloo" and w_shard.device.type != "cpu"
    peer = lambda r: dist.get_global_rank(group, r) if group is not None else r  # noqa: E731
    w_cur = w_shard.contiguous()
    wire = w_cur.cpu() if staged else w_cur
    for i in range(n):
        src = (idx - i) % n
        reqs = []
        if i < n - 1:
            nxt = torch.empty_like(wire)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, wire, peer((idx + 1) % n), group),
                dist.P2POp(dist.irecv, nxt, peer((idx - 1) % n), group)])
        out[src] = x @ w_cur
        for req in reqs:
            req.wait()
        if i < n - 1:
            wire = nxt
            w_cur = nxt.to(w_shard.device, non_blocking=True) if staged else nxt
    return out.permute(1, 0, 2).reshape(m, n * n_local)
