"""Error-feedback int8 gradient compression (port of
``repro.optim.grad_compress``).

Each gradient leaf is quantised to int8 with a per-leaf scale and
dequantised; the quantisation error is kept in an error-feedback buffer
(``state["ef_buffer"]``, float32, the parameters' structure) and added to
the next step's gradient.  A leaf is JAX's: the port's per-layer tensors of
one name share the scale that JAX's stacked array has
(``tree.stacked_groups``).  Per replica, as in JAX: there is no collective
here.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import param_tree, stacked_groups, tree_map

__all__ = ["Int8ErrorFeedback", "dequantize_int8", "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass(frozen=True)
class Int8ErrorFeedback:
    """``compress_tree(grads, state) -> (grads', state)`` with EF buffers."""

    ef_key: str = "ef_buffer"

    def init_state(self, state: dict) -> dict:
        """``state`` with a zero buffer added, if it has none."""
        if self.ef_key in state:
            return state
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         param_tree(state["params"]))
        return dict(state, **{self.ef_key: zeros})

    def compress_tree(self, grads, state: dict):
        """The dequantised gradients of ``grads + buffer``; the buffer takes
        the new error in place."""
        state = self.init_state(state)
        out = {}
        with torch.no_grad():
            for gs, es in zip(stacked_groups(grads), stacked_groups(state[self.ef_key])):
                g32 = [g.float() + e for g, e in zip(gs, es)]
                # quantize_int8's scale, over the group as over JAX's stacked leaf
                scale = torch.stack([x.abs().max() for x in g32]).max() / 127.0 + 1e-12
                for g, x, e in zip(gs, g32, es):
                    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
                    deq = dequantize_int8(q, scale)
                    e.copy_(x - deq)
                    out[id(g)] = deq
        return tree_map(lambda g: out[id(g)], grads), state
