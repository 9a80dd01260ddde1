"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

State layout, as in JAX: ``{"params", "m", "v", "step", "lr"}``.  ``params``
is a ``Transformer`` (or a tree of tensors); ``m`` and ``v`` are float32
trees of its ``params()`` structure; ``step`` (int32) and ``lr`` (float32)
are 0-d tensors on the parameters' device.  The update is JAX's term for
term: clip by the global norm, bias correction at ``step + 1``, decay
inside ``delta``, the schedule as a multiplier of ``lr``.  It is the port's
own code rather than ``torch.optim.AdamW``, whose update differs in form.
Unlike JAX's it writes the parameters, ``m``, ``v`` and ``step`` in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import param_tree, tree_leaves, tree_map

__all__ = ["AdamW", "global_norm", "init_adamw_state"]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def init_adamw_state(params, *, lr: float = 3e-4) -> dict:
    tree = param_tree(params)
    dev = tree_leaves(tree)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "params": params,
        "m": tree_map(zeros, tree),
        "v": tree_map(zeros, tree),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "lr": torch.tensor(lr, dtype=torch.float32, device=dev),
    }


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Callable | None = None  # step -> lr multiplier
    # error-feedback gradient compression hook (optim.grad_compress)
    compressor: object | None = None

    def apply_gradients(self, state: dict, grads, *,
                        grad_norm: torch.Tensor | None = None) -> tuple[dict, dict]:
        """Update ``state`` in place from ``grads`` (a tree of ``params``'
        structure); returns it with ``{"grad_norm", "lr"}``.  ``grad_norm``
        is the norm to clip by when ``grads`` and ``state`` hold one rank's
        shards of the leaves (the sharded train step): the full gradients'."""
        step = state["step"] + 1
        lr = state["lr"]
        if self.schedule is not None:
            lr = lr * self.schedule(step)
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        leaves = zip(tree_leaves(param_tree(state["params"])), tree_leaves(grads),
                     tree_leaves(state["m"]), tree_leaves(state["v"]))
        with torch.no_grad():
            for p, g, m, v in leaves:
                g = g.float() * scale
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
                delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
            state["step"].copy_(step)
        return state, {"grad_norm": gnorm, "lr": lr}

    def step(self, state: dict, batch, loss_fn) -> tuple[torch.Tensor, dict, dict]:
        """``loss_fn(params_tree, batch)``'s value and one update from its gradients."""
        tree = tree_map(lambda p: p.detach().requires_grad_(), param_tree(state["params"]))
        loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), tree)
        if self.compressor is not None:
            grads, state = self.compressor.compress_tree(grads, state)
        state, metrics = self.apply_gradients(state, grads)
        return loss.detach(), state, metrics
