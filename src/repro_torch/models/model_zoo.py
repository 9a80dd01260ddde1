"""Model zoo front end: step functions and input specs per architecture
(port of ``repro.models.model_zoo``).

``input_specs`` gives tensors on the ``meta`` device, PyTorch's shapes
without storage, where JAX gives ``ShapeDtypeStruct``s.  JAX's
``_ubatch_constraint`` is a GSPMD sharding hint, a no-op outside a mesh; its
counterpart is the sharded train step (``distributed.sharded_step``), which
places each microbatch's rows on the data group itself, as the hint asks
GSPMD to, while ``distributed.tensor_parallel`` keeps the head axes on
``model`` (JAX's ``head_shard``).
The loss and train steps take every family; a batch carries
``frames`` for the encoder-decoder family and may carry ``prefix_embeds``
for the vision frontend, as ``input_specs`` gives them, and microbatches
split them along their first axis with the tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    Transformer,
    _state_device,
    cross_entropy_loss,
    decode_step,
    forward,
    forward_params,
    init_decode_state,
    init_model,
)
from repro_torch.tree import param_tree, tree_leaves, tree_map

__all__ = ["check_finite", "compute_weight", "init_decode_state", "init_model", "input_specs",
           "make_decode_fn", "make_loss_fn", "make_prefill_fn", "make_train_step",
           "microbatch_grads", "on_device", "sgd_update"]


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(params, batch) -> float32 loss``: ``cross_entropy_loss`` of
    the logits against ``batch["labels"]``; ``params`` is a model or a tree."""

    def loss_fn(params, batch):
        logits = forward_params(param_tree(params), cfg, batch)
        return cross_entropy_loss(logits, batch["labels"], vocab=cfg.padded_vocab)

    return loss_fn


def on_device(batch: dict, dev: torch.device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``dev``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, torch.Tensor) else v).to(dev)
            for k, v in batch.items()}


def compute_weight(p: torch.Tensor, cfg: ModelConfig, cast: bool = True) -> torch.Tensor:
    """The tensor a train step computes with: with ``cast``, one of 2 or more
    dimensions cast to ``cfg.dtype`` (JAX's ``cast_params_bf16``)."""
    return p.to(cfg.dtype) if cast and p.dim() >= 2 else p


def microbatch_grads(loss_fn, tree: dict, batch: dict, n: int, *, select=None, into=None,
                     indices=None):
    """``(loss, grads)`` of ``loss_fn`` against ``tree``'s leaves (which
    require grad), as the mean over ``n`` microbatches.

    ``select(i) -> (microbatch, scale)`` gives microbatch i and the factor on
    its loss (``None`` for 1); by default it is JAX's split of the batch's
    first axis into (n, B/n) rows, factor 1.  Float32 gradients are summed
    into ``into`` (zeroed buffers, one per leaf) or new buffers, then
    divided by ``n``; with ``n`` 1, no ``select`` and no ``into`` they are
    autograd's, in the leaves' types, as in JAX.  ``indices`` are the
    microbatches the loop runs (default all ``n``): the dry run runs one,
    counted ``n`` times (``launch.dryrun``)."""
    leaves = tree_leaves(tree)
    if n == 1 and select is None and into is None:
        loss = loss_fn(tree, batch)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    if select is None:
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, not a multiple of {n}")

        def select(i):
            return {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                    for k, v in batch.items()}, None
    dev = leaves[0].device
    acc = into if into is not None else [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                                         for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n) if indices is None else indices:
        mb, scale = select(i)
        loss = loss_fn(tree, mb)
        if scale is not None:
            loss = loss * scale
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a += g.float()
        loss_sum += loss.detach()
    inv = 1.0 / n
    return loss_sum * inv, [a.mul_(inv) for a in acc]


def check_finite(loss: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` on a non-finite loss (one host sync)."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss {float(loss)}")


def sgd_update(state: dict, params: list, grads: list) -> None:
    """``p -= lr * g`` in place, at ``state["lr"]`` (default 1e-3)."""
    lr = state.get("lr", 1e-3)
    lr = lr.to_local() if hasattr(lr, "to_local") else lr
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g.to(p.dtype))


def make_train_step(cfg: ModelConfig, optimizer=None, *, num_microbatches: int = 1,
                    cast_params_bf16: bool = True, device="cuda"):
    """``(state, batch) -> (state, metrics)``; ``state`` is an optimiser state
    (``optim.adamw.init_adamw_state``) whose ``params`` is a ``Transformer``
    (or a tree of tensors) on ``device`` (default the GPU; raises without
    one, and when the weights lie elsewhere).

    As in JAX: with ``num_microbatches`` > 1 the batch is split along its
    first axis, float32 gradients are summed over the microbatches and their
    mean taken, with the mean loss (``microbatch_grads``); ``cast_params_bf16``
    casts tensors of 2 or more dimensions to ``cfg.dtype`` once per step,
    before the microbatches, and the gradients are taken against those cast
    tensors (the gradient through the cast to the float32 master has the
    same values); with ``optimizer=None`` the update is SGD at
    ``state["lr"]`` (default 1e-3); ``optimizer.compressor`` compresses the
    gradients first.

    The update is made in place, into the state's tensors, and the same
    state dict is returned.  It starts only after every gradient has been
    computed, and a non-finite loss raises ``FloatingPointError`` before it
    (one host sync a step), so a step that raises leaves the state as it was
    and can be replayed.
    """
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg)
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches={num_microbatches} must be >= 1")

    def train_step(state: dict, batch: dict):
        tree = param_tree(state["params"])
        where = tree_leaves(tree)[0].device
        if where != dev:
            raise ValueError(f"model weights are on {where}, the train step runs on {dev}")
        weights = tree_map(lambda p: compute_weight(p, cfg, cast_params_bf16).detach()
                           .requires_grad_(), tree)
        loss, grads = microbatch_grads(loss_fn, weights, on_device(batch, dev), num_microbatches)
        check_finite(loss)
        if optimizer is None:
            sgd_update(state, tree_leaves(tree), grads)
            return state, {"loss": loss}
        it = iter(grads)
        grads = tree_map(lambda _: next(it), tree)
        if optimizer.compressor is not None:
            grads, state = optimizer.compressor.compress_tree(grads, state)
        state, metrics = optimizer.apply_gradients(state, grads)
        return state, dict(metrics, loss=loss)

    return train_step


def make_prefill_fn(cfg: ModelConfig, *, device="cuda"):
    """``prefill(model, batch) -> (B, padded_vocab)`` next-token logits.

    ``batch`` as ``forward`` takes it: ``tokens``, with ``frames`` for the
    encoder-decoder family and optionally ``prefix_embeds`` for the vision
    frontend.  Runs ``forward`` under ``torch.inference_mode`` on ``device`` (default
    the GPU; raises without one; ``"meta"`` runs it on shapes, for the dry
    run) and returns a copy of the last position's logits, so the full
    ``(B, S, padded_vocab)`` logits are freed on return.
    """
    dev = _state_device(device)

    def prefill(model: Transformer, batch: dict) -> torch.Tensor:
        if model.embed.device != dev:
            raise ValueError(f"model weights are on {model.embed.device}, prefill runs on {dev}")
        with torch.inference_mode():
            return forward(model, cfg, batch)[:, -1].clone()

    return prefill


def make_decode_fn(cfg: ModelConfig, *, device="cuda"):
    """``serve_step(model, tokens, state) -> (logits (B, padded_vocab), state)``:
    ``decode_step`` under ``torch.inference_mode`` on ``device`` (default
    the GPU; raises without one; ``"meta"`` runs it on shapes).  The state
    is updated in place."""
    dev = _state_device(device)

    def serve_step(model: Transformer, tokens, state: dict):
        if model.embed.device != dev:
            raise ValueError(f"model weights are on {model.embed.device}, decode runs on {dev}")
        with torch.inference_mode():
            return decode_step(model, cfg, tokens, state)

    return serve_step


def input_specs(cfg: ModelConfig, shape_spec) -> dict:
    """Every model input of (arch x shape) as a tensor on the ``meta`` device
    (shape and dtype, no storage), as JAX's ``input_specs`` gives them.

    kind "train" / "prefill": ``tokens`` (and ``labels`` for train) int32;
    the encoder-decoder family takes ``frames`` (B, S, d) bf16 and
    ``max_target_len`` tokens; the vision frontend ``prefix_embeds`` (B, P,
    d) bf16 with P = min(num_prefix_embeds, S // 2) and S - P tokens.  kind
    "decode": one token per sequence and ``init_decode_state``'s state of
    length ``seq_len``, on ``meta``."""
    b, s = shape_spec.global_batch, shape_spec.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shape_spec.kind in ("train", "prefill"):
        train = shape_spec.kind == "train"
        if cfg.is_encoder_decoder:
            specs = {"frames": spec((b, s, cfg.d_model), torch.bfloat16),
                     "tokens": spec((b, cfg.max_target_len), torch.int32)}
            n_tok = cfg.max_target_len
        elif cfg.frontend == "vision_stub":
            p = min(cfg.num_prefix_embeds, s // 2)
            specs = {"prefix_embeds": spec((b, p, cfg.d_model), torch.bfloat16),
                     "tokens": spec((b, s - p), torch.int32)}
            n_tok = s - p
        else:
            specs = {"tokens": spec((b, s), torch.int32)}
            n_tok = s
        if train:
            specs["labels"] = spec((b, n_tok), torch.int32)
        return specs
    return {"tokens": spec((b,), torch.int32),
            "state": init_decode_state(cfg, b, s, device="meta")}
