"""Decoder-only transformer, dense and MoE: init, full-sequence forward, loss
and cached decode (port of ``repro.models.transformer`` for those families).

  init_model(cfg, seed=..., device=...)  -> Transformer (float32 master weights)
  forward(model, cfg, batch)             -> logits (B, S, padded_vocab) in cfg.dtype
  forward_params(params, cfg, batch)     -> the same over a parameter tree
  cross_entropy_loss(logits, labels)     -> mean next-token CE + z-loss, float32
  init_decode_state(cfg, B, max_seq)     -> {"pos", "k", "v"} decode state
  decode_step(model, cfg, tokens, state) -> logits (B, padded_vocab) float32; the
                                            state is updated in place

The JAX package scans one layer body over stacked parameters; here the
stack is a Python loop over per-layer modules, and ``Transformer.params()``
is the JAX pytree with the layer stack as a list.  Weights stay in
``cfg.param_dtype`` and are cast to ``cfg.dtype`` at use, as in JAX.  Each
layer body ends in ``grad_fence_bf16`` and, when gradients are taken, runs
under ``cfg.remat_policy`` (``torch.utils.checkpoint``, as JAX wraps it in
``jax.checkpoint``).

Not in this slice (ROADMAP.md, Queue 1 item 10): the RWKV, hybrid,
encoder-decoder and frontend families.  Each raises ``NotImplementedError``
through ``check_supported``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, attention, decode_attention, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    RMSNorm,
    SwiGLU,
    grad_fence_bf16,
    init_embedding,
    init_swiglu,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoE, init_moe, moe_layer

__all__ = [
    "DenseLayer",
    "Transformer",
    "check_supported",
    "cross_entropy_loss",
    "decode_step",
    "forward",
    "forward_params",
    "init_decode_state",
    "init_model",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this slice does not port, naming their ROADMAP.md item."""
    missing = None
    if cfg.rwkv or cfg.family == "ssm":
        missing = "the RWKV family (models/rwkv.py): ROADMAP.md Queue 1 item 10"
    elif cfg.family == "hybrid":
        missing = "the hybrid family (models/ssm.py): ROADMAP.md Queue 1 item 10"
    elif cfg.is_encoder_decoder:
        missing = "the encoder-decoder family: ROADMAP.md Queue 1 item 10"
    elif cfg.frontend is not None:
        missing = f"the {cfg.frontend} frontend: ROADMAP.md Queue 1 item 10"
    if missing is not None:
        raise NotImplementedError(f"{cfg.name}: not ported yet, {missing}")


class DenseLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``ffn``: pre-norm attention, then SwiGLU
    or, in the MoE family (``ffn`` holds a ``router``), the MoE layer."""

    def __init__(self, params: dict):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"])
        self.ln2 = RMSNorm(params["ln2"])
        self.attn = Attention(params["attn"])
        self.ffn = MoE(params["ffn"]) if "router" in params["ffn"] else SwiGLU(params["ffn"])

    def params(self) -> dict:
        return {"ln1": self.ln1.weight, "ln2": self.ln2.weight, "attn": self.attn.params(),
                "ffn": self.ffn.params()}


class Transformer(nn.Module):
    """Weights of a dense or MoE model, named as the JAX pytree's keys:
    ``embed`` (padded_vocab, d), ``layers[i]``, ``final_ln``, ``lm_head``.
    ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(params['layers'])} layers, config has {cfg.num_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"]["emb"])
        self.final_ln = RMSNorm(params["final_ln"])
        self.layers = nn.ModuleList(DenseLayer(lp) for lp in params["layers"])
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(params["lm_head"]["emb"])

    def params(self) -> dict:
        """The JAX pytree of this model's parameters (the tensors themselves),
        with ``layers`` a list of per-layer dicts."""
        tree = {"embed": {"emb": self.embed}, "final_ln": self.final_ln.weight,
                "layers": [layer.params() for layer in self.layers]}
        if self.lm_head is not None:
            tree["lm_head"] = {"emb": self.lm_head}
        return tree


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    ones = torch.ones(cfg.d_model, dtype=pd, device=gen.device)
    return {
        "ln1": ones,
        "ln2": ones.clone(),
        "attn": init_attention(gen, cfg),
        "ffn": (init_moe(gen, cfg) if cfg.is_moe
                else init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype=pd)),
    }


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    The draws are not JAX's; to compute from the JAX package's weights use
    ``repro_torch.convert.lm_params_from_numpy``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype=pd),
        "final_ln": torch.ones(cfg.d_model, dtype=pd, device=dev),
        "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype=pd)
    return Transformer(cfg, params)


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return moe_layer(lp, cfg, h) if cfg.is_moe else swiglu(lp, h)


def layer_body(lp: dict, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True):
    """One layer over a full sequence (JAX's ``_dense_layer_seq``)."""
    x = x + attention(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), causal=causal)
    x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return grad_fence_bf16(x)


# Selective checkpointing for remat "dots": keep the outputs of 2-D matrix
# products (projections by a weight, JAX's dots with no batch dimensions),
# recompute everything else.
_DOTS = (torch.ops.aten.mm.default,)


def _save_dots():
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _run_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``layer_body`` under ``cfg.remat_policy`` when a gradient is being
    taken: "full" saves the layer's input and recomputes the rest in the
    backward (the flash kernel is launched again there), "dots" saves the
    2-D matrix products' outputs too, "none" saves what autograd saves."""
    policy = cfg.remat_policy
    if not torch.is_grad_enabled() or policy == "none":
        return layer_body(lp, cfg, x)
    if policy == "full":
        return checkpoint(layer_body, lp, cfg, x, use_reentrant=False)
    if policy == "dots":
        return checkpoint(layer_body, lp, cfg, x, use_reentrant=False, context_fn=_save_dots)
    raise ValueError(f"remat_policy {policy!r}: use 'full', 'dots' or 'none'")


def _as_tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=device, dtype=torch.long)


def forward_params(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits over a parameter tree (``Transformer.params()``'s structure,
    any dtypes).  ``batch["tokens"]``: (B, S) integer ids (tensor or numpy)."""
    check_supported(cfg)
    emb = params["embed"]["emb"]
    x = emb[_as_tokens(batch["tokens"], emb.device)].to(cfg.dtype)
    for lp in params["layers"]:
        x = _run_layer(lp, cfg, x)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = emb if cfg.tie_embeddings else params["lm_head"]["emb"]
    logits = x @ head.to(x.dtype).T
    return _mask_padded_vocab(logits, cfg)


def _mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Subtract 1e9 from the padded vocabulary's logits, in place: JAX writes a
    masked copy (12 GB at B=2, S=32768); the values are the same, since the
    other entries lose 0."""
    logits[..., cfg.vocab_size:] -= 1e9
    return logits


def forward(model: Transformer, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits for train and prefill.  ``batch["tokens"]``: (B, S) integer ids
    (tensor or numpy)."""
    return forward_params(model.params(), cfg, batch)


def cross_entropy_loss(logits: torch.Tensor, labels, *, z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token cross-entropy with z-loss, in float32; labels of -100
    (any negative label) are ignored."""
    if isinstance(labels, np.ndarray):
        labels = torch.from_numpy(labels)
    labels = labels.to(device=logits.device, dtype=torch.long)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    picked = logits.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    total = torch.where(valid, lse - picked + z_loss * lse.square(), 0.0).sum()
    return total / valid.sum().clamp_min(1)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      cache_dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Zeroed decode state of the attention family: ``pos`` (B,) int32 and the
    per-layer caches ``k``, ``v`` (L, B, max_seq, KV, hd) in ``cache_dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=cache_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cache_dtype, device=dev),
    }


def decode_step(model: Transformer, cfg: ModelConfig, tokens, state: dict):
    """One decode step.  ``tokens``: (B,) integer ids (tensor or numpy).

    Returns ``(logits (B, padded_vocab) float32, state)``: each layer's
    caches are written in place at each sequence's position and ``pos``
    advances by one.  The caller's state dict is the one returned.
    """
    check_supported(cfg)
    tokens = _as_tokens(tokens, model.embed.device)
    pos = state["pos"]
    x = model.embed[tokens][:, None].to(cfg.dtype)
    for layer, cache_k, cache_v in zip(model.layers, state["k"], state["v"]):
        lp = layer.params()
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _, _ = decode_attention(lp["attn"], cfg, h, cache_k, cache_v, pos)
        x = x + out
        x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    state["pos"] += 1
    x = model.final_ln(x, cfg.norm_eps)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    logits = (x[:, 0] @ head.to(x.dtype).T).float()
    return _mask_padded_vocab(logits, cfg), state
