"""Dense decoder-only transformer: init, full-sequence forward and cached
decode (port of ``repro.models.transformer`` for the dense family).

  init_model(cfg, seed=..., device=...)  -> Transformer (float32 master weights)
  forward(model, cfg, batch)             -> logits (B, S, padded_vocab) in cfg.dtype
  init_decode_state(cfg, B, max_seq)     -> {"pos", "k", "v"} decode state
  decode_step(model, cfg, tokens, state) -> logits (B, padded_vocab) float32; the
                                            state is updated in place

The JAX package scans one layer body over stacked parameters; here the
stack is a Python loop over per-layer modules.  Weights stay in
``cfg.param_dtype`` and are cast to ``cfg.dtype`` at use, as in JAX.
Parameters take no gradient: the port has no backward yet.

Not in this slice (ROADMAP.md, Queue 1): the MoE family (item 2),
training (``cross_entropy_loss``, item 3), and the RWKV, hybrid,
encoder-decoder and frontend families (item 10).  Each raises
``NotImplementedError`` through ``check_supported``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, attention, decode_attention, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, SwiGLU, frozen, init_embedding, init_swiglu

__all__ = [
    "DenseLayer",
    "Transformer",
    "check_supported",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_model",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this slice does not port, naming their ROADMAP.md item."""
    missing = None
    if cfg.is_moe:
        missing = "the MoE family (models/moe.py): ROADMAP.md Queue 1 item 2"
    elif cfg.rwkv or cfg.family == "ssm":
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
    """``ln1``, ``attn``, ``ln2``, ``ffn``: pre-norm attention and SwiGLU blocks."""

    def __init__(self, params: dict):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"])
        self.ln2 = RMSNorm(params["ln2"])
        self.attn = Attention(params["attn"])
        self.ffn = SwiGLU(params["ffn"])

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        x = x + attention(self.attn.params(), cfg, self.ln1(x, cfg.norm_eps))
        return x + self.ffn(self.ln2(x, cfg.norm_eps))


class Transformer(nn.Module):
    """Weights of a dense model, named as the JAX pytree's keys:
    ``embed`` (padded_vocab, d), ``layers[i]``, ``final_ln``, ``lm_head``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(params['layers'])} layers, config has {cfg.num_layers}")
        self.embed = frozen(params["embed"]["emb"])
        self.final_ln = RMSNorm(params["final_ln"])
        self.layers = nn.ModuleList(DenseLayer(lp) for lp in params["layers"])
        self.lm_head = None if cfg.tie_embeddings else frozen(params["lm_head"]["emb"])


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    ones = torch.ones(cfg.d_model, dtype=pd, device=gen.device)
    return {
        "ln1": ones,
        "ln2": ones.clone(),
        "attn": init_attention(gen, cfg),
        "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype=pd),
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


def _mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Subtract 1e9 from the padded vocabulary's logits, in place: JAX writes a
    masked copy (12 GB at B=2, S=32768); the values are the same, since the
    other entries lose 0."""
    logits[..., cfg.vocab_size:] -= 1e9
    return logits


def forward(model: Transformer, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits for prefill.  ``batch["tokens"]``: (B, S) integer ids (tensor or numpy)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    tokens = tokens.to(device=model.embed.device, dtype=torch.long)
    x = model.embed[tokens].to(cfg.dtype)
    for layer in model.layers:
        x = layer(x, cfg)
    x = model.final_ln(x, cfg.norm_eps)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    logits = x @ head.to(x.dtype).T
    return _mask_padded_vocab(logits, cfg)


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
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    tokens = tokens.to(device=model.embed.device, dtype=torch.long)
    pos = state["pos"]
    x = model.embed[tokens][:, None].to(cfg.dtype)
    for layer, cache_k, cache_v in zip(model.layers, state["k"], state["v"]):
        h = layer.ln1(x, cfg.norm_eps)
        out, _, _ = decode_attention(layer.attn.params(), cfg, h, cache_k, cache_v, pos)
        x = x + out
        x = x + layer.ffn(layer.ln2(x, cfg.norm_eps))
    state["pos"] += 1
    x = model.final_ln(x, cfg.norm_eps)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    logits = (x[:, 0] @ head.to(x.dtype).T).float()
    return _mask_padded_vocab(logits, cfg), state
