"""Model assembly for every architecture family: init, full-sequence forward,
loss and cached decode (port of ``repro.models.transformer``).

  init_model(cfg, seed=..., device=...)  -> Transformer (float32 master weights)
  forward(model, cfg, batch)             -> logits (B, S, padded_vocab) in cfg.dtype
  forward_params(params, cfg, batch)     -> the same over a parameter tree
  cross_entropy_loss(logits, labels)     -> mean next-token CE + z-loss, float32
  init_decode_state(cfg, B, max_seq)     -> the family's decode state
  decode_step(model, cfg, tokens, state) -> logits (B, padded_vocab) float32; the
                                            state is updated in place

Families, as in JAX: dense and MoE (attention + SwiGLU or MoE); RWKV-6
(``models.rwkv``: time mix and channel mix, the WKV recurrence through the
``wkv6_scan`` kernel); hybrid (zamba2: Mamba2 layers, ``models.ssm``, the
state recurrence through the ``ssd_scan`` kernel, and ONE shared attention
block after every ``shared_attn_every``-th layer); encoder-decoder
(whisper: a non-causal encoder over stub frame embeddings, then decoder
layers with cross-attention to it); and the vision frontend stub (internvl2:
patch embeddings put before the text, the logits taken after them).

The JAX package scans one layer body over stacked parameters; here each
stack is a Python loop over per-layer modules, and ``Transformer.params()``
is the JAX pytree with every stack (``layers``, ``encoder.layers``,
``cross``) as a list.  The hybrid's shared block runs where
``layer_idx % every == every - 1``, a Python ``if`` in place of JAX's
``lax.cond``.  Weights stay in ``cfg.param_dtype`` and are cast to
``cfg.dtype`` at use, as in JAX.  Each core layer body ends in
``grad_fence_bf16`` and, when gradients are taken, runs under
``cfg.remat_policy`` (``torch.utils.checkpoint``, as JAX wraps it in
``jax.checkpoint``), in every family: the RWKV and hybrid layers, the
encoder's and the decoder's with cross-attention.  Every family trains:
the recurrences' gradients come from their backward kernels on the card,
and the hybrid's shared block, used after every ``shared_attn_every``-th
layer, gathers its gradient from each use, as JAX sums it over the
``lax.cond`` branches of its scan.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.attention import (
    Attention,
    attention,
    compute_kv,
    decode_attention,
    init_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    RMSNorm,
    ShapesOnly,
    SwiGLU,
    grad_fence_bf16,
    init_embedding,
    init_swiglu,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import MoE, init_moe, moe_layer
from repro_torch.models.rwkv import (
    HEAD_DIM as RWKV_HEAD_DIM,
    init_rwkv_block,
    rwkv_channel_mix_seq,
    rwkv_channel_mix_step,
    rwkv_time_mix_seq,
    rwkv_time_mix_step,
)
from repro_torch.models.ssm import CONV_K, HEAD_DIM as MAMBA_HEAD_DIM
from repro_torch.models.ssm import init_mamba, mamba_decode_step, mamba_seq

__all__ = [
    "DenseLayer",
    "ParamTree",
    "Transformer",
    "cross_entropy_loss",
    "decode_step",
    "fill_cross_cache",
    "forward",
    "forward_params",
    "init_decode_state",
    "init_model",
]


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


class ParamTree(nn.Module):
    """Holds a nested dict of tensors under the JAX pytree's keys (dicts as
    submodules, lists of dicts as ``ModuleList``s, tensors as parameters);
    ``params()`` gives the tree back.  The RWKV and hybrid layers, the
    hybrid's shared block, the encoder and the cross-attention blocks."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = sorted(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                setattr(self, key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                setattr(self, key, nn.ModuleList(ParamTree(item) for item in val))
            else:
                setattr(self, key, nn.Parameter(val))

    def params(self) -> dict:
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            if isinstance(val, ParamTree):
                out[key] = val.params()
            elif isinstance(val, nn.ModuleList):
                out[key] = [item.params() for item in val]
            else:
                out[key] = val
        return out


def _layer_module(params: dict) -> nn.Module:
    return DenseLayer(params) if "attn" in params else ParamTree(params)


class Transformer(nn.Module):
    """Weights of a model of any family, named as the JAX pytree's keys:
    ``embed`` (padded_vocab, d), ``layers[i]``, ``final_ln``, ``lm_head``,
    and where the family has them ``shared_attn`` (hybrid), ``encoder``
    (``layers[i]`` and ``final_ln``) and ``cross[i]`` (encoder-decoder).
    ``cfg`` is the config it was built for."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(params['layers'])} layers, config has {cfg.num_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"]["emb"])
        self.final_ln = RMSNorm(params["final_ln"])
        self.layers = nn.ModuleList(_layer_module(lp) for lp in params["layers"])
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(params["lm_head"]["emb"])
        self.shared_attn = ParamTree(params["shared_attn"]) if "shared_attn" in params else None
        self.encoder = ParamTree(params["encoder"]) if "encoder" in params else None
        self.cross = (nn.ModuleList(ParamTree(cp) for cp in params["cross"])
                      if "cross" in params else None)
        if self.encoder is not None and len(self.encoder.layers) != cfg.encoder_layers:
            raise ValueError(f"{len(self.encoder.layers)} encoder layers, config has "
                             f"{cfg.encoder_layers}")

    def params(self) -> dict:
        """The JAX pytree of this model's parameters (the tensors themselves),
        with each layer stack a list of per-layer dicts."""
        tree = {"embed": {"emb": self.embed}, "final_ln": self.final_ln.weight,
                "layers": [layer.params() for layer in self.layers]}
        if self.lm_head is not None:
            tree["lm_head"] = {"emb": self.lm_head}
        if self.shared_attn is not None:
            tree["shared_attn"] = self.shared_attn.params()
        if self.encoder is not None:
            tree["encoder"] = self.encoder.params()
        if self.cross is not None:
            tree["cross"] = [cp.params() for cp in self.cross]
        return tree


def _ones(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return torch.ones(cfg.d_model, dtype=cfg.param_dtype, device=gen.device)


def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """One core layer of the family (JAX's ``_init_layer``): a hybrid layer
    is ``ln1`` and ``mamba`` only."""
    if cfg.rwkv:
        return {"ln1": _ones(gen, cfg), "ln2": _ones(gen, cfg), "rwkv": init_rwkv_block(gen, cfg)}
    if cfg.family == "hybrid":
        return {"ln1": _ones(gen, cfg), "mamba": init_mamba(gen, cfg)}
    pd = cfg.param_dtype
    return {
        "ln1": _ones(gen, cfg),
        "ln2": _ones(gen, cfg),
        "attn": init_attention(gen, cfg),
        "ffn": (init_moe(gen, cfg) if cfg.is_moe
                else init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype=pd)),
    }


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Pre-norm attention and SwiGLU: the hybrid's shared block and an encoder layer."""
    return {"ln1": _ones(gen, cfg), "ln2": _ones(gen, cfg), "attn": init_attention(gen, cfg),
            "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype=cfg.param_dtype)}


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``.

    The draws are not JAX's; to compute from the JAX package's weights use
    ``repro_torch.convert.lm_params_from_numpy``.  ``device="meta"`` gives
    the weights' shapes and dtypes without storage or draws (JAX's
    ``eval_shape`` of its ``init_model``).
    """
    dev = _state_device(device)
    gen = ShapesOnly() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype
    params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype=pd),
        "final_ln": torch.ones(cfg.d_model, dtype=pd, device=dev),
        "layers": [_init_layer(gen, cfg) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype=pd)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_block(gen, cfg)
    if cfg.is_encoder_decoder:
        params["encoder"] = {"layers": [_init_block(gen, cfg) for _ in range(cfg.encoder_layers)],
                             "final_ln": torch.ones(cfg.d_model, dtype=pd, device=dev)}
        params["cross"] = [{"ln": _ones(gen, cfg), "attn": init_attention(gen, cfg)}
                           for _ in range(cfg.num_layers)]
    return Transformer(cfg, params)


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return moe_layer(lp, cfg, h) if cfg.is_moe else swiglu(lp, h, cfg.d_ff)


def layer_body(lp: dict, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True):
    """One dense or MoE layer over a full sequence (JAX's ``_dense_layer_seq``)."""
    x = x + attention(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), causal=causal)
    x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return grad_fence_bf16(x)


def _rwkv_layer_seq(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + rwkv_time_mix_seq(lp["rwkv"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps))
    x = x + rwkv_channel_mix_seq(lp["rwkv"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return grad_fence_bf16(x)


def _shared_block(shared: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The hybrid's shared attention + SwiGLU block over a full sequence."""
    x = x + attention(shared["attn"], cfg, rms_norm(x, shared["ln1"], cfg.norm_eps), causal=True)
    return x + swiglu(shared["ffn"], rms_norm(x, shared["ln2"], cfg.norm_eps), cfg.d_ff)


def _applies_shared(cfg: ModelConfig, layer_idx: int) -> bool:
    every = cfg.shared_attn_every
    return bool(every) and layer_idx % every == every - 1


def _hybrid_layer_seq(lp: dict, cfg: ModelConfig, x: torch.Tensor, shared: dict | None,
                      layer_idx: int) -> torch.Tensor:
    x = x + mamba_seq(lp["mamba"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps))
    if _applies_shared(cfg, layer_idx):
        x = _shared_block(shared, cfg, x)
    return grad_fence_bf16(x)


def _enc_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = x + attention(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), causal=False)
    return x + swiglu(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg.d_ff)


def _dec_cross_layer(lp: dict, cp: dict, cfg: ModelConfig, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    x = x + attention(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), causal=True)
    kv = compute_kv(cp["attn"], cfg, enc_out)
    x = x + attention(cp["attn"], cfg, rms_norm(x, cp["ln"], cfg.norm_eps), causal=False,
                      kv_override=kv, rope=False)
    return x + swiglu(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg.d_ff)


# Selective checkpointing for remat "dots": keep the outputs of 2-D matrix
# products (projections by a weight, JAX's dots with no batch dimensions),
# recompute everything else.
_DOTS = (torch.ops.aten.mm.default,)


def _save_dots():
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _remat(cfg: ModelConfig, body, *args):
    """``body(*args)`` under ``cfg.remat_policy`` when a gradient is being
    taken: "full" saves the layer's input and recomputes the rest in the
    backward (the flash kernel is launched again there), "dots" saves the
    2-D matrix products' outputs too, "none" saves what autograd saves."""
    policy = cfg.remat_policy
    if not torch.is_grad_enabled() or policy == "none":
        return body(*args)
    if policy == "full":
        return checkpoint(body, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(body, *args, use_reentrant=False, context_fn=_save_dots)
    raise ValueError(f"remat_policy {policy!r}: use 'full', 'dots' or 'none'")


def _as_tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=device, dtype=torch.long)


def _as_input(a, device) -> torch.Tensor:
    """A float input (frames, prefix embeddings) as a tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return a.to(device)


def _run_stack(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(params["layers"]):
        if cfg.rwkv:
            x = _remat(cfg, _rwkv_layer_seq, lp, cfg, x)
        elif cfg.family == "hybrid":
            x = _remat(cfg, _hybrid_layer_seq, lp, cfg, x, params.get("shared_attn"), i)
        else:
            x = _remat(cfg, layer_body, lp, cfg, x)
    return x


def _run_encoder(params: dict, cfg: ModelConfig, frames) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, S_frames, d)."""
    enc = params["encoder"]
    x = _as_input(frames, params["embed"]["emb"].device).to(cfg.dtype)
    for lp in enc["layers"]:
        x = _remat(cfg, _enc_layer, lp, cfg, x)
    return rms_norm(x, enc["final_ln"], cfg.norm_eps)


def _run_decoder_with_cross(params: dict, cfg: ModelConfig, x: torch.Tensor,
                            enc_out: torch.Tensor) -> torch.Tensor:
    for lp, cp in zip(params["layers"], params["cross"]):
        x = _remat(cfg, _dec_cross_layer, lp, cp, cfg, x, enc_out)
    return x


def _prefix_len(cfg: ModelConfig, batch: dict) -> int:
    if cfg.frontend is not None and "prefix_embeds" in batch:
        return int(batch["prefix_embeds"].shape[1])
    return 0


def forward_params(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits over a parameter tree (``Transformer.params()``'s structure,
    any dtypes).  ``batch["tokens"]``: (B, S) integer ids (tensor or numpy);
    the encoder-decoder family also takes ``frames`` (B, S_frames, d), the
    vision frontend optionally ``prefix_embeds`` (B, P, d), put before the
    tokens; the logits are then the tokens' only, (B, S, padded_vocab).
    JAX slices the prefix off the logits; the port slices it off before the
    final norm and the head, which are per row, so the values are the same."""
    emb = params["embed"]["emb"]
    x = tp.vocab_embed(emb, _as_tokens(batch["tokens"], emb.device), cfg).to(cfg.dtype)
    if cfg.is_encoder_decoder:
        x = _run_decoder_with_cross(params, cfg, x, _run_encoder(params, cfg, batch["frames"]))
    else:
        n_prefix = _prefix_len(cfg, batch)
        if n_prefix:
            pre = _as_input(batch["prefix_embeds"], emb.device).to(cfg.dtype)
            x = torch.cat([pre, x], dim=1)
        x = _run_stack(params, cfg, x)[:, n_prefix:]
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = emb if cfg.tie_embeddings else params["lm_head"]["emb"]
    return _mask_padded_vocab(tp.vocab_head(x, head, cfg), cfg)


def _mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Subtract 1e9 from the padded vocabulary's logits, in place: JAX writes a
    masked copy (12 GB at B=2, S=32768); the values are the same, since the
    other entries lose 0.  On the rank's vocabulary shard, at global indices."""
    return tp.mask_padded_vocab(logits, cfg)


def forward(model: Transformer, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Logits for train and prefill; ``batch`` as ``forward_params`` takes it."""
    return forward_params(model.params(), cfg, batch)


def cross_entropy_loss(logits: torch.Tensor, labels, *, z_loss: float = 1e-4,
                       vocab: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy with z-loss, in float32; labels of -100
    (any negative label) are ignored.  ``vocab`` is the logits' full width
    (``cfg.padded_vocab``): narrower logits are the rank's vocabulary shard,
    and the loss is ``tensor_parallel.vocab_cross_entropy``'s."""
    if isinstance(labels, np.ndarray):
        labels = torch.from_numpy(labels)
    labels = labels.to(device=logits.device, dtype=torch.long)
    if vocab is not None and logits.shape[-1] != vocab:
        return tp.vocab_cross_entropy(logits, labels, z_loss=z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    picked = logits.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    total = torch.where(valid, lse - picked + z_loss * lse.square(), 0.0).sum()
    return total / valid.sum().clamp_min(1)


def _state_device(device) -> torch.device:
    """``resolve_device``, plus ``"meta"``: shapes and dtypes without storage
    (``model_zoo.input_specs``, ``init_model``, the dry run's steps)."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      cache_dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Zeroed decode state of the family, JAX's shapes and dtypes; ``pos`` (B,)
    int32 in every family, and

    * attention families: ``k``, ``v`` (L, B, max_seq, KV, hd) in
      ``cache_dtype``; encoder-decoder also ``cross_k``, ``cross_v`` (L, B,
      max_target_len, KV, hd), which ``fill_cross_cache`` fills;
    * RWKV: ``wkv`` (L, B, H, 64, 64), ``x_prev_t``, ``x_prev_c`` (L, B, d),
      float32;
    * hybrid: ``h`` (L, B, heads, 64, ssm_state) and ``conv_buf`` (L, B, 3,
      2d + 2 ssm_state), float32, and the shared block's ``shared_k``,
      ``shared_v`` (L // every, B, max_seq, KV, hd) in ``cache_dtype``.

    ``device="meta"`` gives the shapes without storage."""
    dev = _state_device(device)
    L, d = cfg.num_layers, cfg.d_model
    f32 = torch.float32

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = {"pos": zeros((batch,), torch.int32)}
    if cfg.rwkv:
        state["wkv"] = zeros((L, batch, d // RWKV_HEAD_DIM, RWKV_HEAD_DIM, RWKV_HEAD_DIM))
        state["x_prev_t"] = zeros((L, batch, d))
        state["x_prev_c"] = zeros((L, batch, d))
        return state
    kv_shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family == "hybrid":
        d_inner = 2 * d
        state["h"] = zeros((L, batch, d_inner // MAMBA_HEAD_DIM, MAMBA_HEAD_DIM, cfg.ssm_state))
        state["conv_buf"] = zeros((L, batch, CONV_K - 1, d_inner + 2 * cfg.ssm_state))
        n_shared = L // cfg.shared_attn_every if cfg.shared_attn_every else 0
        if n_shared:
            state["shared_k"] = zeros((n_shared,) + kv_shape, cache_dtype)
            state["shared_v"] = zeros((n_shared,) + kv_shape, cache_dtype)
        return state
    state["k"] = zeros((L,) + kv_shape, cache_dtype)
    state["v"] = zeros((L,) + kv_shape, cache_dtype)
    if cfg.is_encoder_decoder:
        cross = (L, batch, cfg.max_target_len, cfg.num_kv_heads, cfg.head_dim)
        state["cross_k"] = zeros(cross, cache_dtype)
        state["cross_v"] = zeros(cross, cache_dtype)
    return state


def fill_cross_cache(model: Transformer, cfg: ModelConfig, frames, state: dict) -> dict:
    """Write each decoder layer's cross-attention keys and values of the
    encoded ``frames`` (B, S_frames, d) into ``state["cross_k"]`` and
    ``state["cross_v"]``, in place, and return the state.  ``decode_step``
    reads the whole cross cache (JAX's position ``S_cross - 1``), so
    ``S_frames`` must be the cache's length, ``max_target_len``.  The JAX
    package leaves this to its caller; the port's tests and the card check
    use it to hold decode against ``forward`` on the same frames."""
    params = model.params()
    enc_out = _run_encoder(params, cfg, frames)
    if enc_out.shape[1] != state["cross_k"].shape[2]:
        raise ValueError(f"{enc_out.shape[1]} frames; the cross cache holds "
                         f"{state['cross_k'].shape[2]} positions")
    for i, cp in enumerate(params["cross"]):
        k, v = compute_kv(cp["attn"], cfg, enc_out)
        state["cross_k"][i] = k.to(state["cross_k"].dtype)
        state["cross_v"][i] = v.to(state["cross_v"].dtype)
    return state


def _decode_attn(key: str, params: dict, cfg: ModelConfig, x, cache_k, cache_v, pos, **kw):
    """``decode_attention``, or over the rank's window of a cache whose
    sequence the model axis shards (``distributed.decode``)."""
    if tp.windowed(key):
        from repro_torch.distributed.decode import window_decode_attention

        return window_decode_attention(params, cfg, x, cache_k, cache_v, pos, **kw)
    return decode_attention(params, cfg, x, cache_k, cache_v, pos, **kw)


def _decode_rwkv(params: dict, cfg: ModelConfig, x: torch.Tensor, state: dict) -> torch.Tensor:
    eps = cfg.norm_eps
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x[:, 0], lp["ln1"], eps)
        out, wkv, xt = rwkv_time_mix_step(lp["rwkv"], cfg, h, state["wkv"][i],
                                          state["x_prev_t"][i])
        x = x + out[:, None]
        h2 = rms_norm(x[:, 0], lp["ln2"], eps)
        out2, xc = rwkv_channel_mix_step(lp["rwkv"], cfg, h2, state["x_prev_c"][i])
        x = x + out2[:, None]
        state["wkv"][i] = wkv
        state["x_prev_t"][i] = xt
        state["x_prev_c"][i] = xc
    return x


def _decode_hybrid(params: dict, cfg: ModelConfig, x: torch.Tensor, state: dict) -> torch.Tensor:
    """Each Mamba layer's state update; after every ``every``-th layer the
    shared block, reading and writing its own KV cache (one per use)."""
    eps, pos = cfg.norm_eps, state["pos"]
    shared = params.get("shared_attn")
    for i, lp in enumerate(params["layers"]):
        hin = rms_norm(x[:, 0], lp["ln1"], eps)[:, None]
        out, st = mamba_decode_step(lp["mamba"], cfg, hin,
                                    {"h": state["h"][i], "conv_buf": state["conv_buf"][i]})
        x = x + out
        state["h"][i] = st["h"]
        state["conv_buf"][i] = st["conv_buf"]
        if _applies_shared(cfg, i):
            g = i // cfg.shared_attn_every
            h = rms_norm(x[:, 0], shared["ln1"], eps)[:, None]
            out, _, _ = _decode_attn("shared_k", shared["attn"], cfg, h, state["shared_k"][g],
                                     state["shared_v"][g], pos)
            x = x + out
            x = x + swiglu(shared["ffn"], rms_norm(x, shared["ln2"], eps), cfg.d_ff)
    return x


def _decode_attention_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
                            state: dict) -> torch.Tensor:
    """Dense, MoE and frontend layers; the encoder-decoder's also read the
    cross cache, without a write and without RoPE, at position S_cross - 1."""
    eps, pos = cfg.norm_eps, state["pos"]
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["ln1"], eps)
        out, _, _ = _decode_attn("k", lp["attn"], cfg, h, state["k"][i], state["v"][i], pos)
        x = x + out
        if cfg.is_encoder_decoder:
            cp, xk, xv = params["cross"][i], state["cross_k"][i], state["cross_v"][i]
            last = xk.shape[1] * (tp.size() if tp.windowed("cross_k") else 1) - 1
            out, _, _ = _decode_attn("cross_k", cp["attn"], cfg, rms_norm(x, cp["ln"], eps), xk,
                                     xv, last, update_cache=False, rope=False)
            x = x + out
        x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], eps))
    return x


def decode_step(model: Transformer, cfg: ModelConfig, tokens, state: dict):
    """One decode step.  ``tokens``: (B,) integer ids (tensor or numpy).

    Returns ``(logits (B, padded_vocab) float32, state)``: each layer's
    caches or recurrent states are written in place at each sequence's
    position and ``pos`` advances by one.  The caller's state dict is the
    one returned.
    """
    params = model.params()
    tokens = _as_tokens(tokens, model.embed.device)
    x = tp.vocab_embed(model.embed, tokens, cfg)[:, None].to(cfg.dtype)
    if cfg.rwkv:
        x = _decode_rwkv(params, cfg, x, state)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, cfg, x, state)
    else:
        x = _decode_attention_stack(params, cfg, x, state)
    state["pos"] += 1
    x = model.final_ln(x, cfg.norm_eps)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    logits = tp.vocab_head(x[:, 0], head, cfg).float()
    return _mask_padded_vocab(logits, cfg), state
