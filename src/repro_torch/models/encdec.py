"""Whisper-style encoder-decoder backbone, the audio family (counterpart of
``repro/models/encdec.py``).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the inputs are precomputed frame embeddings (B, n_frames,
d_model). This module is the transformer that consumes them: a
non-causal encoder stack and a causal decoder stack with per-layer cross
attention, learned absolute positions and no RoPE. The reference stacks
each stack's layers along a leading dim under ``jax.lax.scan``; the port
keeps one parameter dict per layer in a list and runs a Python loop.
Decode caches keep the reference's layer-stacked layout: ``self``
{'k', 'v', 'pos'} (L, B, S, ...) and ``cross`` {'k', 'v', 'pos'} (L, B,
F, ...), the cross ``pos`` broadcast per row so that every leaf has batch
at dim 1 (the engine's row-wise refill merges them). On a mesh the
encoder's and the decoder's activations keep their rows on the batch
axes from the position embedding on (``shard``), as the decoder-only
stacks' do from the token embedding.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import layernorm, layernorm_spec, mlp, mlp_spec
from repro_torch.models.params import ParamSpec
from repro_torch.models.transformer import (_layer_adapters, _stack,
                                            sublayer_adapter_spec)
from repro_torch.sharding.rules import shard

# whisper's own decoder context is 448; the reference sizes the learned
# positions to its largest prefill shape, and the port keeps its layout
DEC_POSITIONS = 32768


def enc_layer_spec(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, attn_mod.param_dtype(cfg)
    return {"ln1": layernorm_spec(d), "attn": attn_mod.attn_spec(cfg),
            "ln2": layernorm_spec(d), "mlp": mlp_spec(d, cfg.d_ff, dt)}


def dec_layer_spec(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, attn_mod.param_dtype(cfg)
    return {"ln1": layernorm_spec(d), "self": attn_mod.attn_spec(cfg),
            "ln2": layernorm_spec(d), "cross": attn_mod.attn_spec(cfg),
            "ln3": layernorm_spec(d), "mlp": mlp_spec(d, cfg.d_ff, dt)}


def encdec_stack_spec(cfg: ModelConfig) -> dict:
    a, d, dt = cfg.audio, cfg.d_model, attn_mod.param_dtype(cfg)
    return {
        "enc_pos": ParamSpec((a.n_audio_frames, d), dt, ("frames", "fsdp")),
        "dec_pos": ParamSpec((DEC_POSITIONS, d), dt, (None, "fsdp")),
        "enc": _stack(enc_layer_spec(cfg), a.n_enc_layers),
        "dec": _stack(dec_layer_spec(cfg), cfg.n_layers),
        "enc_ln": layernorm_spec(d),
    }


def encdec_adapter_spec(cfg: ModelConfig) -> dict:
    """Prefix slots and LoRA on the encoder's attention and the decoder's
    self-attention; cross attention has none."""
    return {
        "enc": _stack(sublayer_adapter_spec(cfg, "attn"),
                      cfg.audio.n_enc_layers),
        "dec": _stack(sublayer_adapter_spec(cfg, "attn"), cfg.n_layers),
    }


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(params: dict, adapters: dict, frames: torch.Tensor,
           cfg: ModelConfig, remat: bool = False) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder states (B, F, d).
    ``remat`` re-runs each layer's forward in the backward."""
    F = frames.shape[1]
    x = frames + params["enc_pos"][:F][None].to(frames.dtype)
    x = shard(x, "batch", "seq", "d_model")
    pos = _arange(F, frames.device)
    layers = params["enc"]
    for lp, la in zip(layers, _layer_adapters(adapters, "enc",
                                              len(layers))):
        def body(x, lp=lp, la=la):
            h, _ = attn_mod.attention_seq(
                lp["attn"], la, layernorm(lp["ln1"], x), cfg, positions=pos,
                causal=False, use_rope=False)
            x = x + h
            return x + mlp(lp["mlp"], layernorm(lp["ln2"], x))

        x = checkpoint(body, x, use_reentrant=False) if remat else body(x)
    return layernorm(params["enc_ln"], x)


def cross_cache(p: dict, enc_out: torch.Tensor, cfg: ModelConfig) -> dict:
    """One decoder layer's static cross-attention cache: the encoder
    states' K and V (B, F, Hkv, D) through the layer's cross projections,
    the same operations as the cross attention's own, and the frames'
    positions broadcast per row (B, F)."""
    B, F = enc_out.shape[:2]
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = attn_mod._proj(enc_out, p["wk"], p.get("bk"), None, 1.0)
    v = attn_mod._proj(enc_out, p["wv"], p.get("bv"), None, 1.0)
    return {"k": k.reshape(B, F, nkv, hd), "v": v.reshape(B, F, nkv, hd),
            "pos": _arange(F, enc_out.device)[None].expand(B, F)}


def decode_seq(params: dict, adapters: dict, tok_emb: torch.Tensor,
               enc_out: torch.Tensor, cfg: ModelConfig, *,
               make_cache: bool = False, remat: bool = False,
               cache_len=None, lengths=None):
    """Teacher-forced decoder pass. tok_emb: (B, S, d). Returns (x,
    caches or None).

    ``lengths`` (B,) marks ragged right-padded decoder prompts: the self
    cache gets the sentinel position past each row's length (the cross
    cache is static per request and unaffected)."""
    B, S, _ = tok_emb.shape
    F = enc_out.shape[1]
    x = tok_emb + params["dec_pos"][:S][None].to(tok_emb.dtype)
    x = shard(x, "batch", "seq", "d_model")
    pos = _arange(S, tok_emb.device)
    enc_pos = _arange(F, tok_emb.device)
    layers = params["dec"]
    per_layer = []
    for lp, la in zip(layers, _layer_adapters(adapters, "dec",
                                              len(layers))):
        def body(x, lp=lp, la=la):
            h, self_cache = attn_mod.attention_seq(
                lp["self"], la, layernorm(lp["ln1"], x), cfg, positions=pos,
                causal=True, use_rope=False, make_cache=make_cache,
                cache_len=cache_len, lengths=lengths)
            x = x + h
            h, _ = attn_mod.attention_seq(
                lp["cross"], None, layernorm(lp["ln2"], x), cfg,
                positions=pos, kv_x=enc_out, kv_positions=enc_pos,
                causal=False, use_rope=False)
            x = x + h
            return x + mlp(lp["mlp"], layernorm(lp["ln3"], x)), self_cache

        if remat:
            x, self_cache = checkpoint(body, x, use_reentrant=False)
        else:
            x, self_cache = body(x)
        if make_cache:
            per_layer.append({"self": self_cache,
                              "cross": cross_cache(lp["cross"], enc_out,
                                                   cfg)})
    if not make_cache:
        return x, None
    return x, {part: {leaf: torch.stack([c[part][leaf] for c in per_layer])
                      for leaf in per_layer[0][part]}
               for part in ("self", "cross")}


def decode_step(params: dict, adapters: dict, tok_emb: torch.Tensor,
                caches: dict, cfg: ModelConfig, *, pos: torch.Tensor,
                active=None):
    """One decoder token. tok_emb: (B, 1, d); ``pos`` (B,). The self
    caches are written in place (a retired row's, ``active`` False, is
    left as it was); the cross caches are read. Returns (x, caches)."""
    B = tok_emb.shape[0]
    pos = pos.to(torch.int64).expand(B)
    x = tok_emb + params["dec_pos"].index_select(0, pos)[:, None] \
        .to(tok_emb.dtype)
    x = shard(x, "batch", "seq", "d_model")
    layers = params["dec"]
    for l, (lp, la) in enumerate(zip(layers, _layer_adapters(
            adapters, "dec", len(layers)))):
        sc = {leaf: t[l] for leaf, t in caches["self"].items()}
        cc = {leaf: t[l] for leaf, t in caches["cross"].items()}
        h, _ = attn_mod.attention_decode(
            lp["self"], la, layernorm(lp["ln1"], x), sc, cfg, pos=pos,
            use_rope=False, active=active)
        x = x + h
        h, _ = attn_mod.attention_decode(
            lp["cross"], None, layernorm(lp["ln2"], x), cc, cfg, pos=pos,
            cross=True)
        x = x + h
        x = x + mlp(lp["mlp"], layernorm(lp["ln3"], x))
    return x, caches


def encdec_cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    L, F = cfg.n_layers, cfg.audio.n_audio_frames
    shape = (L, batch, F, cfg.n_kv_heads, cfg.head_dim_)
    dt = attn_mod.param_dtype(cfg)
    axes = (None, "batch", "frames", "kv_heads", "head_dim")
    return {
        "self": attn_mod.cache_spec(cfg, batch, seq_len, layers=L),
        "cross": {"k": ParamSpec(shape, dt, axes, init="zeros"),
                  "v": ParamSpec(shape, dt, axes, init="zeros"),
                  "pos": ParamSpec((L, batch, F), torch.int32, axes[:3],
                                   init="zeros")},
    }
