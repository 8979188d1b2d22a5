"""Decoder-stack assembly, dense family (counterpart of
``repro/models/transformer.py``).

A model is a list of groups, each a repeating pattern of sub-layers
(``kinds``). The reference stacks a group's parameters along a leading
dim and runs them with ``jax.lax.scan``; the port keeps one parameter dict
per layer in a list and runs a Python loop. KV caches keep the reference's
layer-stacked layout ``(L, B, ...)`` (batch at dim 1) at the public
functions, so both packages' caches compare like with like.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import unported
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec

# ROADMAP items ("Modules to port") that port the other families
FAMILY_ITEMS = {
    "ssm": "slice 6, ssm family and speculative decoding",
    "hybrid": "slice 7, hybrid family",
    "moe": "later, remaining families",
    "vlm": "later, remaining families",
    "audio": "later, remaining families",
}


def groups_for(cfg: ModelConfig) -> list[tuple[str, tuple[str, ...], int]]:
    """[(group_name, kinds, n_repeat)] — static model structure."""
    if cfg.family != "dense":
        raise unported(f"the {cfg.family!r} family",
                       FAMILY_ITEMS.get(cfg.family, "later"))
    return [("g0", ("attn",), cfg.n_layers)]


def attn_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if cfg.attn_variant == "sliding" else 0


def sublayer_spec(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "attn": attn_mod.attn_spec(cfg),
            "ln2": rmsnorm_spec(d),
            "mlp": mlp_spec(d, cfg.d_ff, attn_mod.param_dtype(cfg))}


def sublayer_adapter_spec(cfg: ModelConfig, kind: str) -> dict:
    """PEFT adapters of one sub-layer: prefix-KV slots and LoRA."""
    p = cfg.peft
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = attn_mod.param_dtype(cfg)
    out: dict = {}
    if p.n_prefix > 0:
        out["prefix"] = {"k": ParamSpec((p.n_prefix, nkv, hd), dt),
                         "v": ParamSpec((p.n_prefix, nkv, hd), dt)}
    if p.lora_rank > 0:
        dims = {"q": nh * hd, "k": nkv * hd, "v": nkv * hd, "o": d}
        out["lora"] = {
            t: {"a": ParamSpec((d if t != "o" else nh * hd, p.lora_rank), dt,
                               init="scaled"),
                "b": ParamSpec((p.lora_rank, dims[t]), dt, init="zeros")}
            for t in p.lora_targets}
    return out


def stack_spec(cfg: ModelConfig) -> dict:
    """Backbone layer specs: {group: [per-layer {sub_i: spec}]}."""
    return {name: [{f"s{i}": sublayer_spec(cfg, k)
                    for i, k in enumerate(kinds)} for _ in range(n)]
            for name, kinds, n in groups_for(cfg)}


def adapter_stack_spec(cfg: ModelConfig) -> dict:
    return {name: [{f"s{i}": sublayer_adapter_spec(cfg, k)
                    for i, k in enumerate(kinds)} for _ in range(n)]
            for name, kinds, n in groups_for(cfg)}


def cache_group_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Decode-cache spec: {group: {sub_i: layer-stacked cache spec}}."""
    return {name: {f"s{i}": attn_mod.cache_spec(
                       cfg, batch, seq_len, window=attn_window(cfg, k),
                       layers=n)
                   for i, k in enumerate(kinds)}
            for name, kinds, n in groups_for(cfg)}


def _layer_adapters(adapters: dict, name: str, n: int) -> list:
    return adapters.get(name) or [{} for _ in range(n)]


def stack_seq(params: dict, adapters: dict, x: torch.Tensor,
              cfg: ModelConfig, *, positions: torch.Tensor,
              make_cache: bool = False, remat: bool = False, cache_len=None,
              lengths=None, adapter_ids=None):
    """Run all groups over a full sequence. ``lengths`` (B,) serves ragged
    right-padded rows (per-row sentinel cache positions past each row's
    length). ``adapter_ids`` (B,) serves a multi-tenant wave: each layer's
    adapter leaves carry a leading ``n_slots`` dim (the AdapterBank
    layout, the port's form of the reference's ``(L, n_slots, ...)``) and
    row b uses slot ``adapter_ids[b]``. ``remat`` re-runs each layer's
    forward in the backward instead of keeping its activations
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scanned layer body). Returns (x, caches | None, aux_sum)."""
    caches: dict = {}
    for name, kinds, n in groups_for(cfg):
        per_layer = []
        for lp, la in zip(params[name], _layer_adapters(adapters, name, n)):
            def body(x, lp=lp, la=la):
                lcache = {}
                for i, k in enumerate(kinds):
                    key = f"s{i}"
                    p, a = lp[key], la.get(key, {})
                    h, c = attn_mod.attention_seq(
                        p["attn"], a, rmsnorm(p["ln1"], x), cfg,
                        positions=positions, window=attn_window(cfg, k),
                        make_cache=make_cache, cache_len=cache_len,
                        lengths=lengths, adapter_ids=adapter_ids)
                    x = x + h
                    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x))
                    if c is not None:
                        lcache[key] = c
                return x, lcache

            if remat:
                x, lcache = checkpoint(body, x, use_reentrant=False)
            else:
                x, lcache = body(x)
            per_layer.append(lcache)
        if make_cache:
            caches[name] = {key: {leaf: torch.stack([c[key][leaf]
                                                     for c in per_layer])
                                  for leaf in per_layer[0][key]}
                            for key in per_layer[0]}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (caches if make_cache else None), aux


def stack_decode(params: dict, adapters: dict, x: torch.Tensor,
                 caches: dict, cfg: ModelConfig, *, pos: torch.Tensor,
                 active=None, adapter_ids=None):
    """Single-token step through all groups; ``caches`` are updated in
    place (each layer writes its slice of the (L, B, ...) leaves).
    ``pos`` (B,) per row; ``active`` (B,) bool freezes retired rows' caches;
    ``adapter_ids`` (B,) as in :func:`stack_seq`. Returns (x, caches)."""
    for name, kinds, n in groups_for(cfg):
        gc = caches[name]
        for l, (lp, la) in enumerate(zip(params[name],
                                         _layer_adapters(adapters, name, n))):
            for i, k in enumerate(kinds):
                key = f"s{i}"
                p, a = lp[key], la.get(key, {})
                lc = {leaf: t[l] for leaf, t in gc[key].items()}
                h, _ = attn_mod.attention_decode(
                    p["attn"], a, rmsnorm(p["ln1"], x), lc, cfg, pos=pos,
                    window=attn_window(cfg, k), active=active,
                    adapter_ids=adapter_ids)
                x = x + h
                x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x))
    return x, caches
