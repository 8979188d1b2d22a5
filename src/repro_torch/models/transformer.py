"""Decoder-stack assembly, dense, vlm, moe, ssm and hybrid families
(counterpart of ``repro/models/transformer.py``; the audio family's
encoder-decoder stack is ``models/encdec.py``).

A model is a list of groups, each a repeating pattern of sub-layers
(``kinds``: ``attn``, ``moe`` (attention and a mixture-of-experts FFN),
``ssm`` or ``rglru``, the last a recurrent block plus a gated MLP,
Griffin-style). Dense, vlm, moe and ssm models are one group;
recurrentgemma is a repeated ``(rglru, rglru, attn)`` group plus a
``tail`` group that runs once. The reference stacks a group's
parameters along a leading dim and runs them with ``jax.lax.scan``; the
port keeps one parameter dict per layer in a list and runs a Python loop.
Decode caches keep the reference's layer-stacked layout ``(L, B, ...)``
(batch at dim 1) at the public functions, so both packages' caches compare
like with like; decode and verify write them in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import dtensor as dt

# sub-layer kinds that carry attention, and so a KV cache that can be
# paged, snapshotted and rolled back: a moe sub-layer is attention
# followed by the expert FFN
ATTN_KINDS = ("attn", "moe")

def groups_for(cfg: ModelConfig) -> list[tuple[str, tuple[str, ...], int]]:
    """[(group_name, kinds, n_repeat)] — static model structure."""
    if cfg.family in ("ssm", "moe"):
        return [("g0", (cfg.family,), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat, tail = tuple(cfg.hybrid.pattern), tuple(cfg.hybrid.tail)
        out = [("g0", pat, (cfg.n_layers - len(tail)) // len(pat))]
        if tail:
            out.append(("tail", tail, 1))
        return out
    # dense, vlm (and the audio decoder's layout, built in encdec.py)
    return [("g0", ("attn",), cfg.n_layers)]


def attn_window(cfg: ModelConfig, kind: str) -> int:
    """Every attention layer of a hybrid is local (``cfg.hybrid.window``)."""
    if cfg.family == "hybrid":
        return cfg.hybrid.window
    return cfg.sliding_window if cfg.attn_variant == "sliding" else 0


def sublayer_spec(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": rmsnorm_spec(d), "mix": ssm_mod.ssm_spec(cfg)}
    if kind == "rglru":
        return {"ln1": rmsnorm_spec(d), "mix": rglru_mod.rglru_spec(cfg),
                "ln2": rmsnorm_spec(d),
                "mlp": mlp_spec(d, cfg.d_ff, attn_mod.param_dtype(cfg))}
    if kind == "moe":
        return {"ln1": rmsnorm_spec(d), "attn": attn_mod.attn_spec(cfg),
                "ln2": rmsnorm_spec(d), "moe": moe_mod.moe_spec(cfg)}
    return {"ln1": rmsnorm_spec(d), "attn": attn_mod.attn_spec(cfg),
            "ln2": rmsnorm_spec(d),
            "mlp": mlp_spec(d, cfg.d_ff, attn_mod.param_dtype(cfg))}


def sublayer_adapter_spec(cfg: ModelConfig, kind: str) -> dict:
    """PEFT adapters of one sub-layer: prefix-KV slots and LoRA for
    attention; the learned initial state alone for ssm and rglru (no
    prefix, no LoRA)."""
    p = cfg.peft
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = attn_mod.param_dtype(cfg)
    out: dict = {}
    if kind == "ssm":
        if p.state_prompt:
            out["state0"] = ParamSpec((cfg.d_inner, cfg.ssm.d_state),
                                      torch.float32, ("d_inner", "state"),
                                      init="zeros")
        return out
    if kind == "rglru":
        if p.state_prompt:
            out["state0"] = ParamSpec((cfg.lru_width,), torch.float32,
                                      ("lru",), init="zeros")
        return out
    if p.n_prefix > 0:
        pfx = ("prefix", "kv_heads", "head_dim")
        out["prefix"] = {"k": ParamSpec((p.n_prefix, nkv, hd), dt, pfx),
                         "v": ParamSpec((p.n_prefix, nkv, hd), dt, pfx)}
    if p.lora_rank > 0:
        dims = {"q": nh * hd, "k": nkv * hd, "v": nkv * hd, "o": d}
        out["lora"] = {
            t: {"a": ParamSpec((d if t != "o" else nh * hd, p.lora_rank), dt,
                               ("fsdp", "lora_rank"), init="scaled"),
                "b": ParamSpec((p.lora_rank, dims[t]), dt,
                               ("lora_rank", None), init="zeros")}
            for t in p.lora_targets}
    return out


def _stack(tree, n: int) -> list:
    """``n`` layers of a per-layer spec tree: the port's form of the
    reference's leading stacking dim."""
    return [tree for _ in range(n)]


def stack_spec(cfg: ModelConfig) -> dict:
    """Backbone layer specs: {group: [per-layer {sub_i: spec}]}."""
    return {name: [{f"s{i}": sublayer_spec(cfg, k)
                    for i, k in enumerate(kinds)} for _ in range(n)]
            for name, kinds, n in groups_for(cfg)}


def adapter_stack_spec(cfg: ModelConfig) -> dict:
    return {name: [{f"s{i}": sublayer_adapter_spec(cfg, k)
                    for i, k in enumerate(kinds)} for _ in range(n)]
            for name, kinds, n in groups_for(cfg)}


def cache_group_spec(cfg: ModelConfig, batch: int, seq_len: int, *,
                     paged=None) -> dict:
    """Decode-cache spec: {group: {sub_i: layer-stacked cache spec}}.
    ``paged=(n_blocks, block_size)`` switches the eligible sub-layers
    (full-window attention, :func:`paged_subs`) to the block-pool layout;
    sliding-window and recurrent sub-layers keep their dense per-row
    layout."""
    def one(k: str, n: int) -> dict:
        if k == "ssm":
            return ssm_mod.ssm_cache_spec(cfg, batch, layers=n)
        if k == "rglru":
            return rglru_mod.rglru_cache_spec(cfg, batch, layers=n)
        return attn_mod.cache_spec(cfg, batch, seq_len,
                                   window=attn_window(cfg, k), layers=n,
                                   paged=paged)
    return {name: {f"s{i}": one(k, n) for i, k in enumerate(kinds)}
            for name, kinds, n in groups_for(cfg)}


def paged_subs(cfg: ModelConfig) -> list[tuple[str, str]]:
    """[(group, sub_key)] of the sub-layers eligible for the paged KV
    layout: full-window (window 0) attention and moe. Sliding-window
    layers keep their W-slot rolling buffer and recurrent layers have O(1)
    state: a config with no eligible sub-layer (ssm, and hybrid, whose
    attention is all local) still serves through the paged engine, it
    just commits nothing to the pool."""
    return [(name, f"s{i}") for name, kinds, _ in groups_for(cfg)
            for i, k in enumerate(kinds)
            if k in ATTN_KINDS and not attn_window(cfg, k)]


def _layer_adapters(adapters: dict, name: str, n: int) -> list:
    return adapters.get(name) or [{} for _ in range(n)]


def _select_state0(a: dict, adapter_ids):
    """Gather each row's state prompt from a bank's stacked (n_slots, ...)
    leaf."""
    if adapter_ids is None or not a or "state0" not in a:
        return a
    ids = adapter_ids.to(device=a["state0"].device, dtype=torch.long)
    if dt.is_dt(a["state0"]):                        # a slot-sharded bank
        ids = dt.as_replicated(ids, a["state0"].device_mesh)
    return {**a, "state0": a["state0"].index_select(0, ids)}


def _freeze_inactive(old: dict, new: dict, active) -> None:
    """Write a recurrent sub-layer's new state into its cache views, in
    place; retired rows (``active`` False) keep their old state. On a
    mesh each rank writes its own shard."""
    for leaf, o in old.items():
        n, act = new[leaf], active
        if dt.is_dt(o):
            n = dt.local_as(n, o.placements)
            act = None if act is None else dt.rows_of(act, o)
            o = o.to_local()
        n = n.to(o.dtype)
        if act is not None:
            n = torch.where(act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
        o.copy_(n)


# recurrent sub-layer kinds -> (seq, decode, verify) of their mixer
_RECURRENT = {
    "ssm": (ssm_mod.ssm_seq, ssm_mod.ssm_decode, ssm_mod.ssm_verify),
    "rglru": (rglru_mod.rglru_seq, rglru_mod.rglru_decode,
              rglru_mod.rglru_verify),
}


def _ffn(p: dict, x, cfg: ModelConfig):
    """The sub-layer's feed-forward block: the MLP, or the moe FFN and its
    aux loss, in span ``layer.ffn``; ssm has none. Returns (x, aux or
    None)."""
    if "moe" not in p and "mlp" not in p:
        return x, None
    with telemetry.current().span("layer.ffn"):
        if "moe" in p:
            h, aux = moe_mod.moe_apply(p["moe"], rmsnorm(p["ln2"], x), cfg)
            return x + h, aux
        return x + mlp(p["mlp"], rmsnorm(p["ln2"], x)), None


def _apply_seq(kind: str, p: dict, a: dict, x, cfg: ModelConfig, *,
               positions, make_cache: bool, cache_len, lengths,
               adapter_ids):
    """One full-sequence sub-layer (attention in span ``layer.attn``).
    Returns (x, cache or None, aux or None)."""
    if kind in _RECURRENT:
        h, c = _RECURRENT[kind][0](p["mix"], _select_state0(a, adapter_ids),
                                   rmsnorm(p["ln1"], x), cfg,
                                   make_cache=make_cache, lengths=lengths)
    else:
        with telemetry.current().span("layer.attn"):
            h, c = attn_mod.attention_seq(
                p["attn"], a, rmsnorm(p["ln1"], x), cfg,
                positions=positions, window=attn_window(cfg, kind),
                make_cache=make_cache, cache_len=cache_len, lengths=lengths,
                adapter_ids=adapter_ids)
    x, aux = _ffn(p, x + h, cfg)
    return x, c, aux


def stack_seq(params: dict, adapters: dict, x: torch.Tensor,
              cfg: ModelConfig, *, positions: torch.Tensor,
              make_cache: bool = False, remat: bool = False, cache_len=None,
              lengths=None, adapter_ids=None):
    """Run all groups over a full sequence. ``lengths`` (B,) serves ragged
    right-padded rows: attention caches get per-row sentinel positions
    past each row's length, and ssm sub-layers hold their state over the
    padded columns, so each row's caches are bitwise those it would build
    alone. ``adapter_ids`` (B,) serves a multi-tenant wave: each layer's
    adapter leaves carry a leading ``n_slots`` dim (the AdapterBank
    layout, the port's form of the reference's ``(L, n_slots, ...)``) and
    row b uses slot ``adapter_ids[b]``. ``remat`` re-runs each layer's
    forward in the backward instead of keeping its activations
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scanned layer body). The moe sub-layers' aux losses are summed over
    the layers, inside the re-materialised body. Returns (x, caches |
    None, aux_sum)."""
    caches: dict = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, kinds, n in groups_for(cfg):
        per_layer = []
        for lp, la in zip(params[name], _layer_adapters(adapters, name, n)):
            # kinds bound here too: a recompute under remat runs after the
            # loop has moved on to the next group
            def body(x, aux, lp=lp, la=la, kinds=kinds):
                lcache = {}
                for i, k in enumerate(kinds):
                    key = f"s{i}"
                    x, c, a_ = _apply_seq(k, lp[key], la.get(key, {}), x,
                                          cfg, positions=positions,
                                          make_cache=make_cache,
                                          cache_len=cache_len,
                                          lengths=lengths,
                                          adapter_ids=adapter_ids)
                    if c is not None:
                        lcache[key] = c
                    if a_ is not None:
                        aux = aux + a_
                return x, lcache, aux

            if remat:
                x, lcache, aux = checkpoint(body, x, aux,
                                            use_reentrant=False)
            else:
                x, lcache, aux = body(x, aux)
            per_layer.append(lcache)
        if make_cache:
            caches[name] = {key: {leaf: torch.stack([c[key][leaf]
                                                     for c in per_layer])
                                  for leaf in per_layer[0][key]}
                            for key in per_layer[0]}
    return x, (caches if make_cache else None), aux


def stack_decode(params: dict, adapters: dict, x: torch.Tensor,
                 caches: dict, cfg: ModelConfig, *, pos: torch.Tensor,
                 active=None, adapter_ids=None):
    """Single-token step through all groups; ``caches`` are updated in
    place (each layer writes its slice of the (L, B, ...) leaves).
    ``pos`` (B,) per row; ``active`` (B,) bool freezes retired rows' caches;
    ``adapter_ids`` (B,) as in :func:`stack_seq`. A moe sub-layer's aux
    loss is dropped, as in the reference. Each attention is span
    ``layer.attn``, each FFN ``layer.ffn``. Returns (x, caches)."""
    tel = telemetry.current()
    for name, kinds, n in groups_for(cfg):
        gc = caches[name]
        for l, (lp, la) in enumerate(zip(params[name],
                                         _layer_adapters(adapters, name, n))):
            for i, k in enumerate(kinds):
                key = f"s{i}"
                p, a = lp[key], la.get(key, {})
                lc = {leaf: t[l] for leaf, t in gc[key].items()}
                if k in _RECURRENT:
                    h, new = _RECURRENT[k][1](p["mix"], a,
                                              rmsnorm(p["ln1"], x), lc, cfg)
                    _freeze_inactive(lc, new, active)
                else:
                    with tel.span("layer.attn"):
                        h, _ = attn_mod.attention_decode(
                            p["attn"], a, rmsnorm(p["ln1"], x), lc, cfg,
                            pos=pos, window=attn_window(cfg, k),
                            active=active, adapter_ids=adapter_ids)
                x, _ = _ffn(p, x + h, cfg)
    return x, caches


def rec_cache_part(caches: dict) -> dict:
    """The recurrent ({'h', 'conv'}) sub-trees of a decode-cache tree: what
    speculative decoding snapshots per step for rollback (attention caches,
    which carry a 'pos' or 'table' leaf, roll back by slot restore)."""
    return {g: {s: c for s, c in grp.items()
                if "pos" not in c and "table" not in c}
            for g, grp in caches.items()}


def stack_chunk(params: dict, adapters: dict, x: torch.Tensor,
                caches: dict, cfg: ModelConfig, *, start: torch.Tensor,
                valid: torch.Tensor, adapter_ids=None):
    """A length-W suffix chunk through a fully paged stack (prefix
    sharing): x (B, W, d) embedded suffix, row b at positions
    ``start[b] .. start[b]+W-1``, ``valid`` (B, W) real tokens. Every
    sub-layer must hold a paged cache (the engine gates prefix sharing to
    such configs); the pools are written in place. Returns (x, caches)."""
    for name, kinds, n in groups_for(cfg):
        gc = caches[name]
        for l, (lp, la) in enumerate(zip(params[name],
                                         _layer_adapters(adapters, name, n))):
            for i, k in enumerate(kinds):
                key = f"s{i}"
                if "table" not in gc[key]:
                    raise NotImplementedError(
                        "stack_chunk requires a fully paged attention stack")
                p, a = lp[key], la.get(key, {})
                lc = {leaf: t[l] for leaf, t in gc[key].items()}
                h, _ = attn_mod.attention_chunk_paged(
                    p["attn"], a, rmsnorm(p["ln1"], x), lc, cfg, start=start,
                    valid=valid, adapter_ids=adapter_ids)
                x, _ = _ffn(p, x + h, cfg)
    return x, caches


def stack_verify(params: dict, adapters: dict, x: torch.Tensor,
                 caches: dict, cfg: ModelConfig, *, pos: torch.Tensor,
                 adapter_ids=None, active=None):
    """A length-T chunk per row through all groups (speculative verify).

    Attention sub-layers write the chunk's K/V into their cache in place
    and attend the updated cache (:func:`attention.attention_verify`: one
    cache read for T tokens); recurrent (ssm, rglru) sub-layers chain T
    exact decode steps and emit a state snapshot per step, leaving their
    cache as it was.
    Returns (x, caches, rec_snaps): ``rec_snaps`` mirrors
    :func:`rec_cache_part` with a per-step axis at dim 2 ((L, B, T, ...)).
    ``core/spec_decode.py::rollback_caches`` then brings each row to its
    accepted length (the reference returns new caches that assume full
    acceptance; here the attention caches are the live ones, and the
    recurrent ones take their snapshot at rollback)."""
    snaps: dict = {}
    for name, kinds, n in groups_for(cfg):
        gc = caches[name]
        per: dict = {}
        for l, (lp, la) in enumerate(zip(params[name],
                                         _layer_adapters(adapters, name, n))):
            for i, k in enumerate(kinds):
                key = f"s{i}"
                p, a = lp[key], la.get(key, {})
                lc = {leaf: t[l] for leaf, t in gc[key].items()}
                if k in _RECURRENT:
                    h, s = _RECURRENT[k][2](p["mix"], a,
                                            rmsnorm(p["ln1"], x), lc, cfg)
                    per.setdefault(key, []).append(s)
                else:
                    h, _ = attn_mod.attention_verify(
                        p["attn"], a, rmsnorm(p["ln1"], x), lc, cfg,
                        pos=pos, window=attn_window(cfg, k),
                        adapter_ids=adapter_ids, active=active)
                x, _ = _ffn(p, x + h, cfg)
        snaps[name] = {key: {leaf: torch.stack([s[leaf] for s in lst])
                             for leaf in lst[0]}
                       for key, lst in per.items()}
    return x, caches, snaps
