"""GQA attention with prefix-KV prompts, LoRA, sliding window and KV
caching: the dense parts of ``repro/models/attention.py``.

Each layer owns ``n_p`` learned prefix key/value slots, visible to every
query and carrying no rotary phase (position < 0 in the masking rules of
``kernels/ref.py``).

- prefill: full-sequence flash attention (``kernels/ops.py``), which also
  builds the layer's KV cache (a rolling buffer for the sliding variant);
- decode: single-token flash decode against the cache, after writing the
  token's K/V at slot ``pos`` (``pos % window`` for sliding).

Decode writes the cache IN PLACE (the reference returns a new array):
a retired row (``active`` false) or a slot past the buffer writes back
the value already there, which is the port's form of the reference's
out-of-bounds ``mode="drop"`` scatter.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamSpec

SENTINEL = 10 ** 9


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def attn_spec(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = param_dtype(cfg)
    s = {
        "wq": ParamSpec((d, nh * hd), dt, init="scaled"),
        "wk": ParamSpec((d, nkv * hd), dt, init="scaled"),
        "wv": ParamSpec((d, nkv * hd), dt, init="scaled"),
        "wo": ParamSpec((nh * hd, d), dt, init="scaled"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((nh * hd,), dt, init="zeros")
        s["bk"] = ParamSpec((nkv * hd,), dt, init="zeros")
        s["bv"] = ParamSpec((nkv * hd,), dt, init="zeros")
    return s


def _proj(x, w, bias, lora, scale, adapter_ids=None):
    """Projection with optional LoRA branch (the fused kernel).

    Multi-tenant serving passes ``adapter_ids`` (one slot id per batch row)
    with ``lora`` leaves carrying a leading ``n_slots`` dim (the
    AdapterBank layout); the un-reshaped x then goes to the multi-LoRA
    kernels, so a 3-D prefill x reaches the seq kernel and a decode x the
    rows kernel."""
    if lora is not None:
        if adapter_ids is not None:
            return kops.lora_bgmv(x, w, lora["a"], lora["b"], adapter_ids,
                                  scale, bias)
        shp = x.shape
        y = kops.lora_matmul(x.reshape(-1, shp[-1]), w, lora["a"], lora["b"],
                             scale, bias)
        return y.reshape(*shp[:-1], w.shape[-1])
    return kops.lora_matmul(x, w, bias=bias)


def _lora_scale(cfg: ModelConfig) -> float:
    return cfg.peft.lora_alpha / max(cfg.peft.lora_rank, 1)


def _qkv(params, adapters, x, cfg: ModelConfig, adapter_ids=None):
    """q, k, v with LoRA, reshaped to (B, S, H, D)."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids)
    k = _proj(x, params["wk"], params.get("bk"), lora.get("k"), ls,
              adapter_ids)
    v = _proj(x, params["wv"], params.get("bv"), lora.get("v"), ls,
              adapter_ids)
    B, S = x.shape[:2]
    return (q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd),
            v.reshape(B, S, nkv, hd))


def _prefix_slots(pfx: dict, B: int, adapter_ids=None):
    """The layer's prefix-KV slots per batch row, (B, n_p, Hkv, D): one
    bank broadcast over the batch, or with ``adapter_ids`` each row's own
    domain's slots gathered from the stacked (n_slots, n_p, Hkv, D) bank."""
    if adapter_ids is not None:
        ids = adapter_ids.to(device=pfx["k"].device, dtype=torch.long)
        return pfx["k"].index_select(0, ids), pfx["v"].index_select(0, ids)
    return (pfx["k"][None].expand(B, *pfx["k"].shape),
            pfx["v"][None].expand(B, *pfx["v"].shape))


def _with_prefix(k, v, adapters, B, adapter_ids=None):
    """Prepend the layer's prefix-KV slots (see :func:`_prefix_slots`)."""
    pfx = (adapters or {}).get("prefix")
    if pfx is None:
        return k, v, 0
    pk, pv = _prefix_slots(pfx, B, adapter_ids)
    n_p = pk.shape[1]
    return (torch.cat([pk.to(k.dtype), k], 1),
            torch.cat([pv.to(v.dtype), v], 1), n_p)


def attention_seq(params: dict, adapters: Optional[dict], x: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  make_cache: bool = False, cache_len: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None,
                  adapter_ids: Optional[torch.Tensor] = None):
    """Returns (out (B, S, d_model), cache or None).

    ``lengths`` (B,) marks ragged right-padded rows: row b's valid tokens
    are columns ``[0, lengths[b])``. Padding sits on the right and masking
    is causal, so valid rows never see padded columns; the per-row cache
    ``pos`` plane (B, L) carries the ``+1e9`` sentinel beyond each row's
    length, which keeps padded K/V invisible to decode. ``adapter_ids``
    (B,) selects each row's adapters from stacked (n_slots, ...) leaves
    (multi-tenant serving)."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, adapters, x, cfg, adapter_ids)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    kp, vp, n_p = _with_prefix(k, v, adapters, B, adapter_ids)
    pos32 = positions.to(torch.int32)
    kv_pos = torch.cat([pos32.new_full((n_p,), -1), pos32]) if n_p else pos32
    out = kops.flash_attention(q, kp, vp, q_pos=pos32, kv_pos=kv_pos,
                               window=window, causal=causal)
    out = out.reshape(B, S, -1)
    y = _proj(out, params["wo"], None,
              (adapters or {}).get("lora", {}).get("o"), _lora_scale(cfg),
              adapter_ids)

    cache = None
    if make_cache:
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device) \
            if lengths is None else lengths.to(torch.int32)
        if window and window > 0:                     # rolling buffer, W slots
            W = window
            # slot s holds the largest position p = s (mod W) with
            # p <= len_b - 1; p < 0 means the slot is empty
            s_idx = torch.arange(W, dtype=torch.int64, device=x.device)
            p = s_idx[None, :] + W * torch.div(
                lens.long()[:, None] - 1 - s_idx[None, :], W,
                rounding_mode="floor")                # (B, W)
            valid = (p >= 0)[:, :, None, None]
            gidx = p.clamp(0, S - 1)[:, :, None, None].expand(
                -1, -1, k.shape[2], k.shape[3])
            cache = {
                "k": torch.where(valid, torch.gather(k, 1, gidx),
                                 torch.zeros((), dtype=k.dtype,
                                             device=k.device)),
                "v": torch.where(valid, torch.gather(v, 1, gidx),
                                 torch.zeros((), dtype=v.dtype,
                                             device=v.device)),
                # +1e9 sentinel: empty slots must be invisible (a negative
                # position would mark them as always-visible prefix slots)
                "pos": torch.where(p >= 0, p, SENTINEL).to(torch.int32),
            }
        else:
            L = max(cache_len or S, S)
            pad = L - S
            base = F.pad(pos32, (0, pad), value=SENTINEL)       # (L,)
            cols = torch.arange(L, device=x.device)[None, :]
            cache = {
                "k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
                "pos": torch.where(cols < lens[:, None], base[None, :],
                                   SENTINEL).to(torch.int32),
            }
    return y, cache


def attention_decode(params: dict, adapters: Optional[dict],
                     x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
                     pos: torch.Tensor, window: int = 0,
                     active: Optional[torch.Tensor] = None,
                     adapter_ids: Optional[torch.Tensor] = None):
    """x: (B, 1, d). cache: {'k', 'v', 'pos'} of one layer, updated in
    place. ``pos`` (B,): each row writes its own slot ``pos[b]``
    (``pos[b] % window`` for sliding), so one wave mixes rows at different
    positions. ``active`` (B,) bool retires rows: a retired row's slot is
    left as it was. ``adapter_ids`` (B,) selects each row's adapters from
    stacked (n_slots, ...) leaves. Returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    pos = pos.to(torch.int64).expand(B)

    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids)
    q = rope(q.reshape(B, 1, nh, hd), pos[:, None], cfg.rope_theta)
    k1 = _proj(x, params["wk"], params.get("bk"), lora.get("k"), ls,
               adapter_ids)
    k1 = rope(k1.reshape(B, 1, nkv, hd), pos[:, None], cfg.rope_theta)
    v1 = _proj(x, params["wv"], params.get("bv"), lora.get("v"), ls,
               adapter_ids)
    v1 = v1.reshape(B, 1, nkv, hd)

    T = cache["k"].shape[1]
    slot = (pos % window) if window and window > 0 else pos
    keep = slot < T
    if active is not None:
        keep = keep & active
    slot = slot.clamp(max=T - 1)
    rows = torch.arange(B, device=x.device)
    for name, new in (("k", k1[:, 0]), ("v", v1[:, 0]), ("pos", pos)):
        buf = cache[name]
        old = buf[rows, slot]
        mask = keep.reshape((B,) + (1,) * (old.dim() - 1))
        buf[rows, slot] = torch.where(mask, new.to(buf.dtype), old)

    pfx = (adapters or {}).get("prefix")
    pfx_k = pfx_v = None
    if pfx is not None:
        if adapter_ids is not None:                # per-row domain prefix
            pfx_k, pfx_v = _prefix_slots(pfx, B, adapter_ids)
        else:
            pfx_k, pfx_v = pfx["k"], pfx["v"]
    o = kops.flash_decode(
        q[:, 0], cache["k"], cache["v"], q_pos=pos, kv_pos=cache["pos"],
        prefix_k=pfx_k, prefix_v=pfx_v, window=window, causal=True)
    o = o.reshape(B, 1, nh * hd).to(x.dtype)
    y = _proj(o, params["wo"], None, lora.get("o"), ls, adapter_ids)
    return y, cache


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, *,
               window: int = 0, layers: Optional[int] = None) -> dict:
    """ParamSpec tree of a layer-stacked dense KV cache, batch at dim 1.

    The sliding-window cache is a rolling buffer of exactly ``window``
    slots. ``pos`` is per row (B, S): each row tracks its own slots."""
    L = layers if layers is not None else cfg.n_layers
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    S = window if window and window > 0 else seq_len
    dt = param_dtype(cfg)
    return {
        "k": ParamSpec((L, batch, S, nkv, hd), dt, init="zeros"),
        "v": ParamSpec((L, batch, S, nkv, hd), dt, init="zeros"),
        "pos": ParamSpec((L, batch, S), torch.int32, init="zeros"),
    }
