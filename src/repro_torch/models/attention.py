"""GQA attention with prefix-KV prompts, LoRA, sliding window and KV
caching, dense and paged, and the encoder-decoder's cross attention
(counterpart of ``repro/models/attention.py``).

Each layer owns ``n_p`` learned prefix key/value slots, visible to every
query and carrying no rotary phase (position < 0 in the masking rules of
``kernels/ref.py``).

- prefill: full-sequence flash attention (``kernels/ops.py``), which also
  builds the layer's KV cache (a rolling buffer for the sliding variant);
- cross attention (``kv_x``): keys and values from the encoder states,
  not causal, no rotary phase; its decode reads a static per-request
  cache of them (``cross=True``);
- decode: single-token flash decode against the cache, after writing the
  token's K/V at slot ``pos`` (``pos % window`` for sliding); on a mesh
  whose rules split the cache's slots (``long_decode_rules``) the rank
  that owns the slot writes it and each rank attends its own slots, the
  ranks' partials merged (``kernels/ops.py``), so no step gathers the
  cache. A paged
  cache (``{'k', 'v'}`` block pools (n_blocks, bs, Hkv, D) and a
  ``'table'`` (B, max_blocks)) is recognised by its ``table`` leaf: the
  write goes through the table and the attention is the paged kernel,
  prefix slots included;
- :func:`attention_chunk_paged`: a prefix-cache hit's suffix chunk against
  a paged cache (plain torch GQA, as the reference's is plain ``jnp``);
- :func:`attention_verify`: a speculative chunk of T tokens per row against
  the dense cache (plain torch GQA in f32, as the reference's).

Caches are written IN PLACE (the reference returns new arrays). A write
the reference drops with an out-of-bounds ``mode="drop"`` scatter (a
retired row, a slot past the buffer, a sentinel table entry, a pad token)
writes back a value already there instead: the dense cache rewrites the
row's own slot, and the paged pool repeats another write of the same call
(:func:`paged_write`), so the pool keeps the reference's shape.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.rules import shard

SENTINEL = 10 ** 9


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def attn_spec(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = param_dtype(cfg)
    s = {
        "wq": ParamSpec((d, nh * hd), dt, ("fsdp", "heads"), init="scaled"),
        "wk": ParamSpec((d, nkv * hd), dt, ("fsdp", "kv_heads"),
                        init="scaled"),
        "wv": ParamSpec((d, nkv * hd), dt, ("fsdp", "kv_heads"),
                        init="scaled"),
        "wo": ParamSpec((nh * hd, d), dt, ("heads", "fsdp"), init="scaled"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((nh * hd,), dt, ("heads",), init="zeros")
        s["bk"] = ParamSpec((nkv * hd,), dt, ("kv_heads",), init="zeros")
        s["bv"] = ParamSpec((nkv * hd,), dt, ("kv_heads",), init="zeros")
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


def _qkv(params, adapters, x, cfg: ModelConfig, kv_x=None,
         adapter_ids=None):
    """q, k, v with LoRA, reshaped to (B, S, H, D); k and v come from
    ``kv_x`` (B, Skv, d) when given (cross attention), else from x."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    kv_in = x if kv_x is None else kv_x
    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids)
    k = _proj(kv_in, params["wk"], params.get("bk"), lora.get("k"), ls,
              adapter_ids)
    v = _proj(kv_in, params["wv"], params.get("bv"), lora.get("v"), ls,
              adapter_ids)
    B, S = x.shape[:2]
    Skv = kv_in.shape[1]
    return (q.reshape(B, S, nh, hd), k.reshape(B, Skv, nkv, hd),
            v.reshape(B, Skv, nkv, hd))


def _prefix_slots(pfx: dict, B: int, adapter_ids=None):
    """The layer's prefix-KV slots per batch row, (B, n_p, Hkv, D): one
    bank broadcast over the batch, or with ``adapter_ids`` each row's own
    domain's slots gathered from the stacked (n_slots, n_p, Hkv, D) bank."""
    if adapter_ids is not None:
        ids = adapter_ids.to(device=pfx["k"].device, dtype=torch.long)
        if dt.is_dt(pfx["k"]):                       # a slot-sharded bank
            ids = dt.as_replicated(ids, pfx["k"].device_mesh)
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
                  kv_x: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  use_rope: bool = True,
                  make_cache: bool = False, cache_len: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None,
                  adapter_ids: Optional[torch.Tensor] = None):
    """Returns (out (B, S, d_model), cache or None).

    ``kv_x`` (B, Skv, d) at ``kv_positions`` (Skv,) makes it cross
    attention: k and v come from ``kv_x``, and no rotary phase is applied
    (RoPE only for self-attention with ``use_rope``). Prefix slots stay at
    position -1 ahead of the keys.

    ``lengths`` (B,) marks ragged right-padded rows: row b's valid tokens
    are columns ``[0, lengths[b])``. Padding sits on the right and masking
    is causal, so valid rows never see padded columns; the per-row cache
    ``pos`` plane (B, L) carries the ``+1e9`` sentinel beyond each row's
    length, which keeps padded K/V invisible to decode. ``adapter_ids``
    (B,) selects each row's adapters from stacked (n_slots, ...) leaves
    (multi-tenant serving)."""
    B, S = x.shape[:2]
    q, k, v = _qkv(params, adapters, x, cfg, kv_x, adapter_ids)
    kv_positions = positions if kv_positions is None else kv_positions
    if kv_x is None and use_rope:                     # self-attention: RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    q = shard(q, "batch", "attn_seq", "heads", "head_dim")
    k = shard(k, "batch", "attn_seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "attn_seq", "kv_heads", "head_dim")

    kp, vp, n_p = _with_prefix(k, v, adapters, B, adapter_ids)
    pos32 = positions.to(torch.int32)
    kv32 = kv_positions.to(torch.int32)
    kv_pos = torch.cat([kv32.new_full((n_p,), -1), kv32]) if n_p else kv32
    out = kops.flash_attention(q, kp, vp, q_pos=pos32, kv_pos=kv_pos,
                               window=window, causal=causal)
    out = out.reshape(B, S, -1)
    y = _proj(out, params["wo"], None,
              (adapters or {}).get("lora", {}).get("o"), _lora_scale(cfg),
              adapter_ids)
    y = shard(y, "batch", "seq", "d_model")

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
            def roll(t, p_):              # on a mesh, each rank's shard
                gidx = p_.clamp(0, S - 1)[:, :, None, None].expand(
                    -1, -1, t.shape[2], t.shape[3])
                return torch.where((p_ >= 0)[:, :, None, None],
                                   torch.gather(t, 1, gidx),
                                   torch.zeros((), dtype=t.dtype,
                                               device=t.device))
            cache = {
                "k": dt.on_local(k, roll, p),
                "v": dt.on_local(v, roll, p),
                # +1e9 sentinel: empty slots must be invisible (a negative
                # position would mark them as always-visible prefix slots)
                "pos": dt.split_like(
                    torch.where(p >= 0, p, SENTINEL).to(torch.int32), k),
            }
        else:
            L = max(cache_len or S, S)
            pad = L - S
            base = F.pad(pos32, (0, pad), value=SENTINEL)       # (L,)
            cols = torch.arange(L, device=x.device)[None, :]
            def grow(t):                  # (B, S, H, D) -> (B, L, H, D)
                return F.pad(t, (0, 0, 0, 0, 0, pad))
            # on a mesh, on each rank's shard (the seq dim is not split)
            cache = {
                "k": dt.on_local(k, grow),
                "v": dt.on_local(v, grow),
                "pos": dt.split_like(
                    torch.where(cols < lens[:, None], base[None, :],
                                SENTINEL).to(torch.int32), k),
            }
    return y, cache


def attention_decode(params: dict, adapters: Optional[dict],
                     x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
                     pos: torch.Tensor, window: int = 0,
                     cross: bool = False, use_rope: bool = True,
                     active: Optional[torch.Tensor] = None,
                     adapter_ids: Optional[torch.Tensor] = None):
    """x: (B, 1, d). cache: {'k', 'v', 'pos'} of one layer, or a paged
    {'k', 'v', 'table'}, updated in place. ``pos`` (B,): each row writes
    its own slot ``pos[b]`` (``pos[b] % window`` for sliding; through the
    table when paged), so one wave mixes rows at different positions.
    ``active`` (B,) bool retires rows: a retired row's slot is left as it
    was. ``adapter_ids`` (B,) selects each row's adapters from stacked
    (n_slots, ...) leaves. ``cross`` reads a static cross-attention cache
    (encoder keys) as it is: no write, no prefix, no window, not causal.
    ``use_rope`` False applies no rotary phase. Returns (out (B, 1, d),
    cache)."""
    B = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    pos = pos.to(torch.int64).expand(B)

    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids)
    q = q.reshape(B, 1, nh, hd)
    if cross:
        o = kops.flash_decode(q[:, 0], cache["k"], cache["v"], q_pos=pos,
                              kv_pos=cache["pos"], window=0, causal=False)
        o = o.reshape(B, 1, nh * hd).to(x.dtype)
        return _proj(o, params["wo"], None, lora.get("o"), ls,
                     adapter_ids), cache
    k1 = _proj(x, params["wk"], params.get("bk"), lora.get("k"), ls,
               adapter_ids)
    k1 = k1.reshape(B, 1, nkv, hd)
    if use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k1 = rope(k1, pos[:, None], cfg.rope_theta)
    v1 = _proj(x, params["wv"], params.get("bv"), lora.get("v"), ls,
               adapter_ids)
    v1 = v1.reshape(B, 1, nkv, hd)

    if "table" in cache:
        # row b's token goes to (table[b, pos // bs], pos % bs); retired
        # rows and sentinel table entries write nothing
        nb, bs = cache["k"].shape[0], cache["k"].shape[1]
        blk, off = _table_slots(dt.whole(cache["table"]), pos[:, None], bs)
        blk, off = blk[:, 0], off[:, 0]
        keep = blk < nb
        if active is not None:
            keep = keep & active
        paged_write(cache["k"], blk, off, k1[:, 0], keep)
        paged_write(cache["v"], blk, off, v1[:, 0], keep)
    else:
        T = cache["k"].shape[1]
        slot = (pos % window) if window and window > 0 else pos
        keep = slot < T
        if active is not None:
            keep = keep & active
        slot = slot.clamp(max=T - 1)
        for name, new in (("k", k1[:, 0]), ("v", v1[:, 0]), ("pos", pos)):
            _write_slot(cache[name], slot, new, keep)

    # the layer's prefix bank, read in place: shared, or with adapter_ids
    # the bank's stacked (n_slots, ...) slots, each row its own domain's
    pfx = (adapters or {}).get("prefix") or {}
    pfx_k, pfx_v = pfx.get("k"), pfx.get("v")
    pfx_ids = adapter_ids if pfx else None
    if "table" in cache:
        o = kops.flash_decode_paged(
            q[:, 0], cache["k"], cache["v"], cache["table"], q_pos=pos,
            prefix_k=pfx_k, prefix_v=pfx_v, prefix_ids=pfx_ids)
    else:
        o = kops.flash_decode(
            q[:, 0], shard(cache["k"], "batch", "kv_seq", "kv_heads",
                           "head_dim"),
            shard(cache["v"], "batch", "kv_seq", "kv_heads", "head_dim"),
            q_pos=pos, kv_pos=cache["pos"],
            prefix_k=pfx_k, prefix_v=pfx_v, prefix_ids=pfx_ids,
            window=window, causal=True)
    o = o.reshape(B, 1, nh * hd).to(x.dtype)
    y = _proj(o, params["wo"], None, lora.get("o"), ls, adapter_ids)
    return y, cache


def _write_slot(buf, slot: torch.Tensor, new, keep: torch.Tensor) -> None:
    """``buf[b, slot[b]] = new[b]`` for every row b with ``keep[b]``, in
    place. On a mesh the write is local to the rows this rank holds: a
    DTensor cache writes its local shard, with ``new`` brought to the
    cache's placements first and the per-row host vectors cut to the same
    rows. A cache whose slot dim is split (``long_decode_rules``: kv_seq
    over `pod`, `data`) writes slot ``s`` only on the rank that owns it,
    at its local index (:func:`dt.owned`)."""
    if dt.is_dt(buf):
        from torch.distributed.tensor import Replicate, Shard
        # new is buf without its slot dim (dim 1): whole where the slots
        # are split, else split as buf's other dims are
        pl = [(Replicate() if p.dim == 1 else Shard(p.dim - (p.dim > 1)))
              if isinstance(p, Shard) else p for p in buf.placements]
        new = dt.as_replicated(new, buf.device_mesh) \
            .redistribute(buf.device_mesh, pl).to_local()
        slot, keep = dt.rows_of(slot, buf), dt.rows_of(keep, buf)
        buf, slot, keep = dt.owned(buf, slot, keep, 1)
    elif dt.is_dt(new):
        new = dt.whole(new)
    rows = torch.arange(buf.shape[0], device=buf.device)
    old = buf[rows, slot]
    mask = keep.reshape((-1,) + (1,) * (old.dim() - 1))
    buf[rows, slot] = torch.where(mask, new.to(buf.dtype), old)


def paged_write(pool: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                new: torch.Tensor, keep: torch.Tensor) -> None:
    """``pool[..., blk[i], off[i]] = new[..., i]`` for every i with
    ``keep[i]``, in place. pool: (..., n_blocks, bs, Hkv, D); new:
    (..., N, Hkv, D); blk, off, keep: (N,).

    The reference drops the other writes (an out-of-bounds index). Here a
    dropped write repeats the first kept write, index and value (or, with
    none kept, rewrites the value already at its own slot), so duplicate
    indices always carry equal values: the scatter is deterministic, needs
    no extra block and reads nothing back to the host. Kept writes must
    hit distinct slots (the allocator never shares a row's tail block).
    ``new`` may carry its N rows as more than one dim (they are flattened
    in order).

    On a mesh (a DTensor pool: blocks split over the batch axes, kv heads
    over `model`) every rank gets every row's value (gathered over the
    batch axes, with the pool's kv heads) and writes those that land in
    its own blocks; ``blk``, ``off`` and ``keep`` are whole on every
    rank."""
    if dt.is_dt(pool):
        new = _rows_heads(new, pool)
        pool, start = dt.local_rows(pool, pool.dim() - 4)
        blk = blk.long()
        keep = keep & (blk >= start) & (blk < start + pool.shape[-4])
        blk = blk - start
    nb, bs = pool.shape[-4], pool.shape[-3]
    d = pool.dim() - 4                             # leading (layer) dims
    new = new.reshape(*pool.shape[:d], -1, *new.shape[-2:])
    flat = pool.view(*pool.shape[:d], nb * bs, *pool.shape[-2:])
    slot = blk.long().clamp(0, nb - 1) * bs + off.long()
    j = keep.to(torch.int32).argmax().reshape(1)   # first kept, else 0
    slot_j = slot.index_select(0, j)
    src_j = torch.where(keep.index_select(0, j).reshape(1, 1, 1),
                        new.index_select(d, j).to(pool.dtype),
                        flat.index_select(d, slot_j))
    vals = torch.where(keep.reshape(-1, 1, 1), new.to(pool.dtype), src_j)
    flat.index_copy_(d, torch.where(keep, slot, slot_j), vals)


def _rows_heads(new, pool) -> torch.Tensor:
    """This rank's part of ``new`` (.., Hkv, D) for a write into DTensor
    ``pool``: every row (gathered over the batch axes), the pool's kv
    heads (a plain ``new`` counts as whole)."""
    from torch.distributed.tensor import Replicate, Shard
    hp, hn = pool.dim() - 2, new.dim() - 2
    pl = [Shard(hn) if p == Shard(hp) else Replicate()
          for p in pool.placements]
    return dt.local_as(dt.as_replicated(new, pool.device_mesh), pl)


def _table_slots(table: torch.Tensor, qpos: torch.Tensor, bs: int):
    """(block, offset) of positions ``qpos`` (B, W) through ``table``
    (B, maxb); a position past the table reads its last entry."""
    col = (qpos // bs).clamp(0, table.shape[1] - 1)
    return table.long().gather(1, col), qpos % bs


def attention_chunk_paged(params: dict, adapters: Optional[dict],
                          x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
                          start: torch.Tensor, valid: torch.Tensor,
                          adapter_ids: Optional[torch.Tensor] = None):
    """Chunked continuation prefill against a paged cache (prefix sharing).

    A prefix-cache hit row runs only its private suffix through the stack:
    x (B, W, d), row b's chunk at positions ``start[b] .. start[b]+W-1``,
    ``valid`` (B, W) marking real suffix tokens. The chunk's K/V go into
    the row's private blocks through the table (pad tokens write nothing),
    then every chunk query attends the pool gathered through the table:
    the shared prefix blocks are read here and never written. W is a
    suffix, so the attention is plain torch GQA in f32, as the reference's
    is plain ``jnp``. Returns (out (B, W, d), cache)."""
    B, W = x.shape[:2]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    start = torch.as_tensor(start, device=x.device).to(torch.int64) \
        .expand(B)
    qpos = start[:, None] + torch.arange(W, device=x.device)[None, :]

    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids).reshape(B, W, nh, hd)
    k1 = _proj(x, params["wk"], params.get("bk"), lora.get("k"), ls,
               adapter_ids).reshape(B, W, nkv, hd)
    v1 = _proj(x, params["wv"], params.get("bv"), lora.get("v"), ls,
               adapter_ids).reshape(B, W, nkv, hd)
    q = rope(q, qpos, cfg.rope_theta)
    k1 = rope(k1, qpos, cfg.rope_theta)

    table = cache["table"]
    nb, bs = cache["k"].shape[0], cache["k"].shape[1]
    blk, off = _table_slots(dt.whole(table), qpos, bs)
    keep = (valid & (blk < nb)).reshape(-1)
    for name, new in (("k", k1), ("v", v1)):
        paged_write(cache[name], blk.reshape(-1), off.reshape(-1), new,
                    keep)

    pfx = (adapters or {}).get("prefix")
    pk = pv = None
    if pfx is not None:
        pk, pv = _prefix_slots(pfx, B, adapter_ids)

    def attend(q_, kpool, vpool, tbl, qpos_, pk_=None, pv_=None):
        kg, vg = fd.gather_pool(kpool, vpool, tbl)
        kv_pos = torch.arange(kg.shape[1], device=kg.device)[None] \
            .expand(kg.shape[0], -1)
        return _attend(q_, *fd.with_prefix(kg, vg, kv_pos, pk_, pv_), qpos_)

    o = _on_heads(attend, q, [cache["k"], cache["v"]],
                  [table, qpos], [] if pk is None else [pk, pv])
    y = _proj(o, params["wo"], None, lora.get("o"), ls, adapter_ids)
    return y, cache


def _attend(q, kp, vp, kv_pos, qpos, window: int = 0):
    """Plain torch GQA in f32 (the reference's plain ``jnp``): queries q
    (B, T, nh, hd) at ``qpos`` (B, T) against keys kp / vp (B, S, nkv,
    hd) at ``kv_pos`` (B, S); causal, inside ``window`` when it is set,
    and a negative position (a prefix slot) always visible. Returns (B,
    T, nh * hd) in q's dtype."""
    B, T, nh, hd = q.shape
    nkv = kp.shape[2]
    kv_pos, qpos = kv_pos.long(), qpos.long()
    vis = kv_pos[:, None, :] <= qpos[:, :, None]            # causal
    if window and window > 0:
        vis = vis & ((qpos[:, :, None] - kv_pos[:, None, :]) < window)
    vis = vis | (kv_pos[:, None, :] < 0)                    # prefix slots
    qf = q.reshape(B, T, nkv, nh // nkv, hd).float()
    scores = torch.einsum("btngd,bsnd->bngts", qf, kp.float()) * hd ** -0.5
    scores = torch.where(vis[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bngts,bsnd->btngd", probs, vp.float())
    return o.reshape(B, T, nh * hd).to(q.dtype)


def _on_heads(fn, q, pools: list, ints: list, kvs: list):
    """``fn(q, *pools, *ints, *kvs)`` (its result (B, T, nh * hd)), on a
    mesh on this rank's rows and `model` heads: q (B, T, nh, hd) split as
    its rows and heads are; ``pools`` (n_blocks, bs, nkv, hd) gathered
    over the batch axes; ``ints`` per-row tensors on the rows; ``kvs``
    per-row (B, S, nkv, hd) on the rows. The kv heads split with q's
    where they divide, else stay replicated and each rank cuts the ones
    its q heads read (``kops._kv_of``). Without a mesh: ``fn`` as it
    is."""
    mesh = dt.mesh_of(q, *pools, *kvs)
    if mesh is None:
        return fn(q, *pools, *ints, *kvs)
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    hq, hkv = q.shape[2], (pools or kvs)[0].shape[2]
    q_split, kv_split = kops._head_split(mesh, hq, hkv)
    rows = dt.row_placements(q, mesh)
    kvh = Shard(2) if kv_split else R
    qp = dt.with_model(rows, mesh, Shard(2) if q_split else R)
    pp = dt.with_model(dt.replicated(mesh), mesh, kvh)
    ip = dt.with_model(rows, mesh, R)
    kp = dt.with_model(rows, mesh, kvh)
    n_p, n_i = len(pools), len(ints)

    def local(q_, *rest):
        kv = list(rest[:n_p]) + list(rest[n_p + n_i:])
        if q_split and not kv_split:
            kv = kops._kv_of(mesh, hq, hkv, q_.shape[2], *kv, dim=2)
        return fn(q_, *kv[:n_p], *rest[n_p:n_p + n_i], *kv[n_p:])

    ints = [t if dt.is_dt(t) else t.contiguous() for t in ints]
    return dt.on_shards(local, [q, *pools, *ints, *kvs],
                        [qp] + [pp] * n_p + [ip] * n_i + [kp] * len(kvs),
                        qp)


def chunk_slots(qpos: torch.Tensor, window: int, S: int,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row cache slots a verify chunk writes (and rollback restores).

    qpos: (B, T) absolute positions. Sliding-window caches write slot
    ``pos % window``, full caches slot ``pos``; inactive rows get ``S``
    (out of the cache, written nowhere)."""
    slot = (qpos % window) if window and window > 0 else qpos
    if active is not None:
        slot = torch.where(active[:, None], slot, torch.full_like(slot, S))
    return slot


def write_slots(cache: dict, slot: torch.Tensor, values: dict) -> None:
    """``cache[leaf][..., b, slot[b, t]] = values[leaf][..., b, t]`` for
    every in-cache slot (``slot < S``), in place; a slot at or past ``S``
    writes nothing. cache leaves: (..., B, S, ...); values: (..., B, T,
    ...); slot: (B, T). The T offsets are written one after another, as T
    decode steps would, so a clamped out-of-cache slot rewrites the value
    already there and never races an in-cache write."""
    S = cache["pos"].shape[-1]
    nl = cache["pos"].dim() - 2                        # layer dims, if any
    lead = (slice(None),) * nl
    for name, val in values.items():
        buf, sl_ = cache[name], slot
        if dt.is_dt(buf):        # a mesh: this rank's rows, in its shard
            val = dt.local_as(dt.as_replicated(val, buf.device_mesh),
                              buf.placements)
            sl_ = dt.rows_of(slot, buf, nl)
            buf = buf.to_local()
        B, T = sl_.shape
        rows = torch.arange(B, device=sl_.device)
        keep = sl_ < S
        sl = sl_.clamp(max=S - 1)
        for t in range(T):
            idx = lead + (rows, sl[:, t])
            old = buf[idx]
            m = keep[:, t].reshape((1,) * len(lead) + (B,)
                                   + (1,) * (old.dim() - len(lead) - 1))
            buf[idx] = torch.where(m, val[lead + (slice(None), t)]
                                   .to(buf.dtype), old)


def attention_verify(params: dict, adapters: Optional[dict],
                     x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
                     pos: torch.Tensor, window: int = 0,
                     adapter_ids: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None):
    """Speculative verify: a length-T token chunk per row against the live
    dense cache. x: (B, T, d), row b's chunk at positions ``pos[b] ..
    pos[b]+T-1``. Returns (out (B, T, d), cache).

    The chunk's K/V are written into the cache first, in place (the
    footprint of T consecutive :func:`attention_decode` writes; inactive
    rows and slots past the cache write nothing), then every chunk query
    attends the updated cache under the masking rules of
    ``kernels/ref.py``: prefix slots always visible, sentinel slots never,
    the sliding window per query. T is draft_k + 1, so the attention is
    plain torch GQA in f32, as the reference's is plain ``jnp`` (a verify
    kernel is later work, ROADMAP). Rejected draft positions leave their
    K/V behind: ``core/spec_decode.py::rollback_caches`` restores them."""
    B, T = x.shape[:2]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lora = (adapters or {}).get("lora", {})
    ls = _lora_scale(cfg)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(B)
    qpos = pos[:, None] + torch.arange(T, device=x.device)[None, :]

    q = _proj(x, params["wq"], params.get("bq"), lora.get("q"), ls,
              adapter_ids).reshape(B, T, nh, hd)
    k1 = _proj(x, params["wk"], params.get("bk"), lora.get("k"), ls,
               adapter_ids).reshape(B, T, nkv, hd)
    v1 = _proj(x, params["wv"], params.get("bv"), lora.get("v"), ls,
               adapter_ids).reshape(B, T, nkv, hd)
    q = rope(q, qpos, cfg.rope_theta)
    k1 = rope(k1, qpos, cfg.rope_theta)

    S = cache["k"].shape[1]
    write_slots(cache, chunk_slots(qpos, window, S, active),
                {"k": k1, "v": v1, "pos": qpos})

    pfx = (adapters or {}).get("prefix")
    kvs = [shard(cache["k"], "batch", "kv_seq", "kv_heads", "head_dim"),
           shard(cache["v"], "batch", "kv_seq", "kv_heads", "head_dim")]
    if pfx is not None:
        kvs += list(_prefix_slots(pfx, B, adapter_ids))

    def attend(q_, kv_pos, qpos_, k_, v_, pk_=None, pv_=None):
        return _attend(q_, *fd.with_prefix(k_, v_, kv_pos, pk_, pv_),
                       qpos_, window)

    o = _on_heads(attend, q, [], [cache["pos"], qpos], kvs)
    y = _proj(o, params["wo"], None, lora.get("o"), ls, adapter_ids)
    return y, cache


# logical axes of the dense and paged cache leaves
CACHE_AXES = (None, "batch", "kv_seq", "kv_heads", "head_dim")
_POOL_AXES = (None, "kv_blocks", None, "kv_heads", "head_dim")


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, *,
               window: int = 0, layers: Optional[int] = None,
               paged: Optional[tuple] = None) -> dict:
    """ParamSpec tree of a layer-stacked KV cache, batch at dim 1.

    The sliding-window cache is a rolling buffer of exactly ``window``
    slots. ``pos`` is per row (B, S): each row tracks its own slots.

    ``paged=(n_blocks, block_size)`` gives the paged layout instead
    (full-window layers only): a layer-stacked block pool ``(L, n_blocks,
    bs, Hkv, D)`` shared by every row, and per-row block tables
    ``(L, B, ceil(seq_len / bs))``; no ``pos`` plane, since table slot
    ``j`` holds positions ``[j*bs, (j+1)*bs)``."""
    L = layers if layers is not None else cfg.n_layers
    nkv, hd = cfg.n_kv_heads, cfg.head_dim_
    S = window if window and window > 0 else seq_len
    dt = param_dtype(cfg)
    if paged is not None and not (window and window > 0):
        nb, bs = paged
        maxb = -(-seq_len // bs)
        return {
            "k": ParamSpec((L, nb, bs, nkv, hd), dt, _POOL_AXES,
                           init="zeros"),
            "v": ParamSpec((L, nb, bs, nkv, hd), dt, _POOL_AXES,
                           init="zeros"),
            "table": ParamSpec((L, batch, maxb), torch.int32,
                               (None, "batch", None), init="zeros"),
        }
    return {
        "k": ParamSpec((L, batch, S, nkv, hd), dt, CACHE_AXES, init="zeros"),
        "v": ParamSpec((L, batch, S, nkv, hd), dt, CACHE_AXES, init="zeros"),
        "pos": ParamSpec((L, batch, S), torch.int32, CACHE_AXES[:3],
                         init="zeros"),
    }
