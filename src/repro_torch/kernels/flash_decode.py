"""Flash decode (one query per row against its KV cache): two CUDA kernels
and their plain PyTorch versions.

- ``flash_decode`` (``csrc/flash_decode.cu``) replaces the TPU kernel
  ``repro/kernels/flash_decode.py::flash_decode_pallas`` (body
  ``_kernel``): a dense per-row cache with per-row ``q_pos`` (B,) and
  ``kv_pos`` (B, T); ``+1e9`` sentinel slots never show, negative (prefix)
  slots always do; an optional prefix bank (``prefix_k`` / ``prefix_v``:
  shared, per row, or a multi-tenant bank's stacked slots read by the
  rows' ids, ``prefix_ids``) at position -1 in front.
- ``flash_decode_paged`` (``csrc/flash_decode_paged.cu``) replaces
  ``flash_decode_paged_pallas`` (body ``_paged_kernel``): a block pool
  ``(n_blocks, bs, Hkv, D)`` read through a per-row block table, causal
  only, with the layer's prefix-KV slots in front (the TPU route sends a
  prefix bank to a gather and the dense kernel instead; this kernel takes
  the bank itself).

In bf16 both run one split-KV tile on the tensor cores
(``csrc/decode_split.cuh``): a row's keys are cut into 64-key tiles, the
prefix bank (read in place, never concatenated) in tiles of its own, the
tiles into runs of :func:`split_plan`'s length, one block per (run, KV
head, row), TMA loads, ``mma.sync`` products with the group's query heads
as rows, and the runs combined in split order by the block that finishes
a (row, KV head) last, all in one launch. The runs depend on the head dim
and the row's key count only, so paged, dense with the prefix in place
and dense on ``with_prefix``'s concatenated cache give the same bits, and
a row gives the same bits in any batch. TMA needs 16-byte-aligned bases
and row strides: a head dim that is not a multiple of 8, or a misaligned
base, takes one zero-padding copy in D (counted in ``pad_copies``; every
model's head dim is a multiple of 8). f32 (the token-exact checks; no
serving path runs f32) keeps the CUDA-core tile of
``csrc/attn_tile.cuh``, the dense wrapper concatenating a prefix bank in
front of the cache. Bound on an H100 and design: see the source notes in
``csrc/``.

``flash_decode(..., return_lse=True)`` is the partial mode of a cache
split over ranks (``long_decode_rules``: each `data` rank holds its own
slots): both routes also write each row's log-sum-exp of its visible
scores, (B, Hq) f32 in natural-log units, and a row that sees no key on
this shard gives ``lse = -inf`` and a zero output instead of the uniform
average of its keys; :func:`combine` (and ``kernels/ops.py`` across
ranks) merges the partials. Without it the outputs are what they were.

The plain versions are the f32 kernels' dataflow in torch (the same 32-key
tile loop as ``flash_attention.online_softmax``); the paged one gathers
``pool[table]`` into the dense layout and runs the dense plain version, so
a paged drain on the CPU is the dense plain path on the same visible
values. Each wrapper launches its kernel for CUDA tensors and takes the
plain version only for CPU tensors or when the caller passes
``backend="torch"``. ``launches`` and ``paged_launches`` count kernel
launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DMAX, online_softmax,
                                                 pad_d8, visible)

launches = 0
paged_launches = 0
pad_copies = 0
map_encodes = 0            # TMA maps encoded (misses of the map cache)

GMAX = 16                  # largest GQA group the kernels take
PAGED_DMAX = 128           # largest head dim of the paged kernel
TILE = 64                  # keys a tile of the bf16 kernels
MAX_SPLITS = 32            # splits a (row, KV head) at most
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _P]
_PAGED_ARGS = [_P] * 8 + [_I] * 9 + [_F, _I, _P]
_BF16_ARGS = [_P] * 12 + [_I] * 8 + [_F, _I, _I, _I, _I, _P]
_PAGED_BF16_ARGS = [_P] * 11 + [_I] * 10 + [_F, _I, _I, _I, _P]
_MAP_ARGS = [_P, _P] + [_I] * 5


def split_plan(D: int, n_keys: int) -> tuple[int, int]:
    """(tiles a split, splits) of the bf16 kernels for a row of ``n_keys``
    keys (prefix slots included) at head dim ``D``: runs of 4 tiles at D
    <= 64 and of 2 above, longer where that would give more than
    ``MAX_SPLITS`` runs. Counts one tile more than the keys fill, for the
    cut between the prefix and the cache (a split past a row's last tile
    is empty). Depends on nothing else: not on the batch, the KV heads,
    the card, or whether the keys come through a block table."""
    base = 4 if D <= 64 else 2
    n_max = -(-n_keys // TILE) + 1
    tps = max(base, -(-n_max // MAX_SPLITS))
    return tps, -(-n_max // tps)


def key_tiles(n_lead: int, n_keys: int) -> list[tuple[int, int]]:
    """The bf16 kernels' tiles, ``[(start, stop), ...]`` in a row's key
    order: the lead (the prefix bank, or a dense cache's leading slots at
    negative positions) cut into 64-key tiles of its own, then the rest
    from its first key."""
    cuts = [(t, min(t + TILE, n_lead)) for t in range(0, n_lead, TILE)]
    return cuts + [(t, min(t + TILE, n_keys))
                   for t in range(n_lead, n_keys, TILE)]


def _pad_for_tma(*ts):
    """:func:`flash_attention.pad_d8` of a launch's bf16 operands (q
    first; None passes through); counts one in ``pad_copies`` per call
    that copied."""
    global pad_copies
    out, copied = pad_d8(*ts)
    pad_copies += copied
    return out


# Encoded TMA maps by (library, base, shape, box rows): the caches, pools
# and prefix banks of a drain live for the whole drain, so a decode step
# encodes nothing. A map depends only on these, so a reused address is
# safe. The cache is cleared when it is full; a launch holds its maps'
# buffers until the kernel has copied them, so clearing frees none in use.
_MAPS: dict = {}
# Per (device, stream): the split counters (zeros, reset by the kernel)
# and the partials buffer, grown on demand. Launches on one stream run in
# order, so one workspace serves them all.
_WORK: dict = {}


def _map(lib, name: str, t: torch.Tensor, H: int, rows: int, nbatch: int,
         box_rows: int):
    """``t``'s encoded map, (D, H, rows, nbatch) with a box of
    ``box_rows`` rows, encoded by ``lib`` on first use: a 128-byte ctypes
    buffer, passed to the launch as its pointer. The caller keeps it
    until the launch returns."""
    global map_encodes
    key = (name, t.data_ptr(), t.shape[-1], H, rows, nbatch, box_rows)
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= 1024:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(128)
        fn = getattr(lib, f"{name}_encode_map")
        if fn.argtypes is None:
            fn.argtypes, fn.restype = _MAP_ARGS, ctypes.c_int
        _build.check(lib, name, fn(buf, *key[1:]))
        _MAPS[key] = buf
        map_encodes += 1
    return buf


def _workspace(t: torch.Tensor, n_counters: int, n_floats: int):
    """(counters, partials, stream) pointers for a launch on ``t``'s
    device and current stream."""
    stream = _build.stream(t)
    key = (t.get_device(), stream)
    ws = _WORK.get(key)
    if ws is None or ws[0].numel() < n_counters or \
            ws[1].numel() < n_floats:
        cnt = torch.zeros(max(n_counters, 1024), dtype=torch.int32,
                          device=t.device)
        part = torch.empty(max(n_floats, 1 << 20), dtype=torch.float32,
                           device=t.device)
        ws = _WORK[key] = (cnt, part, cnt.data_ptr(), part.data_ptr())
    return ws[2], ws[3], stream


def flash_decode_torch(q, k, v, *, q_pos, kv_pos, window: int = 0,
                       causal: bool = True, scale: Optional[float] = None,
                       prefix_k=None, prefix_v=None, prefix_ids=None,
                       return_lse: bool = False):
    """Plain version. q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos (B,);
    kv_pos (B, T); prefix_k / prefix_v (n_p, Hkv, D) or (B, n_p, Hkv, D),
    or a stacked bank (n_slots, n_p, Hkv, D) read through prefix_ids (B,)
    (:func:`select_rows`), put in front at position -1
    (:func:`with_prefix`). Returns (B, Hq, D) in q.dtype; with
    ``return_lse`` also the (B, Hq) f32 log-sum-exp of each row's visible
    scores, the partial that :func:`combine` merges (a row that sees no
    key: ``-inf`` and a zero output)."""
    prefix_k, prefix_v = select_rows(prefix_k, prefix_v, prefix_ids)
    k, v, kv_pos = with_prefix(k, v, kv_pos, prefix_k, prefix_v)
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, g, 1, D)
    qp = q_pos.to(torch.int64).reshape(B, 1, 1, 1, 1)
    kp = kv_pos.to(torch.int64).reshape(B, 1, 1, 1, -1)
    out = online_softmax(
        qf, k, v, lambda t0, t1: visible(qp, kp[..., t0:t1], window, causal),
        scale, with_lse=return_lse)
    if not return_lse:
        return out.reshape(B, Hq, D).to(q.dtype)
    out, lse = out
    return out.reshape(B, Hq, D).to(q.dtype), lse.reshape(B, Hq)


def contiguous_as(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in ``dtype``, contiguous (itself if it is both already)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def select_rows(prefix_k, prefix_v, prefix_ids):
    """Each row's prefix slots, (B, n_p, Hkv, D), from a stacked bank
    (n_slots, n_p, Hkv, D) and the rows' slot ids (B,); the bank itself
    when ``prefix_ids`` is None."""
    if prefix_ids is None or prefix_k is None:
        return prefix_k, prefix_v
    ids = prefix_ids.to(device=prefix_k.device, dtype=torch.long)
    return prefix_k.index_select(0, ids), prefix_v.index_select(0, ids)


def _check_prefix(name, prefix_k, prefix_v, prefix_ids, B, Hkv, D):
    """(n_p, per_row, n_slots) of a prefix bank, or a ValueError: shared
    (n_p, Hkv, D), per row (B, n_p, Hkv, D), or stacked (n_slots, n_p,
    Hkv, D) with ``prefix_ids`` (B,)."""
    if prefix_k is None:
        if prefix_ids is not None:
            raise ValueError(f"{name}: prefix_ids without a prefix bank")
        return 0, False, 0
    n_p = prefix_k.shape[-3] if prefix_k.dim() in (3, 4) else -1
    per_row = prefix_k.dim() == 4
    n_slots = prefix_k.shape[0] if prefix_ids is not None else B
    want = (n_slots, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
    if prefix_k.shape != want or prefix_v is None or \
            prefix_v.shape != want or (prefix_ids is not None and (
                not per_row or prefix_ids.shape != (B,))):
        raise ValueError(
            f"{name}: prefix {tuple(prefix_k.shape)} / "
            f"{None if prefix_v is None else tuple(prefix_v.shape)}, ids "
            f"{None if prefix_ids is None else tuple(prefix_ids.shape)} "
            f"do not match {want}")
    return n_p, per_row, n_slots


def _lse_out(q, return_lse: bool):
    """The (B, Hq) f32 log-sum-exp output of a partial-mode launch, or
    None."""
    return q.new_empty(q.shape[:2], dtype=torch.float32) if return_lse \
        else None


def _launch(q, k, v, q_pos, kv_pos, window, causal, scale,
            return_lse=False):
    """The f32 CUDA-core kernel (a prefix bank already in front)."""
    global launches
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    code = _build.checked_args(
        "flash_decode",
        {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos}, q.dtype)
    lib = _build.bind("flash_decode", _ARGS)
    out = torch.empty_like(q)
    lse = _lse_out(q, return_lse)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, T, Hq, Hkv, D,
        float(scale if scale is not None else D ** -0.5), int(causal),
        int(window or 0), code, _build.stream(q))
    _build.check(lib, "flash_decode", err)
    launches += 1
    return out if lse is None else (out, lse)


def _launch_bf16(q, k, v, q_pos, kv_pos, prefix_k, prefix_v, prefix_ids,
                 n_p, per_row, n_slots, window, causal, scale,
                 return_lse=False):
    """The split-KV tensor-core kernel, the prefix bank read in place."""
    global launches
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    tensors = {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos}
    if n_p:
        tensors.update(prefix_k=prefix_k, prefix_v=prefix_v)
    if prefix_ids is not None:
        tensors.update(prefix_ids=prefix_ids)
    _build.checked_args("flash_decode", tensors, q.dtype)
    lib = _build.bind("flash_decode", _ARGS)
    fn = lib.flash_decode_bf16_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _BF16_ARGS, ctypes.c_int
    scale = float(scale if scale is not None else D ** -0.5)
    q, k, v, prefix_k, prefix_v = _pad_for_tma(q, k, v, prefix_k, prefix_v)
    Dp = q.shape[-1]
    tps, n_splits = split_plan(Dp, n_p + T)
    g = Hq // Hkv
    cnt, part, stream = _workspace(q, B * Hkv, B * Hkv * n_splits * g
                                   * (Dp + 2))
    mk = _map(lib, "flash_decode", k, Hkv, max(T, 1), B, TILE)
    mv = _map(lib, "flash_decode", v, Hkv, max(T, 1), B, TILE)
    mpk, mpv = mk, mv
    if n_p:
        nb = n_slots if per_row else 1
        mpk = _map(lib, "flash_decode", prefix_k, Hkv, n_p, nb, TILE)
        mpv = _map(lib, "flash_decode", prefix_v, Hkv, n_p, nb, TILE)
    out = torch.empty_like(q)
    lse = _lse_out(q, return_lse)
    err = fn(q.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(), mk, mv,
             mpk, mpv,
             None if prefix_ids is None else prefix_ids.data_ptr(), part,
             cnt, B, T, n_p, int(per_row), n_slots, Hq, Hkv, Dp, scale,
             int(causal), int(window or 0), tps, n_splits, stream)
    _build.check(lib, "flash_decode", err)
    launches += 1
    out = out if Dp == D else out[..., :D].contiguous()
    return out if lse is None else (out, lse)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
                 causal: bool = True, scale: Optional[float] = None,
                 prefix_k: Optional[torch.Tensor] = None,
                 prefix_v: Optional[torch.Tensor] = None,
                 prefix_ids: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None, return_lse: bool = False):
    """Shapes as in :func:`ref.decode_attention` with per-row positions:
    q_pos (B,), kv_pos (B, T), both int32; an optional prefix bank
    prefix_k / prefix_v in k's dtype, always visible in front (position
    -1), taken as :func:`flash_decode_paged` takes it: (n_p, Hkv, D)
    shared, (B, n_p, Hkv, D) per row, or a stacked (n_slots, n_p, Hkv, D)
    bank with ``prefix_ids`` (B,) int32 naming each row's slot (a
    multi-tenant bank; ids outside the bank are clamped into it by the
    bf16 kernel). In bf16 the kernel reads the bank in place; in f32 the
    rows' slots are concatenated in front (:func:`with_prefix`).

    ``return_lse`` returns ``(out, lse)``: the partial of a cache split
    over ranks, ``lse`` (B, Hq) f32 the log-sum-exp of each row's visible
    scores (natural log), a row that sees no key ``-inf`` with a zero
    output; :func:`combine` merges partials. Without it every route's
    output is what it was."""
    if backend == "torch" or (backend is None and q.device.type == "cpu"):
        return flash_decode_torch(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  window=window, causal=causal, scale=scale,
                                  prefix_k=prefix_k, prefix_v=prefix_v,
                                  prefix_ids=prefix_ids,
                                  return_lse=return_lse)
    if backend not in (None, "cuda"):
        raise ValueError(f"flash_decode: unknown backend {backend!r}")
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or Hq % Hkv or \
            q_pos.shape != (B,) or kv_pos.shape != (B, T):
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, q_pos {tuple(q_pos.shape)}, kv_pos "
            f"{tuple(kv_pos.shape)} do not match")
    if D > DMAX or Hq // Hkv > GMAX:
        raise ValueError(f"flash_decode: head dim {D} > {DMAX} or group "
                         f"{Hq // Hkv} > {GMAX}")
    n_p, per_row, n_slots = _check_prefix(
        "flash_decode", prefix_k, prefix_v, prefix_ids, B, Hkv, D)
    q_pos = contiguous_as(q_pos, torch.int32)
    kv_pos = contiguous_as(kv_pos, torch.int32)
    if q.dtype == torch.bfloat16:
        if prefix_ids is not None:
            prefix_ids = contiguous_as(prefix_ids, torch.int32)
        return _launch_bf16(q, k, v, q_pos, kv_pos, prefix_k, prefix_v,
                            prefix_ids, n_p, per_row, n_slots, window,
                            causal, scale, return_lse)
    prefix_k, prefix_v = select_rows(prefix_k, prefix_v, prefix_ids)
    k, v, kv_pos = with_prefix(k, v, kv_pos, prefix_k, prefix_v)
    return _launch(q, k.contiguous(), v.contiguous(), q_pos,
                   kv_pos.contiguous(), window, causal, scale, return_lse)


def combine(outs, lses):
    """Merge the partials of disjoint key sets of the same rows (each
    ``flash_decode(..., return_lse=True)``): ``lse* = log sum_r
    exp(lse_r)`` and ``o = sum_r exp(lse_r - lse*) o_r`` in f32, in the
    order given. Returns ``(o in outs[0]'s dtype, lse*)``. A part whose
    rows see no key (``-inf``) weighs exactly 0."""
    lse = torch.stack(lses)
    m = lse.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    star = m + torch.log(torch.exp(lse - m).sum(0))
    w = merge_weights(lse, star)
    o = (w[..., None] * torch.stack([o.float() for o in outs])).sum(0)
    return o.to(outs[0].dtype), star


def merge_weights(lse: torch.Tensor, star: torch.Tensor) -> torch.Tensor:
    """``exp(lse - lse*)``, exactly 0 where ``lse`` is ``-inf``."""
    return torch.where(lse == float("-inf"), torch.zeros_like(lse),
                       torch.exp(lse - star))


# ---------------------------------------------------------------------------
# Paged: a block pool through per-row block tables
# ---------------------------------------------------------------------------

def gather_pool(k_pool: torch.Tensor, v_pool: torch.Tensor,
                table: torch.Tensor):
    """The dense view of a paged cache: (B, maxb * bs, Hkv, D) K and V,
    row b's position t at ``pool[table[b, t // bs], t % bs]``; sentinel
    entries (>= n_blocks) clamp into the pool."""
    nb, bs, Hkv, D = k_pool.shape
    B, maxb = table.shape
    tbl = table.long().clamp(0, nb - 1)
    return (k_pool[tbl].reshape(B, maxb * bs, Hkv, D),
            v_pool[tbl].reshape(B, maxb * bs, Hkv, D))


def with_prefix(k, v, kv_pos, prefix_k, prefix_v):
    """Put prefix slots, (n_p, Hkv, D) shared or (B, n_p, Hkv, D) per row,
    in front of k, v (B, T, Hkv, D) at position -1."""
    if prefix_k is None:
        return k, v, kv_pos
    B = k.shape[0]
    if prefix_k.dim() == 3:
        prefix_k = prefix_k[None].expand(B, *prefix_k.shape)
        prefix_v = prefix_v[None].expand(B, *prefix_v.shape)
    n_p = prefix_k.shape[1]
    return (torch.cat([prefix_k.to(k.dtype), k], dim=1),
            torch.cat([prefix_v.to(v.dtype), v], dim=1),
            torch.cat([kv_pos.new_full((B, n_p), -1), kv_pos], dim=1))


def flash_decode_paged_torch(q, k_pool, v_pool, table, *, q_pos,
                             prefix_k=None, prefix_v=None, prefix_ids=None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather ``pool[clamp(table)]``, put the prefix (the
    rows' slots of a stacked bank with ``prefix_ids``) in front at
    position -1 and run :func:`flash_decode_torch` (causal)."""
    B = q.shape[0]
    prefix_k, prefix_v = select_rows(prefix_k, prefix_v, prefix_ids)
    k, v = gather_pool(k_pool, v_pool, table)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                          device=q.device)[None].expand(B, -1)
    k, v, kv_pos = with_prefix(k, v, kv_pos, prefix_k, prefix_v)
    return flash_decode_torch(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                              scale=scale)


def _launch_paged(q, k_pool, v_pool, table, q_pos, prefix_k, prefix_v,
                  prefix_ids, scale):
    global paged_launches
    B, Hq, D = q.shape
    nb, bs, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    maxb = table.shape[1] if table.dim() == 2 else -1
    if k_pool.shape != (nb, bs, Hkv, D) or v_pool.shape != k_pool.shape or \
            Hq % Hkv or table.shape != (B, maxb) or q_pos.shape != (B,):
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, q_pos {tuple(q_pos.shape)} do not "
            f"match")
    n_p, per_row, n_slots = _check_prefix(
        "flash_decode_paged", prefix_k, prefix_v, prefix_ids, B, Hkv, D)
    if D > PAGED_DMAX or Hq // Hkv > GMAX or bs & (bs - 1):
        raise ValueError(f"flash_decode_paged: head dim {D} > "
                         f"{PAGED_DMAX}, group {Hq // Hkv} > {GMAX} or block "
                         f"size {bs} not a power of two")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "table": table, "q_pos": q_pos}
    if prefix_k is not None:
        tensors.update(prefix_k=prefix_k, prefix_v=prefix_v)
    if prefix_ids is not None:
        tensors.update(prefix_ids=prefix_ids)
    code = _build.checked_args("flash_decode_paged", tensors, q.dtype)
    lib = _build.bind("flash_decode_paged", _PAGED_ARGS)
    if q.dtype == torch.bfloat16:
        return _launch_paged_bf16(lib, q, k_pool, v_pool, table, q_pos,
                                  prefix_k, prefix_v, prefix_ids, n_p,
                                  per_row, n_slots, scale)
    if prefix_ids is not None:
        prefix_k, prefix_v = (t.contiguous() for t in select_rows(
            prefix_k, prefix_v, prefix_ids))
    out = torch.empty_like(q)
    err = lib.flash_decode_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        q_pos.data_ptr(), None if prefix_k is None else prefix_k.data_ptr(),
        None if prefix_v is None else prefix_v.data_ptr(), out.data_ptr(), B,
        nb, bs, maxb, n_p, int(per_row), Hq, Hkv, D,
        float(scale if scale is not None else D ** -0.5), code,
        _build.stream(q))
    _build.check(lib, "flash_decode_paged", err)
    paged_launches += 1
    return out


def _launch_paged_bf16(lib, q, k_pool, v_pool, table, q_pos, prefix_k,
                       prefix_v, prefix_ids, n_p, per_row, n_slots, scale):
    """The split-KV tensor-core kernel with the paged loader."""
    global paged_launches
    B, Hq, D = q.shape
    nb, bs, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    maxb = table.shape[1]
    fn = lib.flash_decode_paged_bf16_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _PAGED_BF16_ARGS, ctypes.c_int
    scale = float(scale if scale is not None else D ** -0.5)
    q, k_pool, v_pool, prefix_k, prefix_v = _pad_for_tma(
        q, k_pool, v_pool, prefix_k, prefix_v)
    Dp = q.shape[-1]
    tps, n_splits = split_plan(Dp, n_p + maxb * bs)
    g = Hq // Hkv
    cnt, part, stream = _workspace(q, B * Hkv, B * Hkv * n_splits * g
                                   * (Dp + 2))
    name = "flash_decode_paged"
    mk = _map(lib, name, k_pool, Hkv, bs, nb, min(bs, TILE))
    mv = _map(lib, name, v_pool, Hkv, bs, nb, min(bs, TILE))
    mpk, mpv = mk, mv
    if n_p:
        nbat = n_slots if per_row else 1
        mpk = _map(lib, name, prefix_k, Hkv, n_p, nbat, TILE)
        mpv = _map(lib, name, prefix_v, Hkv, n_p, nbat, TILE)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), q_pos.data_ptr(), table.data_ptr(),
             out.data_ptr(), mk, mv, mpk, mpv,
             None if prefix_ids is None else prefix_ids.data_ptr(), part,
             cnt, B, nb, bs, maxb, n_p, int(per_row), n_slots, Hq, Hkv, Dp,
             scale, tps, n_splits, -(-(tps * TILE) // bs) + 1, stream)
    _build.check(lib, name, err)
    paged_launches += 1
    return out if Dp == D else out[..., :D].contiguous()


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor, *,
                       q_pos: torch.Tensor,
                       prefix_k: Optional[torch.Tensor] = None,
                       prefix_v: Optional[torch.Tensor] = None,
                       prefix_ids: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
    """Shapes as in :func:`ref.paged_decode_attention`, q_pos (B,) and
    table (B, maxb) int32, and an optional prefix bank in the pool's
    dtype: (n_p, Hkv, D), (B, n_p, Hkv, D), or a stacked (n_slots, n_p,
    Hkv, D) bank with ``prefix_ids`` (B,) as :func:`flash_decode` takes
    it. On a CUDA tensor this always launches the kernel, with or without
    a prefix bank (in bf16 the split-KV tensor-core tile, in f32 the
    CUDA-core tile)."""
    if backend == "torch" or (backend is None and q.device.type == "cpu"):
        return flash_decode_paged_torch(q, k_pool, v_pool, table,
                                        q_pos=q_pos, prefix_k=prefix_k,
                                        prefix_v=prefix_v,
                                        prefix_ids=prefix_ids, scale=scale)
    if backend not in (None, "cuda"):
        raise ValueError(f"flash_decode_paged: unknown backend {backend!r}")
    if prefix_k is not None:
        prefix_k = prefix_k.contiguous()
        prefix_v = prefix_v.contiguous()
    if prefix_ids is not None:
        prefix_ids = contiguous_as(prefix_ids, torch.int32)
    return _launch_paged(q, k_pool, v_pool, contiguous_as(table, torch.int32),
                         contiguous_as(q_pos, torch.int32), prefix_k,
                         prefix_v, prefix_ids, scale)
