"""Flash decode (one query per row against its KV cache): two CUDA kernels
and their plain PyTorch versions.

- ``flash_decode`` (``csrc/flash_decode.cu``) replaces the TPU kernel
  ``repro/kernels/flash_decode.py::flash_decode_pallas`` (body
  ``_kernel``): a dense per-row cache with per-row ``q_pos`` (B,) and
  ``kv_pos`` (B, T); ``+1e9`` sentinel slots never show, negative (prefix)
  slots always do.
- ``flash_decode_paged`` (``csrc/flash_decode_paged.cu``) replaces
  ``flash_decode_paged_pallas`` (body ``_paged_kernel``): a block pool
  ``(n_blocks, bs, Hkv, D)`` read through a per-row block table, causal
  only, with the layer's prefix-KV slots in front (the TPU route sends a
  prefix bank to a gather and the dense kernel instead; this kernel takes
  the bank itself).

The ``g = Hq / Hkv`` query heads that share a KV head share one pass over
its keys; ``g`` need not be a power of two. Bound on an H100 and design:
see the source notes in ``csrc/``.

The plain versions are the kernels' dataflow in torch (the same 32-key
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
from repro_torch.kernels.flash_attention import DMAX, online_softmax, visible

launches = 0
paged_launches = 0

GMAX = 16                  # largest GQA group the kernels take
PAGED_DMAX = 128           # largest head dim of the paged kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]
_PAGED_ARGS = [_P] * 8 + [_I] * 9 + [_F, _I, _P]


def flash_decode_torch(q, k, v, *, q_pos, kv_pos, window: int = 0,
                       causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos (B,);
    kv_pos (B, T). Returns (B, Hq, D) in q.dtype."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, g, 1, D)
    qp = q_pos.to(torch.int64).reshape(B, 1, 1, 1, 1)
    kp = kv_pos.to(torch.int64).reshape(B, 1, 1, 1, -1)
    out = online_softmax(
        qf, k, v, lambda t0, t1: visible(qp, kp[..., t0:t1], window, causal),
        scale)
    return out.reshape(B, Hq, D).to(q.dtype)


def _launch(q, k, v, q_pos, kv_pos, window, causal, scale):
    global launches
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
    code = _build.checked_args(
        "flash_decode",
        {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos}, q.dtype)
    lib = _build.bind("flash_decode", _ARGS)
    out = torch.empty_like(q)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D,
        float(scale if scale is not None else D ** -0.5), int(causal),
        int(window or 0), code, _build.stream(q))
    _build.check(lib, "flash_decode", err)
    launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
                 causal: bool = True, scale: Optional[float] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Shapes as in :func:`ref.decode_attention` with per-row positions:
    q_pos (B,), kv_pos (B, T), both int32."""
    if backend == "torch" or (backend is None and q.device.type == "cpu"):
        return flash_decode_torch(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  window=window, causal=causal, scale=scale)
    if backend not in (None, "cuda"):
        raise ValueError(f"flash_decode: unknown backend {backend!r}")
    return _launch(q, k, v, q_pos.to(torch.int32).contiguous(),
                   kv_pos.to(torch.int32).contiguous(), window, causal,
                   scale)


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
                             prefix_k=None, prefix_v=None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather ``pool[clamp(table)]``, put the prefix in
    front at position -1 and run :func:`flash_decode_torch` (causal)."""
    B = q.shape[0]
    k, v = gather_pool(k_pool, v_pool, table)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                          device=q.device)[None].expand(B, -1)
    k, v, kv_pos = with_prefix(k, v, kv_pos, prefix_k, prefix_v)
    return flash_decode_torch(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                              scale=scale)


def _launch_paged(q, k_pool, v_pool, table, q_pos, prefix_k, prefix_v,
                  scale):
    global paged_launches
    B, Hq, D = q.shape
    nb, bs, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    maxb = table.shape[1] if table.dim() == 2 else -1
    n_p = 0 if prefix_k is None else prefix_k.shape[-3]
    per_row = prefix_k is not None and prefix_k.dim() == 4
    pshape = ((B, n_p, Hkv, D) if per_row else (n_p, Hkv, D))
    if k_pool.shape != (nb, bs, Hkv, D) or v_pool.shape != k_pool.shape or \
            Hq % Hkv or table.shape != (B, maxb) or q_pos.shape != (B,) or \
            (prefix_k is not None and (prefix_k.shape != pshape
                                       or prefix_v.shape != pshape)):
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}, table "
            f"{tuple(table.shape)}, q_pos {tuple(q_pos.shape)}, prefix "
            f"{None if prefix_k is None else tuple(prefix_k.shape)} do not "
            f"match")
    if D > PAGED_DMAX or Hq // Hkv > GMAX or bs & (bs - 1):
        raise ValueError(f"flash_decode_paged: head dim {D} > "
                         f"{PAGED_DMAX}, group {Hq // Hkv} > {GMAX} or block "
                         f"size {bs} not a power of two")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "table": table, "q_pos": q_pos}
    if prefix_k is not None:
        tensors.update(prefix_k=prefix_k, prefix_v=prefix_v)
    code = _build.checked_args("flash_decode_paged", tensors, q.dtype)
    lib = _build.bind("flash_decode_paged", _PAGED_ARGS)
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


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor, *,
                       q_pos: torch.Tensor,
                       prefix_k: Optional[torch.Tensor] = None,
                       prefix_v: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None,
                       backend: Optional[str] = None) -> torch.Tensor:
    """Shapes as in :func:`ref.paged_decode_attention`, q_pos (B,) and
    table (B, maxb) int32, and an optional prefix bank (n_p, Hkv, D) or
    (B, n_p, Hkv, D) in the pool's dtype. On a CUDA tensor this always
    launches the kernel, with or without a prefix bank."""
    if backend == "torch" or (backend is None and q.device.type == "cpu"):
        return flash_decode_paged_torch(q, k_pool, v_pool, table,
                                        q_pos=q_pos, prefix_k=prefix_k,
                                        prefix_v=prefix_v, scale=scale)
    if backend not in (None, "cuda"):
        raise ValueError(f"flash_decode_paged: unknown backend {backend!r}")
    if prefix_k is not None:
        prefix_k = prefix_k.contiguous()
        prefix_v = prefix_v.contiguous()
    return _launch_paged(q, k_pool, v_pool,
                         table.to(torch.int32).contiguous(),
                         q_pos.to(torch.int32).contiguous(), prefix_k,
                         prefix_v, scale)
