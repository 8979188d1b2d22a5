"""Torch oracles for the ported kernels (counterpart of
``repro/kernels/ref.py``): deliberately naive, no blocking, f32 math.

Masking is position based. Each query row has an absolute position
``q_pos[i]`` and each key/value slot a position ``kv_pos[j]``. A slot is
visible iff

    kv_pos[j] < 0                        (prefix-KV slots: always visible)
 or (kv_pos[j] <= q_pos[i]              (causal)
     and q_pos[i] - kv_pos[j] < window)  (sliding window; window<=0 => off)

Padding slots use kv_pos = +LARGE (``10**9``) so they are never visible.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visibility_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    window: int = 0, causal: bool = True) -> torch.Tensor:
    """(S, T) boolean visibility per the shared semantics above."""
    q = q_pos.to(torch.int64)[:, None]
    k = kv_pos.to(torch.int64)[None, :]
    vis = (k <= q) if causal else (k < 10 ** 8).expand(q.shape[0], -1)
    if window and window > 0:
        vis = vis & ((q - k) < window)
    return vis | (k < 0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              window: int = 0, causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Naive GQA attention. q: (B, S, Hq, D); k, v: (B, T, Hkv, D).
    Returns (B, S, Hq, D) in q.dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, S, Hkv, g, D).float()
    scores = torch.einsum("bsngd,btnd->bngst", qf, k.float()) * scale
    vis = visibility_mask(q_pos, kv_pos, window, causal)
    scores = torch.where(vis, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_pos, kv_pos, window: int = 0, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Naive single-token decode attention against a (padded) KV cache.
    q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos: scalar or (B,); kv_pos:
    (T,) or (B, T). Returns (B, Hq, D) in q.dtype."""
    B, Hq, D = q.shape
    T = k.shape[1]
    qp = torch.as_tensor(q_pos, device=q.device).to(torch.int64).expand(B)
    kp = torch.as_tensor(kv_pos, device=q.device).to(torch.int64) \
        .expand(B, T)
    return torch.stack([
        attention(q[b][None, None], k[b][None], v[b][None], q_pos=qp[b][None],
                  kv_pos=kp[b], window=window, causal=causal,
                  scale=scale)[0, 0]
        for b in range(B)])


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w + scale * (x @ a) @ b (+ bias). x: (..., K); w: (K, N)."""
    xf = x.float()
    y = xf @ w.float() + scale * (xf @ a.float()) @ b.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def lora_bgmv(x: torch.Tensor, w: torch.Tensor, a_stack: torch.Tensor,
              b_stack: torch.Tensor, adapter_ids: torch.Tensor, scale: float,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Naive multi-LoRA matmul: per-row adapter gather, f32 math.

    x: (M, K) with adapter_ids (M,), or (B, S, K) with adapter_ids (B,)
    (one adapter per sequence). a_stack: (n_slots, K, r); b_stack:
    (n_slots, r, N). Row i computes
    ``x_i @ w + scale * (x_i @ a[id_i]) @ b[id_i]`` (+ bias)."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1]).float()
    ids = torch.as_tensor(adapter_ids, device=x.device).long()
    if ids.shape[0] != x2.shape[0]:                # per-sequence -> per-row
        ids = ids.repeat_interleave(shp[1])
    a_sel = a_stack.float()[ids]                   # (M, K, r)
    b_sel = b_stack.float()[ids]                   # (M, r, N)
    y = x2 @ w.float()
    u = torch.einsum("mk,mkr->mr", x2, a_sel)
    y = y + scale * torch.einsum("mr,mrn->mn", u, b_sel)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*shp[:-1], w.shape[-1])
