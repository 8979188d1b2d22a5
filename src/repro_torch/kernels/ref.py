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
import torch.nn.functional as F

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


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor, *,
                           q_pos, prefix_k: Optional[torch.Tensor] = None,
                           prefix_v: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Naive paged decode attention: gather the block pool, then
    :func:`decode_attention`. k_pool, v_pool: (n_blocks, bs, Hkv, D);
    table: (B, max_blocks) — token ``t`` of row ``b`` lives at
    ``pool[table[b, t // bs], t % bs]``, so positions are the slot indices
    (causal only); out-of-pool entries clamp into the pool. prefix_k/v:
    optional (n_p, Hkv, D) or (B, n_p, Hkv, D) slots at position -1.
    Returns (B, Hq, D) in q.dtype."""
    nb, bs, Hkv, D = k_pool.shape
    B, maxb = table.shape
    tbl = table.long().clamp(0, nb - 1)
    k = k_pool[tbl].reshape(B, maxb * bs, Hkv, D)
    v = v_pool[tbl].reshape(B, maxb * bs, Hkv, D)
    kv_pos = torch.arange(maxb * bs, device=q.device)[None].expand(B, -1)
    if prefix_k is not None:
        if prefix_k.dim() == 3:
            prefix_k = prefix_k[None].expand(B, *prefix_k.shape)
            prefix_v = prefix_v[None].expand(B, *prefix_v.shape)
        k = torch.cat([prefix_k.to(k.dtype), k], 1)
        v = torch.cat([prefix_v.to(v.dtype), v], 1)
        kv_pos = torch.cat([kv_pos.new_full((B, prefix_k.shape[1]), -1),
                            kv_pos], 1)
    return decode_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                            causal=True, scale=scale)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w + scale * (x @ a) @ b (+ bias). x: (..., K); w: (K, N)."""
    xf = x.float()
    y = xf @ w.float() + scale * (xf @ a.float()) @ b.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def lora_adapter_grads(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, scale: float):
    """The adapter half of :func:`lora_matmul_bwd`: (dA (K, r), dB (r, N))
    in f32 from x (M, K) and dy (M, N); no w, and no ``dW``."""
    xf, dyf = x.float(), dy.float()
    da = scale * xf.T @ (dyf @ b.float().T)
    db = scale * (xf @ a.float()).T @ dyf
    return da, db


def lora_matmul_bwd(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float, dy: torch.Tensor):
    """Naive VJP of :func:`lora_matmul` wrt (x, a, b), f32 math. The
    frozen-weight grad ``dW = x^T dy`` is deliberately absent: under the
    paper's PEFT regime it is never materialised. Returns (dx in x.dtype,
    dA f32, dB f32)."""
    dyf = dy.float()
    dx = dyf @ w.float().T + scale * (dyf @ b.float().T) @ a.float().T
    da, db = lora_adapter_grads(x, dy, a, b, scale)
    return dx.to(x.dtype), da, db


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


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """Mamba-1 selective scan, a naive loop over time in f32.

    x, dt: (B, S, Di); A: (Di, N); Bm, C: (B, S, N); D: (Di,); h0:
    optional (B, Di, N) initial state (the PEFT state prompt). Each step
    ``h = exp(dt A) h + (dt B) x`` and ``y = h·C + D x``. Returns
    (y (B, S, Di) in x.dtype, h_final (B, Di, N) f32)."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf, Df = A.float(), Bm.float(), C.float(), D.float()
    h = torch.zeros((Bb, Di, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        xt, dtt = xf[:, t], dtf[:, t]
        dA = torch.exp(dtt[..., None] * Af)
        dBx = dtt[..., None] * Bf[:, t][:, None, :] * xt[..., None]
        h = h * dA + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * xt)
    return torch.stack(ys, 1).to(x.dtype), h


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None,
          c: float = 8.0):
    """RG-LRU recurrence (RecurrentGemma eq. 5-7), a naive loop over time
    in f32.

    x, r_gate, i_gate: (B, S, W) gate pre-activations; a_param: (W,) raw,
    ``a = sigmoid(a_param)`` and ``a_t = a ** (c * sigmoid(r_t))``, taken
    as ``exp(sigmoid(r_t) * log_a)`` with ``log_a = -c * softplus(-a_param)``;
    ``h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 0)) (sigmoid(i_t) x_t)``.
    h0: optional (B, W) initial state. Returns (h_seq (B, S, W) in
    x.dtype, h_final (B, W) f32)."""
    B, S, W = x.shape
    log_a = -c * F.softplus(-a_param.float())
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    hs = []
    for t in range(S):
        a_t = torch.exp(torch.sigmoid(r_gate[:, t].float()) * log_a)
        gated = torch.sigmoid(i_gate[:, t].float()) * x[:, t].float()
        h = a_t * h + torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=0.0)) \
            * gated
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), h
