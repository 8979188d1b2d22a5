"""Prefill flash attention (GQA, prefix-KV, sliding window, position masks):
CUDA kernel (``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``). Masking follows ``kernels/ref.py``: causal ``kv_pos <=
q_pos``, an optional window, prefix slots (``kv_pos < 0``) always visible,
``+1e9`` sentinels never. Bound on an H100 and design: see the source note
in ``csrc/flash_attention.cu``.

The plain version is the kernel's dataflow written in torch: an online
softmax over 32-key tiles with f32 state, ``NEG_INF = -1e30`` for masked
scores and ``l`` clamped at 1e-30. ``flash_attention`` launches the kernel
for CUDA tensors and takes the plain version only for CPU tensors or when
the caller passes ``backend="torch"``. ``launches`` counts kernel
launches, nothing else.

``flash_attention`` is differentiable (:class:`_FlashAttention`). The
reference has no attention backward kernel: ``flash_attention_pallas`` has
no VJP, and its training takes this gradient from XLA's autodiff of the
f32 blocked softmax ``repro/kernels/ops.py::_flash_xla``. The port's
counterpart is :func:`attention_bwd`, plain torch tensor operations that
recompute the f32 scores with the same position masks, one query chunk at
a time (so the f32 score tensors stay under ``SCORE_BUDGET`` elements),
and form ``dq``, ``dk``, ``dv`` with ``dk``/``dv`` summed over each GQA
group; prefix slots get their gradient through ``dk``/``dv``. It never
runs the plain tile loop: on the card the forward is the kernel and the
backward is cuBLAS products and elementwise passes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0

KT = 32                    # keys per tile, as in csrc/attn_tile.cuh
DMAX = 128
NEG_INF = -1e30
SCORE_BUDGET = 1 << 25     # f32 elements per score tensor in the backward

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]


def visible(qp: torch.Tensor, kp: torch.Tensor, window: int,
            causal: bool) -> torch.Tensor:
    """Broadcasting visibility of int64 query / key positions."""
    vis = (kp <= qp) if causal else (kp < 10 ** 8)
    if window and window > 0:
        vis = vis & ((qp - kp) < window)
    return vis | (kp < 0)


def online_softmax(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   vis_fn, scale: float) -> torch.Tensor:
    """The kernels' tile loop. qf: (B, Hkv, g, S, D) f32; k, v: (B, T, Hkv,
    D); ``vis_fn(t0, t1)`` gives the visibility of keys [t0, t1) broadcast
    to (B, 1, 1, S, t1 - t0). Returns (B, Hkv, g, S, D) f32."""
    B, Hkv, g, S, D = qf.shape
    T = k.shape[1]
    m = qf.new_full((B, Hkv, g, S), NEG_INF)
    l = qf.new_zeros((B, Hkv, g, S))
    acc = qf.new_zeros((B, Hkv, g, S, D))
    for t0 in range(0, T, KT):
        t1 = min(t0 + KT, T)
        kt = k[:, t0:t1].float().permute(0, 2, 1, 3)        # (B, Hkv, t, D)
        vt = v[:, t0:t1].float().permute(0, 2, 1, 3)
        s = torch.einsum("bngsd,bntd->bngst", qf, kt) * scale
        s = torch.where(vis_fn(t0, t1), s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bngst,bntd->bngsd", p,
                                                    vt)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def flash_attention_torch(q, k, v, *, q_pos, kv_pos, window: int = 0,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. q: (B, S, Hq, D); k, v: (B, T, Hkv, D); q_pos (S,);
    kv_pos (T,). Returns (B, S, Hq, D) in q.dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, S, Hkv, g, D).permute(0, 2, 3, 1, 4)
    qp = q_pos.to(torch.int64)[:, None]                      # (S, 1)
    kp = kv_pos.to(torch.int64)[None, :]                     # (1, T)
    out = online_softmax(
        qf, k, v, lambda t0, t1: visible(qp, kp[:, t0:t1], window, causal),
        scale)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _launch(q, k, v, q_pos, kv_pos, window, causal, scale):
    global launches
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or Hq % Hkv or \
            q_pos.shape != (S,) or kv_pos.shape != (T,):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, q_pos {tuple(q_pos.shape)}, kv_pos "
            f"{tuple(kv_pos.shape)} do not match")
    if D > DMAX:
        raise ValueError(f"flash_attention: head dim {D} > {DMAX}")
    code = _build.checked_args(
        "flash_attention",
        {"q": q, "k": k, "v": v, "q_pos": q_pos, "kv_pos": kv_pos}, q.dtype)
    lib = _build.bind("flash_attention", _ARGS)
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
        float(scale if scale is not None else D ** -0.5), int(causal),
        int(window or 0), code, _build.stream(q))
    _build.check(lib, "flash_attention", err)
    launches += 1
    return out


def _forward(q, k, v, q_pos, kv_pos, window, causal, scale, backend):
    if backend == "torch" or (backend is None and q.device.type == "cpu"):
        return flash_attention_torch(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                     window=window, causal=causal,
                                     scale=scale)
    if backend not in (None, "cuda"):
        raise ValueError(f"flash_attention: unknown backend {backend!r}")
    return _launch(q, k, v, q_pos.to(torch.int32).contiguous(),
                   kv_pos.to(torch.int32).contiguous(), window, causal,
                   scale)


def attention_bwd(q, k, v, dout, *, q_pos, kv_pos, window: int = 0,
                  causal: bool = True, scale: Optional[float] = None):
    """Gradient of softmax attention (shapes as in :func:`ref.attention`)
    by recompute: per query chunk the f32 scores, the masked softmax ``p``,
    ``dp = dout vᵀ`` and ``ds = p (dp - rowsum(p dp))``; then ``dq = s ds
    k``, ``dk = s dsᵀ q`` and ``dv = pᵀ dout``, dk/dv accumulated in f32
    over chunks and summed over each GQA group. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, S, Hkv, g, D)
    dof = dout.float().reshape(B, S, Hkv, g, D)
    kf, vf = k.float(), v.float()
    qp = q_pos.to(torch.int64)[:, None]
    kp = kv_pos.to(torch.int64)[None, :]
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    rows = max(1, SCORE_BUDGET // max(B * Hq * T, 1))
    for s0 in range(0, S, rows):
        s1 = min(s0 + rows, S)
        qc, doc = qf[:, s0:s1], dof[:, s0:s1]
        sc = torch.einsum("bsngd,btnd->bngst", qc, kf) * scale
        sc = torch.where(visible(qp[s0:s1], kp, window, causal), sc,
                         torch.full_like(sc, NEG_INF))
        p = torch.softmax(sc, dim=-1)
        dp = torch.einsum("bsngd,btnd->bngst", doc, vf)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, s0:s1] = torch.einsum("bngst,btnd->bsngd", ds, kf) * scale
        dk += torch.einsum("bngst,bsngd->btnd", ds, qc) * scale
        dv += torch.einsum("bngst,bsngd->btnd", p, doc)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain tile loop) forward and the
    recompute backward :func:`attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, causal, scale,
                backend):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.mask = (window, causal, scale)
        return _forward(q, k, v, q_pos, kv_pos, window, causal, scale,
                        backend)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        window, causal, scale = ctx.mask
        dq, dk, dv = attention_bwd(q, k, v, dout, q_pos=q_pos,
                                   kv_pos=kv_pos, window=window,
                                   causal=causal, scale=scale)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    window: int = 0, causal: bool = True,
                    scale: Optional[float] = None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Shapes as in :func:`ref.attention`; positions are int32.
    Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, window, causal,
                                 scale, backend)
