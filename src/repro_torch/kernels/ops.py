"""Kernel dispatch layer (counterpart of ``repro/kernels/ops.py``).

Each op has two implementations:

- ``cuda``  — the hand-written Hopper kernel (``csrc/*.cu``), taken for
  every CUDA tensor;
- ``torch`` — the kernel's plain PyTorch version, taken for CPU tensors,
  and on the card only when the caller asks for it by name
  (``backend="torch"`` per call, or :func:`backend` / :func:`set_backend`
  around a region, as ``chip_smoke.py`` does to compare the two). Nothing
  selects it automatically and nothing falls back to it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lora_bgmv as bg
from repro_torch.kernels import lora_matmul as lm

_BACKEND: Optional[str] = None          # None: by tensor device
# kernel name -> (module, attribute holding its launch count)
_KERNELS = {"lora_matmul": (lm, "launches"),
            "lora_matmul_bwd": (lm, "bwd_launches"),
            "flash_attention": (fa, "launches"),
            "flash_decode": (fd, "launches"),
            "lora_bgmv_rows": (bg, "rows_launches"),
            "lora_bgmv_seq": (bg, "seq_launches")}


def set_backend(name: Optional[str]) -> None:
    global _BACKEND
    if name not in (None, "cuda", "torch"):
        raise ValueError(f"unknown kernel backend {name!r}: expected "
                         "None, 'cuda' or 'torch'")
    _BACKEND = name


def get_backend() -> Optional[str]:
    return _BACKEND


@contextlib.contextmanager
def backend(name: Optional[str]):
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


def _pick(b: Optional[str]) -> Optional[str]:
    return b or _BACKEND


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


# ---------------------------------------------------------------------------
# LoRA-fused matmul (differentiable: the reference's custom VJP)
# ---------------------------------------------------------------------------

def lora_matmul(x, w, a=None, b=None, scale: float = 1.0, bias=None, *,
                backend: Optional[str] = None):
    """y = x @ w (+ scale * (x@a)@b) (+ bias). Without an adapter this is a
    plain ``torch.matmul``; with one, x must be 2-D (M, K) and the fused
    kernel runs.

    Differentiable (:class:`_LoRAMatmul`, the reference's ``_lora_vjp``):
    the backward costs ``dx`` (the forward kernel again) and ``dA``/``dB``
    (the ``lora_matmul_bwd`` kernel); ``dW = xᵀ dy`` and ``dbias`` are
    formed only when ``w`` / ``bias`` require grad (full fine-tuning),
    never under PEFT."""
    if a is None:
        y = x @ w
        return (y + bias.to(y.dtype)) if bias is not None else y
    return _LoRAMatmul.apply(x, w, a, b, bias, float(scale),
                             _pick(backend))


class _LoRAMatmul(torch.autograd.Function):
    """Forward and backward rules of ``repro/kernels/ops.py::_lora_vjp``
    (``_lora_fwd_rule``, ``_lora_bwd_rule``), with the same cast points."""

    @staticmethod
    def forward(ctx, x, w, a, b, bias, scale, impl):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale, ctx.impl = scale, impl
        ctx.bias_dtype = None if bias is None else bias.dtype
        return lm.lora_matmul(x, w, a, b, scale, bias, backend=impl)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dw = da = db = dbias = None
        if need[0]:
            # dx = dy Wᵀ + s (dy Bᵀ) Aᵀ: the forward kernel with (W, A, B)
            # -> (Wᵀ, Bᵀ, Aᵀ); Wᵀ is a copy of the frozen weight per call
            dx = lm.lora_matmul(dy, w.t().contiguous(), b.t().contiguous(),
                                a.t().contiguous(), ctx.scale,
                                backend=ctx.impl).to(x.dtype)
        if need[2] or need[3]:
            da, db = lm.lora_matmul_bwd(x, dy, a, b, ctx.scale,
                                        backend=ctx.impl)
            da, db = da.to(a.dtype), db.to(b.dtype)
        if need[1]:                       # full fine-tuning only
            dw = (x.t() @ dy).to(w.dtype)
        if need[4]:
            dbias = dy.float().sum(0).to(ctx.bias_dtype)
        return dx, dw, da, db, dbias, None, None


def lora_bgmv(x, w, a, b, adapter_ids, scale: float = 1.0, bias=None, *,
              backend: Optional[str] = None):
    """Multi-tenant LoRA matmul: per-row adapter selection from a stacked
    bank (serving only, no backward).

    x: (M, K) with adapter_ids (M,), or (B, S, K) with adapter_ids (B,).
    a: (n_slots, K, r); b: (n_slots, r, N); ids in [0, n_slots). Row i gets
    ``x_i @ w + scale * (x_i @ a[id_i]) @ b[id_i]`` (+ bias), bit-identical
    to :func:`lora_matmul` with that row's adapter. 3-D x with S > 1 takes
    the seq kernel (one adapter per sequence); any other x the rows
    kernel."""
    ids = torch.as_tensor(adapter_ids, device=x.device).to(torch.int32)
    # ids address x's leading dim: rows of 2-D x, whole sequences of 3-D x
    if tuple(ids.shape) != (x.shape[0],):
        raise ValueError(
            f"adapter_ids {tuple(ids.shape)} must be ({x.shape[0]},): one id "
            f"per {'sequence' if x.dim() == 3 else 'row'} of x "
            f"{tuple(x.shape)}")
    if x.dim() == 3 and x.shape[1] > 1:
        return bg.lora_bgmv_seq(x, w, a, b, ids, float(scale), bias,
                                backend=_pick(backend))
    shp = x.shape
    y = bg.lora_bgmv_rows(x.reshape(-1, shp[-1]), w, a, b, ids,
                          float(scale), bias, backend=_pick(backend))
    return y.reshape(*shp[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Flash attention (GQA + prefix-KV + sliding window, position-based masking)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, q_pos, kv_pos, window: int = 0,
                    causal: bool = True, scale: Optional[float] = None,
                    backend: Optional[str] = None):
    """Online-softmax attention. Shapes as in :func:`ref.attention`."""
    return fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                              window=window, causal=causal, scale=scale,
                              backend=_pick(backend))


# ---------------------------------------------------------------------------
# Flash decode (single-token attention against a padded KV cache)
# ---------------------------------------------------------------------------

def flash_decode(q, k, v, *, q_pos, kv_pos, prefix_k=None, prefix_v=None,
                 window: int = 0, causal: bool = True,
                 scale: Optional[float] = None,
                 backend: Optional[str] = None):
    """One decode token per sequence against a KV cache (+ prefix bank).

    q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos: scalar or (B,); kv_pos:
    (T,) or (B, T) (``+1e9`` sentinel marks unwritten slots). prefix_k/v:
    (n_p, Hkv, D) or (B, n_p, Hkv, D) always-visible slots, concatenated
    in front at position -1 as the TPU kernel route does
    (``repro/kernels/ops.py::flash_decode``). Returns (B, Hq, D)."""
    B, T = k.shape[0], k.shape[1]
    qp = torch.as_tensor(q_pos, device=q.device).to(torch.int32).expand(B)
    kp = torch.as_tensor(kv_pos, device=q.device).to(torch.int32) \
        .expand(B, T)
    if prefix_k is not None:
        if prefix_k.dim() == 3:
            prefix_k = prefix_k[None].expand(B, *prefix_k.shape)
            prefix_v = prefix_v[None].expand(B, *prefix_v.shape)
        n_p = prefix_k.shape[1]
        k = torch.cat([prefix_k.to(k.dtype), k], dim=1)
        v = torch.cat([prefix_v.to(v.dtype), v], dim=1)
        kp = torch.cat([kp.new_full((B, n_p), -1), kp], dim=1)
    return fd.flash_decode(q.contiguous(), k, v, q_pos=qp.contiguous(),
                           kv_pos=kp.contiguous(), window=window,
                           causal=causal, scale=scale,
                           backend=_pick(backend))
