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
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import selective_scan as ss

_BACKEND: Optional[str] = None          # None: by tensor device
# kernel name -> (module, attribute holding its launch count)
_KERNELS = {"lora_matmul": (lm, "launches"),
            "lora_matmul_bwd": (lm, "bwd_launches"),
            "flash_attention": (fa, "launches"),
            "flash_decode": (fd, "launches"),
            "flash_decode_paged": (fd, "paged_launches"),
            "lora_bgmv_rows": (bg, "rows_launches"),
            "lora_bgmv_seq": (bg, "seq_launches"),
            "selective_scan": (ss, "launches"),
            "rglru_scan": (rg, "launches"),
            "selective_scan_bwd": (ss, "bwd_launches"),
            "rglru_scan_bwd": (rg, "bwd_launches")}


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

def _int32(x, shape, device) -> torch.Tensor:
    """x (a scalar, a list or a tensor) as a contiguous int32 tensor on
    ``device``, broadcast to ``shape`` unless that is None; a tensor that
    is all of these already is returned as it is."""
    t = torch.as_tensor(x, device=device)
    if shape is not None and t.shape != shape:
        t = t.expand(shape)
    return fd.contiguous_as(t, torch.int32)


def flash_decode(q, k, v, *, q_pos, kv_pos, prefix_k=None, prefix_v=None,
                 prefix_ids=None, window: int = 0, causal: bool = True,
                 scale: Optional[float] = None,
                 backend: Optional[str] = None):
    """One decode token per sequence against a KV cache (+ prefix bank).

    q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos: scalar or (B,); kv_pos:
    (T,) or (B, T) (``+1e9`` sentinel marks unwritten slots). prefix_k/v:
    (n_p, Hkv, D) or (B, n_p, Hkv, D) always-visible slots at position -1
    in front, as the TPU kernel route's concatenation puts them
    (``repro/kernels/ops.py::flash_decode``), or a multi-tenant bank's
    stacked (n_slots, n_p, Hkv, D) slots with ``prefix_ids`` (B,) naming
    each row's slot: the bf16 kernel reads them in place, the f32 kernel
    and the plain version (the CPU path) after :func:`fd.with_prefix`
    concatenates them. Returns (B, Hq, D)."""
    B, T = k.shape[0], k.shape[1]
    qp = _int32(q_pos, (B,), q.device)
    kp = _int32(kv_pos, (B, T), q.device)
    if prefix_k is not None:
        prefix_k = fd.contiguous_as(prefix_k, k.dtype)
        prefix_v = fd.contiguous_as(prefix_v, v.dtype)
    if prefix_ids is not None:
        prefix_ids = _int32(prefix_ids, (B,), q.device)
    return fd.flash_decode(q.contiguous(), k, v, q_pos=qp, kv_pos=kp,
                           window=window,
                           causal=causal, scale=scale, prefix_k=prefix_k,
                           prefix_v=prefix_v, prefix_ids=prefix_ids,
                           backend=_pick(backend))


def flash_decode_paged(q, k_pool, v_pool, table, *, q_pos, prefix_k=None,
                       prefix_v=None, prefix_ids=None,
                       scale: Optional[float] = None,
                       backend: Optional[str] = None):
    """One decode token per sequence against a paged block-pool cache.

    q: (B, Hq, D); k_pool, v_pool: (n_blocks, bs, Hkv, D); table:
    (B, max_blocks) int — row b's logical token ``t`` lives at
    ``pool[table[b, t // bs], t % bs]``, so positions are implicit and
    visibility is causal; entries >= n_blocks are the sentinel and clamp
    into the pool. prefix_k/v: (n_p, Hkv, D) or (B, n_p, Hkv, D)
    always-visible slots in front, or stacked (n_slots, n_p, Hkv, D) with
    ``prefix_ids`` (B,), as :func:`flash_decode` takes them. The same function as the reference's
    ``ops.flash_decode_paged`` with or without a prefix bank; for CUDA
    tensors it is always the paged kernel (no gather into a dense copy).
    Returns (B, Hq, D)."""
    B = q.shape[0]
    qp = _int32(q_pos, (B,), q.device)
    if prefix_k is not None:
        prefix_k = fd.contiguous_as(prefix_k, k_pool.dtype)
        prefix_v = fd.contiguous_as(prefix_v, v_pool.dtype)
    if prefix_ids is not None:
        prefix_ids = _int32(prefix_ids, (B,), q.device)
    return fd.flash_decode_paged(q.contiguous(), k_pool, v_pool,
                                 _int32(table, None, q.device),
                                 q_pos=qp, prefix_k=prefix_k,
                                 prefix_v=prefix_v, prefix_ids=prefix_ids,
                                 scale=scale, backend=_pick(backend))


# ---------------------------------------------------------------------------
# Selective scan (Mamba-1)
# ---------------------------------------------------------------------------

def selective_scan(x, dt, A, Bm, C, D, h0=None, *,
                   backend: Optional[str] = None):
    """The Mamba-1 scan over a sequence (shapes as
    :func:`ref.selective_scan`). The reference's XLA-only algorithms
    (``_selective_scan_assoc``, ``set_ssm_xla_impl``) compute the same
    function and are covered by the plain version. Differentiable: the
    backward is the ``selective_scan_bwd`` kernel on the card (the
    reference differentiates the scan through XLA); its oracle is
    autograd through :func:`ref.selective_scan`."""
    return ss.selective_scan(x, dt, A, Bm, C, D, h0, backend=_pick(backend))


def selective_scan_step(x, dt, A, Bm, C, D, h):
    """One decode step, torch operations (the reference has no kernel for
    it). x, dt: (B, Di); Bm, C: (B, N); h: (B, Di, N). Returns (y (B, Di)
    in x.dtype, h f32)."""
    dtf, xf = dt.float(), x.float()
    dA = torch.exp(dtf[..., None] * A.float())
    dBx = dtf[..., None] * Bm.float()[:, None, :] * xf[..., None]
    h = h.float() * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, C.float()) + D.float() * xf
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma)
# ---------------------------------------------------------------------------

def rglru(x, r_gate, i_gate, a_param, h0=None, *, c: float = 8.0,
          backend: Optional[str] = None):
    """The RG-LRU recurrence over a sequence (shapes as :func:`ref.rglru`;
    h0 may also be one shared (W,) state). The reference's XLA-only
    ``_rglru_assoc`` computes the same function and is covered by the
    plain version. Differentiable: the backward is the ``rglru_scan_bwd``
    kernel on the card; its oracle is autograd through
    :func:`ref.rglru`."""
    return rg.rglru(x, r_gate, i_gate, a_param, h0, c=c,
                    backend=_pick(backend))


def rglru_step(x, r_gate, i_gate, a_param, h, c: float = 8.0):
    """One decode step, torch operations (the reference has no kernel for
    it): the plain version's gates and one link of its chain; all (B, W).
    Returns (y (B, W) in x.dtype, h f32)."""
    a, u = rg.gates(x, r_gate, i_gate, a_param, c)
    h = a * h.float() + u
    return h.to(x.dtype), h
