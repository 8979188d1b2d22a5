"""Flash decode (one query per row against its KV cache): CUDA kernel
(``csrc/flash_decode.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode_pallas``
(body ``_kernel``). The ``g = Hq / Hkv`` query heads that share a KV head
share one pass over its cache; ``g`` need not be a power of two. Per-row
``q_pos`` (B,) and ``kv_pos`` (B, T): ``+1e9`` sentinel slots never show,
negative (prefix) slots always do. Bound on an H100 and design: see the
source note in ``csrc/flash_decode.cu``.

The plain version is the kernel's dataflow in torch (the same 32-key tile
loop as ``flash_attention.online_softmax``). ``flash_decode`` launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors or
when the caller passes ``backend="torch"``. ``launches`` counts kernel
launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DMAX, online_softmax, visible

launches = 0

GMAX = 16                  # largest GQA group the kernel takes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]


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
