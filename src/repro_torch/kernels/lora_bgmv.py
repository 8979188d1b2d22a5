"""Multi-tenant LoRA projection: each row (or sequence) takes its own
adapter from a stack, ``y_i = x_i W + s (x_i A[id_i]) B[id_i] (+ bias)``.
Two CUDA kernels and their plain PyTorch version.

- ``lora_bgmv_rows`` (``csrc/lora_bgmv_rows.cu``): x (M, K), ids (M,); the
  decode shape. Replaces the TPU kernel
  ``repro/kernels/lora_bgmv.py::lora_bgmv_rows_pallas``.
- ``lora_bgmv_seq`` (``csrc/lora_bgmv_seq.cu``): x (B, S, K), ids (B,);
  the prefill shape. Replaces ``lora_bgmv_seq_pallas``.

a: (n_slots, K, r); b: (n_slots, r, N); ids int32 in [0, n_slots). Both
kernels run ``lora_matmul``'s tile loop (``csrc/lora_tile.cuh``), so each
row is bit-identical to ``lora_matmul`` run with that row's adapter. Valid
ids are the caller's contract: no launch reads them back on the host.

The wrappers launch a kernel for CUDA tensors and take the plain version
only for CPU tensors or when the caller passes ``backend="torch"``.
``rows_launches`` and ``seq_launches`` count kernel launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

rows_launches = 0
seq_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ROWS_ARGS = [_P] * 7 + [_I] * 4 + [_F, _I, _P]
_SEQ_ARGS = [_P] * 7 + [_I] * 5 + [_F, _I, _P]


def lora_bgmv_torch(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, adapter_ids: torch.Tensor, scale: float,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of both kernels: per-slot f32 math, one cast at the
    end. x (M, K) with ids (M,), or (B, S, K) with ids (B,). Each slot's
    rank-r term is added to its own rows only, through a mask (no gathered
    (M, K, r) copy, no host sync), so every row gets ``ref.lora_matmul``'s
    arithmetic with its own adapter."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1]).float()
    rid = adapter_ids.long()
    if x.dim() == 3:                               # per-sequence -> per-row
        rid = rid.repeat_interleave(shp[1])
    y = x2 @ w.float()
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    for s in range(a.shape[0]):
        lo = scale * (x2 @ a[s].float()) @ b[s].float()
        y = y + torch.where((rid == s)[:, None], lo, zero)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*shp[:-1], w.shape[-1])


def _check(name, x, w, a, b, ids, bias, rows_of_ids):
    K, N = w.shape
    n_slots, _, r = a.shape
    if x.shape[-1] != K or a.shape[1] != K or b.shape != (n_slots, r, N) or \
            tuple(ids.shape) != (rows_of_ids,) or \
            (bias is not None and bias.shape != (N,)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, ids {tuple(ids.shape)} do not "
                         "chain")
    if not 1 <= r <= 32:
        raise ValueError(f"{name}: the kernel takes rank 1..32, not {r}")
    ts = {"x": x, "w": w, "a": a, "b": b, "ids": ids}
    if bias is not None:
        ts["bias"] = bias
    return _build.checked_args(name, ts, x.dtype), N, r


def _launch_rows(x, w, a, b, ids, scale, bias):
    global rows_launches
    if x.dim() != 2:
        raise ValueError(f"lora_bgmv_rows: x must be (M, K), got "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    code, N, r = _check("lora_bgmv_rows", x, w, a, b, ids, bias, M)
    lib = _build.bind("lora_bgmv_rows", _ROWS_ARGS)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = lib.lora_bgmv_rows_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(), ids.data_ptr(),
        y.data_ptr(), M, N, K, r, float(scale), code, _build.stream(x))
    _build.check(lib, "lora_bgmv_rows", err)
    rows_launches += 1
    return y


def _launch_seq(x, w, a, b, ids, scale, bias):
    global seq_launches
    if x.dim() != 3:
        raise ValueError(f"lora_bgmv_seq: x must be (B, S, K), got "
                         f"{tuple(x.shape)}")
    B, S, K = x.shape
    code, N, r = _check("lora_bgmv_seq", x, w, a, b, ids, bias, B)
    if B > 65535:
        raise ValueError(f"lora_bgmv_seq: the kernel takes at most 65535 "
                         f"sequences, not {B}")
    lib = _build.bind("lora_bgmv_seq", _SEQ_ARGS)
    y = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    err = lib.lora_bgmv_seq_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(), ids.data_ptr(),
        y.data_ptr(), B, S, N, K, r, float(scale), code, _build.stream(x))
    _build.check(lib, "lora_bgmv_seq", err)
    seq_launches += 1
    return y


def _plain(x, backend, name):
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return True
    if backend not in (None, "cuda"):
        raise ValueError(f"{name}: unknown backend {backend!r}")
    return False


def lora_bgmv_rows(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, adapter_ids: torch.Tensor, scale: float,
                   bias: Optional[torch.Tensor] = None, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """x: (M, K); adapter_ids: (M,) int32. Returns (M, N) in x.dtype."""
    if _plain(x, backend, "lora_bgmv_rows"):
        return lora_bgmv_torch(x, w, a, b, adapter_ids, scale, bias)
    return _launch_rows(x, w, a, b, adapter_ids, scale, bias)


def lora_bgmv_seq(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, adapter_ids: torch.Tensor, scale: float,
                  bias: Optional[torch.Tensor] = None, *,
                  backend: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, K); adapter_ids: (B,) int32. Returns (B, S, N) in
    x.dtype."""
    if _plain(x, backend, "lora_bgmv_seq"):
        return lora_bgmv_torch(x, w, a, b, adapter_ids, scale, bias)
    return _launch_seq(x, w, a, b, adapter_ids, scale, bias)
