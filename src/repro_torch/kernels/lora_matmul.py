"""LoRA-fused projection ``y = x W + s (x A) B (+ bias)``: CUDA kernel
(``csrc/lora_matmul.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/lora_matmul.py::lora_matmul_pallas``
(body ``_kernel``). Like it, the rank-r ``u = x A`` stays in f32 and the
whole sum is taken in f32 before the one cast to ``x.dtype``. (The JAX XLA
route rounds ``u`` to ``x.dtype`` first: the two agree exactly in f32 and
within tolerance in bf16.) Bound on an H100 and design: see the source
note in ``csrc/lora_matmul.cu``.

``lora_matmul`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors or when the caller passes ``backend="torch"``.
``launches`` counts kernel launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]


# The plain version is the oracle itself: the kernel's arithmetic is the
# naive f32 sum with one cast at the end.
lora_matmul_torch = ref.lora_matmul


def _launch(x, w, a, b, scale, bias):
    global launches
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    if w.shape[0] != K or a.shape[0] != K or b.shape != (r, N) or \
            (bias is not None and bias.shape != (N,)):
        raise ValueError(f"lora_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    if not 1 <= r <= 32:
        raise ValueError(f"lora_matmul: the kernel takes rank 1..32, not {r}")
    ts = {"x": x, "w": w, "a": a, "b": b}
    if bias is not None:
        ts["bias"] = bias
    code = _build.checked_args("lora_matmul", ts, x.dtype)
    lib = _build.bind("lora_matmul", _ARGS)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = lib.lora_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        M, N, K, r, float(scale), code, _build.stream(x))
    _build.check(lib, "lora_matmul", err)
    launches += 1
    return y


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N); bias: (N,) or None.
    Returns (M, N) in x.dtype."""
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return lora_matmul_torch(x, w, a, b, scale, bias)
    if backend not in (None, "cuda"):
        raise ValueError(f"lora_matmul: unknown backend {backend!r}")
    return _launch(x, w, a, b, scale, bias)
