"""LoRA-fused projection ``y = x W + s (x A) B (+ bias)`` and its adapter
gradients: CUDA kernels (``csrc/lora_matmul.cu``,
``csrc/lora_matmul_bwd.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/lora_matmul.py::lora_matmul_pallas``
(body ``_kernel``). Like it, the rank-r ``u = x A`` stays in f32 and the
whole sum is taken in f32 before the one cast to ``x.dtype``. (The JAX XLA
route rounds ``u`` to ``x.dtype`` first: the two agree exactly in f32 and
within tolerance in bf16.) Bound on an H100 and design: see the source
note in ``csrc/lora_matmul.cu``.

The backward kernel replaces
``repro/kernels/lora_matmul.py::lora_matmul_bwd_pallas`` (body
``_bwd_kernel``): ``dA = s xᵀ(dy Bᵀ)`` and ``dB = s (x A)ᵀ dy`` in f32 from
one read of x and dy, never ``dW``; the rank-r intermediates stay f32 as
in the TPU kernel. Design: see the source note in
``csrc/lora_matmul_bwd.cu``.

``lora_matmul`` and ``lora_matmul_bwd`` launch their kernel for CUDA
tensors and take the plain version only for CPU tensors or when the caller
passes ``backend="torch"``. ``launches`` and ``bwd_launches`` count kernel
launches (one per call of the op), nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0
bwd_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
_BWD_ARGS = [_P] * 8 + [_I, _I, _I, _I, _F, _I, _P]


# The plain versions are the oracle itself: the kernels' arithmetic is the
# naive f32 sum (with one cast at the end for the forward).
lora_matmul_torch = ref.lora_matmul
lora_matmul_bwd_torch = ref.lora_adapter_grads


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


def _launch_bwd(x, dy, a, b, scale):
    global bwd_launches
    M, K = x.shape
    N, r = dy.shape[1], a.shape[1]
    if dy.shape[0] != M or a.shape[0] != K or b.shape != (r, N):
        raise ValueError(f"lora_matmul_bwd: shapes x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    if not 1 <= r <= 32:
        raise ValueError(f"lora_matmul_bwd: the kernel takes rank 1..32, "
                         f"not {r}")
    code = _build.checked_args("lora_matmul_bwd",
                               {"x": x, "dy": dy, "a": a, "b": b}, x.dtype)
    lib = _build.bind("lora_matmul_bwd", _BWD_ARGS)
    f32 = dict(dtype=torch.float32, device=x.device)
    u, g = torch.empty((M, r), **f32), torch.empty((M, r), **f32)
    da, db = torch.empty((K, r), **f32), torch.empty((r, N), **f32)
    err = lib.lora_matmul_bwd_launch(
        x.data_ptr(), dy.data_ptr(), a.data_ptr(), b.data_ptr(),
        u.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(),
        M, N, K, r, float(scale), code, _build.stream(x))
    _build.check(lib, "lora_matmul_bwd", err)
    bwd_launches += 1
    return da, db


def lora_matmul_bwd(x: torch.Tensor, dy: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: float, *,
                    backend: Optional[str] = None):
    """Adapter grads of :func:`lora_matmul`. x: (M, K); dy: (M, N); a:
    (K, r); b: (r, N), one dtype. Returns (dA (K, r), dB (r, N)), both
    f32."""
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return lora_matmul_bwd_torch(x, dy, a, b, scale)
    if backend not in (None, "cuda"):
        raise ValueError(f"lora_matmul_bwd: unknown backend {backend!r}")
    return _launch_bwd(x, dy, a, b, scale)
