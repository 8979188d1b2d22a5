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
``_bwd_kernel``): ``dA = s xᵀ(dy Bᵀ)`` and ``dB = s (x A)ᵀ dy`` in f32,
never ``dW``; the rank-r intermediates stay f32 as in the TPU kernel. A
call launches a rank pass (u = x A, g = s dy Bᵀ) and a sweep split over M
(:func:`bwd_plan`) whose last block of each column tile adds the splits'
partials in order, on a ticket from a counter kept per device and stream.
Design: see the source note in ``csrc/lora_matmul_bwd.cu``.

In bf16 the forward runs on the tensor cores: a pass writes ``u = x A``
to an (M, r) f32 scratch, then a TMA-fed ``wgmma`` tile computes ``x W``
and adds ``s u B (+ bias)``, so a bf16 call launches two kernels. TMA
needs 16-byte-aligned bases and row strides, so :func:`_pad_for_tma`
zero-pads K and N to multiples of 8 (and copies a misaligned base) where
a shape needs it, and the wrapper slices y back; ``pad_copies`` counts
those copies. Every model shape is aligned. f32 keeps the CUDA-core tile.

``lora_matmul`` and ``lora_matmul_bwd`` launch their kernel for CUDA
tensors and take the plain version only for CPU tensors or when the caller
passes ``backend="torch"``. ``launches`` and ``bwd_launches`` count calls
of the op on the card (one per call, whatever the number of kernels it
launches), nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0
bwd_launches = 0
pad_copies = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 7 + [_I] * 4 + [_F, _I, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 4 + [_F] + [_I] * 3 + [_P]
# the backward sweep's blocks an SM (bwd_plan): one wave of two an SM
BWD_BLOCKS_PER_SM = 2
# Per (device, stream): the sweep's tile counters (zeros, reset by
# the kernel). Launches on one stream run in order, so one buffer
# serves calls of every shape.
_COUNTERS: dict = {}


# The plain versions are the oracle itself: the kernels' arithmetic is the
# naive f32 sum (with one cast at the end for the forward).
lora_matmul_torch = ref.lora_matmul
lora_matmul_bwd_torch = ref.lora_adapter_grads


def _pad_for_tma(x, w, a, b, bias):
    """The operands of a bf16 launch with K and N zero-padded to multiples
    of 8, and x and w copied where their base is not 16-byte aligned; an
    operand that needs neither is returned as it is. x (..., K), w (K, N),
    a (..., K, r), b (..., r, N), bias (N,) or None. Returns the five and
    the N to slice y back to. Zeros add exact zeros, so no bit of y[..., :N]
    changes."""
    K, N = w.shape
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8

    def fit(t, shape, aligned):
        global pad_copies
        if tuple(t.shape) == shape and \
                (not aligned or t.data_ptr() % 16 == 0):
            return t
        out = t.new_zeros(shape)
        out[tuple(slice(0, n) for n in t.shape)] = t
        pad_copies += 1
        return out

    return (fit(x, (*x.shape[:-1], Kp), True), fit(w, (Kp, Np), True),
            fit(a, (*a.shape[:-2], Kp, a.shape[-1]), False),
            fit(b, (*b.shape[:-1], Np), False),
            None if bias is None else fit(bias, (Np,), False), N)


def _operands(x, w, a, b, bias, r):
    """What a launch passes: in bf16 the operands through
    :func:`_pad_for_tma`, the N to slice y back to and the (rows, r) f32 u
    scratch; in f32 the operands as they are and no scratch."""
    if x.dtype != torch.bfloat16:
        return x, w, a, b, bias, w.shape[1], None
    x, w, a, b, bias, N = _pad_for_tma(x, w, a, b, bias)
    u = torch.empty((x.numel() // x.shape[-1], r), dtype=torch.float32,
                    device=x.device)
    return x, w, a, b, bias, N, u


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
    x, w, a, b, bias, N, u = _operands(x, w, a, b, bias, r)
    Kp, Np = w.shape
    y = torch.empty((M, Np), dtype=x.dtype, device=x.device)
    err = lib.lora_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if u is None else u.data_ptr(), y.data_ptr(),
        M, Np, Kp, r, float(scale), code, _build.stream(x))
    _build.check(lib, "lora_matmul", err)
    launches += 1
    return y if Np == N else y[:, :N].contiguous()


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """x: (M, K); w: (K, N); a: (K, r); b: (r, N); bias: (N,) or None.
    Returns (M, N) in x.dtype. A bf16 call on the card launches two
    kernels, the u pass and then the tensor-core tile."""
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return lora_matmul_torch(x, w, a, b, scale, bias)
    if backend not in (None, "cuda"):
        raise ValueError(f"lora_matmul: unknown backend {backend!r}")
    return _launch(x, w, a, b, scale, bias)


def bwd_plan(M: int, K: int, N: int, r: int, n_sm: int = 132,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """How ``csrc/lora_matmul_bwd.cu`` splits a call: the rank pass's
    ``rank`` route (``"mma"``: bf16, r <= 16, K and N multiples of 8, A^T
    and B within 200 KB of shared memory, and 16-byte aligned x, dy and b,
    which contiguous tensors of these shapes are; else ``"cuda-core"``), the
    rank bucket ``rt`` (8, 16 or 32), the sweep's column tile
    ``tc = 512 // rt``, the tiles of dA (``n_k``) and of dB (``n_n``), the
    rows of a split (a multiple of the sweep's 32 row groups) and the
    splits: as many splits as keep the sweep's grid within
    ``BWD_BLOCKS_PER_SM`` blocks for each of ``n_sm`` SMs (one wave), and
    at least one."""
    rt = 8 if r <= 8 else 16 if r <= 16 else 32
    tc = 512 // rt
    n_k, n_n = -(-K // tc), -(-N // tc)
    want = max(1, BWD_BLOCKS_PER_SM * n_sm // max(1, n_k + n_n))
    per = -(-M // want)
    rows = max(32, -(-per // 32) * 32)
    def staged(n):                           # a padded staged row
        return -(-n // 64) * 64 + 32
    mma = dtype == torch.bfloat16 and rt <= 16 and K % 8 == 0 and \
        N % 8 == 0 and 2 * rt * (staged(K) + staged(N)) <= 200 * 1024
    return dict(rank="mma" if mma else "cuda-core", rt=rt, tc=tc, n_k=n_k,
                n_n=n_n, rows=rows, splits=max(1, -(-M // rows)))


def _counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tile counters for a launch on ``t``'s device
    and current stream."""
    key = (t.get_device(), _build.stream(t))
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=t.device)
    return cnt


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
    plan = bwd_plan(M, K, N, r, _build.sm_count(x), x.dtype)
    tiles = plan["n_k"] + plan["n_n"]
    f32 = dict(dtype=torch.float32, device=x.device)
    u, g = torch.empty((M, r), **f32), torch.empty((M, r), **f32)
    da, db = torch.empty((K, r), **f32), torch.empty((r, N), **f32)
    part = torch.empty(plan["splits"] * tiles * plan["tc"] * plan["rt"],
                       **f32)
    cnt = _counters(x, tiles)
    err = lib.lora_matmul_bwd_launch(
        x.data_ptr(), dy.data_ptr(), a.data_ptr(), b.data_ptr(),
        u.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(),
        part.data_ptr(), cnt.data_ptr(), M, N, K, r, float(scale),
        plan["rows"], plan["splits"], code, _build.stream(x))
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
