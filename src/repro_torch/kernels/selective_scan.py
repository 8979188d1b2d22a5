"""Mamba-1 selective scan: a CUDA kernel (``csrc/selective_scan.cu``) and
its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/selective_scan.py::selective_scan_pallas`` (body
``_kernel``): per step ``dA = exp(dt A)``, ``h = h dA + (dt x) B``,
``y = h·C + D x`` with the state in f32 across the sequence; returns
``(y in x.dtype, h_final f32)``. The TPU kernel's tiling limits (``S %
chunk``, ``Di % block``) do not carry over: the kernel takes any S and Di.
Bound on an H100 and design: see the source note in
``csrc/selective_scan.cu``.

Dtypes are mixed: x, dt, B and C share one dtype (f32 or bf16), while A,
D, h0 and h_final are always f32. B and C may be strided views (the
columns of the ``x_proj`` output): the kernel takes their batch and time
strides, so no copy is made. h0 is None, per row ``(B, Di, N)``, or one
``(Di, N)`` state expanded over the batch (batch stride 0).

The kernel has no backward (nor has the TPU kernel: the reference
differentiates the scan through XLA), so on the card the wrapper raises
when autograd would need one. ``selective_scan`` launches the kernel for
CUDA tensors and takes the plain version only for CPU tensors or when the
caller passes ``backend="torch"``. ``launches`` counts kernel launches,
nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0

NMAX = 16                  # largest state width the kernel takes
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 9 + [_I] * 4 + [_L] * 3 + [_I, _P]


def selective_scan_torch(x, dt, A, Bm, C, D, h0=None):
    """Plain version: the kernel's step order, one vectorised step per
    time step. Shapes as :func:`selective_scan`."""
    Bb, S, Di = x.shape
    Af, Df = A.float(), D.float()
    h = torch.zeros((Bb, Di, A.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else \
        h0.float().expand(Bb, Di, A.shape[-1])
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        dA = torch.exp(dtt[..., None] * Af)
        h = h * dA + (dtt * xt)[..., None] * Bm[:, t].float()[:, None, :]
        ys.append((h * C[:, t].float()[:, None, :]).sum(-1) + Df * xt)
    return torch.stack(ys, 1).to(x.dtype), h


def _launch(x, dt, A, Bm, C, D, h0):
    global launches
    Bb, S, Di = x.shape
    N = A.shape[-1]
    if dt.shape != x.shape or A.shape != (Di, N) or D.shape != (Di,) or \
            Bm.shape != (Bb, S, N) or C.shape != Bm.shape or \
            (h0 is not None and h0.shape[-2:] != (Di, N)):
        raise ValueError(
            f"selective_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(C.shape)}, D "
            f"{tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not match")
    if not 1 <= N <= NMAX:
        raise ValueError(f"selective_scan: the kernel takes a state width "
                         f"of 1..{NMAX}, not {N}")
    ins = [x, dt, A, Bm, C, D] + ([] if h0 is None else [h0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "selective_scan: the CUDA kernel has no backward; training "
            "through the scan is not ported (ROADMAP: ssm training, a "
            "backward for selective_scan)")
    ts = {"x": x, "dt": dt, "A": A, "D": D, "B": Bm, "C": C}
    if h0 is not None:
        ts["h0"] = h0
    code = _build.checked_args("selective_scan", ts, x.dtype,
                               f32=("A", "D", "h0"), strided=("B", "C", "h0"))
    if Bm.stride() != C.stride():
        raise ValueError(f"selective_scan: B {Bm.stride()} and C "
                         f"{C.stride()} must share their strides")
    h0_sb = 0
    if h0 is not None:
        if h0.dim() == 2:
            h0 = h0.expand(Bb, Di, N)
        if h0.dim() != 3 or h0.stride(1) != N or \
                h0.stride(0) not in (0, Di * N) and Bb > 1:
            raise ValueError(
                f"selective_scan: h0 {tuple(h0.shape)} with strides "
                f"{h0.stride()} must be (Di, N)-contiguous per row")
        h0_sb = h0.stride(0)
    lib = _build.bind("selective_scan", _ARGS)
    y = torch.empty_like(x)
    hT = torch.empty((Bb, Di, N), dtype=torch.float32, device=x.device)
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        C.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hT.data_ptr(), Bb, S, Di, N, Bm.stride(0),
        Bm.stride(1), h0_sb, code, _build.stream(x))
    _build.check(lib, "selective_scan", err)
    launches += 1
    return y, hT


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   backend: Optional[str] = None):
    """x, dt: (B, S, Di); A: (Di, N) f32; Bm, C: (B, S, N); D: (Di,) f32;
    h0: None, (B, Di, N) or (Di, N), f32. Returns (y (B, S, Di) in
    x.dtype, h_final (B, Di, N) f32)."""
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return selective_scan_torch(x, dt, A, Bm, C, D, h0)
    if backend not in (None, "cuda"):
        raise ValueError(f"selective_scan: unknown backend {backend!r}")
    return _launch(x, dt, A, Bm, C, D, h0)
