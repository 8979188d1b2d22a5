"""RG-LRU recurrence: a CUDA kernel (``csrc/rglru_scan.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py::rglru_pallas``
(body ``_kernel``): per channel ``log_a = -c softplus(-a_param)``, per step
``a_t = exp(sigmoid(r_t) log_a)`` and ``h = a_t h + sqrt(max(1 - a_t², 0))
(sigmoid(i_t) x_t)``, the state in f32 across the sequence; returns
``(h_seq in x.dtype, h_final f32)``. The TPU kernel's tiling limits (``S %
chunk``, ``W % block_w``) do not carry over: the kernel takes any S and W.
Bound on an H100 and design: see the source note in ``csrc/rglru_scan.cu``;
:func:`plan` gives a call's block shape, ring depth and copy route.

Dtypes are mixed: x, r_gate and i_gate share one dtype (f32 or bf16),
while a_param, h0 and h_final are always f32. h0 is None, per row
``(B, W)``, or one ``(W,)`` state expanded over the batch (batch stride
0). A padded column of a ragged wave carries ``r_gate = -1e9``: then
``a_t`` is exactly 1 and the input term exactly 0, so the state passes
through bit for bit. The kernel takes each power of 2, reciprocal and
square root of the gates from the special-function units: its outputs
may differ from the plain version's in the last bits.

The kernel has no backward (nor has the TPU kernel: the reference
differentiates the recurrence through XLA), so on the card the wrapper
raises when autograd would need one. ``rglru`` launches the kernel for CUDA
tensors and takes the plain version only for CPU tensors or when the
caller passes ``backend="torch"``. ``launches`` counts kernel launches,
nothing else; ``last_plan`` is the :func:`plan` the last launch ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

launches = 0
last_plan: Optional[dict] = None

CB = 32                    # channels a block of the kernel
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGS = [_P] * 7 + [_I] * 3 + [_L, _F] + [_I] * 4 + [_P]


def plan(B: int, W: int, dtype: torch.dtype = torch.bfloat16,
         n_sm: int = 132, aligned: bool = True) -> dict:
    """How ``csrc/rglru_scan.cu`` runs a call: blocks of ``cb`` channels
    of one row (``blocks`` of them), tiles of ``tile`` steps (2 KB of an
    operand), ``warps`` warps a block and a ring ``ahead`` tiles ahead. A
    grid of at least two blocks for each of ``n_sm`` SMs takes 4 warps and
    2 tiles ahead (at B 8, W 2560: 640 blocks, one wave of up to 5 an SM);
    a smaller one, such as a one-row refill, 16 warps and 3 tiles ahead,
    so that each of its few blocks computes gates with more threads and
    keeps more bytes in flight. At W 2560 the switch falls between B 3
    and B 4, where the two plans cross: timed at B 1, 2, 3, 4, 6 and 8
    under both with ``scripts/time_rglru_plans.py``, the plan chosen was
    the faster on an H100 at every B. ``route`` is ``"cp.async"``
    (16-byte copies and stores) where a row's pitch is a multiple of 16
    bytes and the operands are 16-byte ``aligned``, else ``"element"``
    (element loads into the same ring, element stores)."""
    elt = 4 if dtype == torch.float32 else 2
    tile = 64 // elt
    blocks = B * -(-W // CB)
    warps, ahead = (4, 2) if blocks >= 2 * n_sm else (16, 3)
    route = "cp.async" if aligned and W * elt % 16 == 0 else "element"
    return dict(cb=CB, tile=tile, warps=warps, ahead=ahead, blocks=blocks,
                route=route)


def gates(x, r_gate, i_gate, a_param, c: float = 8.0):
    """The gates of ``h = a_t h + u_t``, f32 and of x's shape: they do not
    depend on h. Shared by the plain version and ``ops.rglru_step``."""
    log_a = -c * F.softplus(-a_param.float())
    a = torch.exp(torch.sigmoid(r_gate.float()) * log_a)
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) \
        * (torch.sigmoid(i_gate.float()) * x.float())
    return a, u


def rglru_torch(x, r_gate, i_gate, a_param, h0=None, c: float = 8.0):
    """Plain version in the kernel's order: the gates of every step first
    (they do not depend on h), then the chain ``h = a_t h + u_t`` one
    vectorised step per time step. Shapes as :func:`rglru`."""
    B, S, W = x.shape
    a, u = gates(x, r_gate, i_gate, a_param, c)                # (B, S, W)
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().expand(B, W)
    hs = []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), h


def _launch(x, r_gate, i_gate, a_param, h0, c):
    global launches, last_plan
    B, S, W = x.shape
    if r_gate.shape != x.shape or i_gate.shape != x.shape or \
            a_param.shape != (W,) or \
            (h0 is not None and h0.shape not in ((W,), (B, W))):
        raise ValueError(
            f"rglru: x {tuple(x.shape)}, r_gate {tuple(r_gate.shape)}, "
            f"i_gate {tuple(i_gate.shape)}, a_param {tuple(a_param.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} do not match")
    ins = [x, r_gate, i_gate, a_param] + ([] if h0 is None else [h0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError(
            "rglru: the CUDA kernel has no backward; training through the "
            "recurrence is not ported (ROADMAP: ssm training, a backward "
            "for selective_scan and rglru)")
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(B, W)
    ts = {"x": x, "r_gate": r_gate, "i_gate": i_gate, "a_param": a_param}
    if h0 is not None:
        ts["h0"] = h0
    code = _build.checked_args("rglru_scan", ts, x.dtype,
                               f32=("a_param", "h0"), strided=("h0",))
    h0_sb = 0
    if h0 is not None:
        h0_sb = h0.stride(0)
        if h0_sb not in (0, W) and B > 1:
            raise ValueError(f"rglru: h0 {tuple(h0.shape)} with strides "
                             f"{h0.stride()} must be W-contiguous per row")
    lib = _build.bind("rglru_scan", _ARGS)
    hs = torch.empty_like(x)
    hT = torch.empty((B, W), dtype=torch.float32, device=x.device)
    p = plan(B, W, x.dtype, _build.sm_count(x), aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, r_gate, i_gate, hs)))
    err = lib.rglru_scan_launch(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), B, S, W, h0_sb, float(c), p["warps"],
        p["ahead"], int(p["route"] == "cp.async"), code, _build.stream(x))
    _build.check(lib, "rglru_scan", err)
    launches += 1
    last_plan = p
    return hs, hT


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
          c: float = 8.0, backend: Optional[str] = None):
    """x, r_gate, i_gate: (B, S, W); a_param: (W,) f32; h0: None, (B, W)
    or (W,), f32. Returns (h_seq (B, S, W) in x.dtype, h_final (B, W)
    f32)."""
    if backend == "torch" or (backend is None and x.device.type == "cpu"):
        return rglru_torch(x, r_gate, i_gate, a_param, h0, c)
    if backend not in (None, "cuda"):
        raise ValueError(f"rglru: unknown backend {backend!r}")
    return _launch(x, r_gate, i_gate, a_param, h0, c)
