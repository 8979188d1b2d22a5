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

The TPU kernel has no backward: the reference differentiates the
recurrence through XLA (``repro/kernels/ops.py::_rglru_assoc``). Here its
VJP is a kernel of its own (``csrc/rglru_scan_bwd.cu``, its block shape
from :func:`bwd_plan`) with its plain version :func:`rglru_bwd_torch`,
which follows the kernel's order: the gates once, then the chunks of
``CHUNK`` steps in reverse, each recomputing its states from its
checkpoint (the state before the chunk) beside the reverse chain of the
gradient, then the elementwise gradients. The checkpoints come from the
forward: given a ``ck`` buffer, both forwards store the state before
every chunk into it. :class:`_RGLRU` ties the two directions together for
autograd and keeps the forward's checkpoints for the backward. At a saturated gate (``r_gate = -1e9``, a ragged row's padding)
the gradients of ``r_gate`` and ``a_param`` are not finite, in both
versions as in the reference (``sqrt(1 - a_t²)`` has an infinite slope at
``a_t = 1``); no training batch is ragged.

``rglru`` launches the kernels for CUDA tensors and takes the plain
versions only for CPU tensors or when the caller passes
``backend="torch"``. ``launches`` and ``bwd_launches`` count kernel
launches, nothing else; ``last_plan`` and ``last_bwd_plan`` are the
plans the last forward and backward launches ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

launches = 0
bwd_launches = 0
last_plan: Optional[dict] = None
last_bwd_plan: Optional[dict] = None

CB = 32                    # channels a block of the kernel
CHUNK = 32                 # steps between the backward's checkpoints
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGS = [_P] * 8 + [_I] * 3 + [_L, _F] + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 13 + [_I] * 3 + [_F] + [_I] * 4 + [_P]


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


def bwd_plan(B: int, W: int, dtype: torch.dtype = torch.bfloat16,
             aligned: bool = True) -> dict:
    """How ``csrc/rglru_scan_bwd.cu`` runs a call: blocks of ``cb``
    channels of one row (``blocks`` of them), chunks of ``chunk`` steps
    walked in reverse, ``warps`` warps a block (two of them run the two
    chains while the others wait; all compute the gates and the
    elementwise gradients) and a ring ``ahead`` chunks ahead. One plan:
    at the HFSL round's call (B 4, W 2560: 320 blocks) its 56 KB of
    shared memory in bf16 let all blocks of the grid be resident at
    once. ``route`` as in :func:`plan`."""
    elt = 4 if dtype == torch.float32 else 2
    route = "cp.async" if aligned and W * elt % 16 == 0 else "element"
    return dict(cb=CB, chunk=CHUNK, warps=8, ahead=3,
                blocks=B * -(-W // CB), route=route)


def checkpoints(x) -> torch.Tensor:
    """An empty checkpoint buffer for a forward on ``x``: (B, ceil(S /
    CHUNK), W) f32, the state before every ``CHUNK`` steps."""
    B, S, W = x.shape
    return torch.empty((B, -(-S // CHUNK), W), dtype=torch.float32,
                       device=x.device)


def gates(x, r_gate, i_gate, a_param, c: float = 8.0):
    """The gates of ``h = a_t h + u_t``, f32 and of x's shape: they do not
    depend on h. Shared by the plain version and ``ops.rglru_step``."""
    log_a = -c * F.softplus(-a_param.float())
    a = torch.exp(torch.sigmoid(r_gate.float()) * log_a)
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) \
        * (torch.sigmoid(i_gate.float()) * x.float())
    return a, u


def rglru_torch(x, r_gate, i_gate, a_param, h0=None, c: float = 8.0, *,
                ck=None):
    """Plain version in the kernel's order: the gates of every step first
    (they do not depend on h), then the chain ``h = a_t h + u_t`` one
    vectorised step per time step. Shapes as :func:`rglru`; ``ck``, a
    :func:`checkpoints` buffer or None, receives the state before every
    ``CHUNK`` steps."""
    B, S, W = x.shape
    a, u = gates(x, r_gate, i_gate, a_param, c)                # (B, S, W)
    h = torch.zeros((B, W), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float().expand(B, W)
    hs = []
    for t in range(S):
        if ck is not None and t % CHUNK == 0:
            ck[:, t // CHUNK] = h
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), h


def rglru_bwd_torch(x, r_gate, i_gate, a_param, h0, dhs, dhT=None,
                    c: float = 8.0, *, need_a: bool = True, ck=None):
    """Plain VJP of :func:`rglru_torch` in the kernel's order: the gates
    (:func:`gates`), then, chunk by chunk in reverse, the chunk's states
    recomputed from its checkpoint (``ck``, the forward's
    :func:`checkpoints`; without it the chain is rerun from h0 to make
    them, the same bits) and the reverse recurrence with ``g`` (dL/dh,
    ``dhT`` at the end): ``g += dhs``, ``dx = g s σ(i)``, ``di = g s x
    σ'(i)``, ``∂a = g h_prev - g σ(i) x a / s``, ``dr = ∂a a log_a
    σ'(r)``, ``da_param += ∂a a σ(r) c σ(-a_param)``, ``g *= a``. Shapes
    as :func:`rglru`; dhs (B, S, W), dhT (B, W) f32 or None. Returns (dx,
    dr, di in x's dtype, da_param (W,) f32 or None, dh0 (B, W) f32)."""
    B, S, W = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    a, u = gates(x, r_gate, i_gate, a_param, c)
    p = a_param.float()
    log_a = -c * F.softplus(-p)
    sr, si = torch.sigmoid(r_gate.float()), torch.sigmoid(i_gate.float())
    xf, dhf = x.float(), dhs.float()
    v = 1.0 - a * a
    s = torch.sqrt(torch.clamp(v, min=0.0))
    dsda = torch.where(v >= 0, -a / s, torch.zeros((), **f32))
    if ck is None:
        ck = checkpoints(x)
        rglru_torch(x, r_gate, i_gate, a_param, h0, c, ck=ck)
    cks = list(ck.unbind(1))
    g = torch.zeros((B, W), **f32) if dhT is None else \
        dhT.float().expand(B, W)
    dx, dr, di = (torch.empty((B, S, W), **f32) for _ in range(3))
    dp = torch.zeros((W,), **f32) if need_a else None
    for k in reversed(range(len(cks))):
        t0, t1 = k * CHUNK, min(S, (k + 1) * CHUNK)
        hs = [cks[k]]
        for t in range(t0, t1):
            hs.append(a[:, t] * hs[-1] + u[:, t])
        for t in reversed(range(t0, t1)):
            g = g + dhf[:, t]
            gs = g * s[:, t]
            da = g * hs[t - t0] + g * (si[:, t] * xf[:, t]) * dsda[:, t]
            dx[:, t] = gs * si[:, t]
            di[:, t] = gs * xf[:, t] * (si[:, t] * (1 - si[:, t]))
            dr[:, t] = da * a[:, t] * log_a * (sr[:, t] * (1 - sr[:, t]))
            if need_a:
                dp += (da * a[:, t] * sr[:, t]).sum(0)
            g = g * a[:, t]
    da_param = dp * c * torch.sigmoid(-p) if need_a else None
    return (dx.to(x.dtype), dr.to(r_gate.dtype), di.to(i_gate.dtype),
            da_param, g)


def _checked(name, x, r_gate, i_gate, a_param, h0, extra=None):
    """Validate a launch's operands (and ``extra``, tensors in x's dtype
    or, by name, f32); returns the csrc dtype code, h0 as (B, W) or None,
    and h0's batch stride."""
    B, S, W = x.shape
    if r_gate.shape != x.shape or i_gate.shape != x.shape or \
            a_param.shape != (W,) or \
            (h0 is not None and h0.shape not in ((W,), (B, W))):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, r_gate {tuple(r_gate.shape)}, "
            f"i_gate {tuple(i_gate.shape)}, a_param {tuple(a_param.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} do not match")
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(B, W)
    ts = {"x": x, "r_gate": r_gate, "i_gate": i_gate, "a_param": a_param}
    if h0 is not None:
        ts["h0"] = h0
    ts.update(extra or {})
    code = _build.checked_args(name, ts, x.dtype,
                               f32=("a_param", "h0", "dhT", "ck"),
                               strided=("h0",))
    h0_sb = 0
    if h0 is not None:
        h0_sb = h0.stride(0)
        if h0_sb not in (0, W) and B > 1:
            raise ValueError(f"{name}: h0 {tuple(h0.shape)} with strides "
                             f"{h0.stride()} must be W-contiguous per row")
    return code, h0, h0_sb


def _launch(x, r_gate, i_gate, a_param, h0, c, *, ck=None):
    global launches, last_plan
    B, S, W = x.shape
    code, h0, h0_sb = _checked("rglru", x, r_gate, i_gate, a_param, h0,
                               None if ck is None else {"ck": ck})
    if ck is not None and ck.shape != (B, -(-S // CHUNK), W):
        raise ValueError(f"rglru: ck {tuple(ck.shape)} is not "
                         f"{(B, -(-S // CHUNK), W)}")
    lib = _build.bind("rglru_scan", _ARGS)
    hs = torch.empty_like(x)
    hT = torch.empty((B, W), dtype=torch.float32, device=x.device)
    p = plan(B, W, x.dtype, _build.sm_count(x), aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, r_gate, i_gate, hs)))
    err = lib.rglru_scan_launch(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        a_param.data_ptr(), None if h0 is None else h0.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), None if ck is None else ck.data_ptr(),
        B, S, W, h0_sb, float(c), p["warps"],
        p["ahead"], int(p["route"] == "cp.async"), code, _build.stream(x))
    _build.check(lib, "rglru_scan", err)
    launches += 1
    last_plan = p
    return hs, hT


def _launch_bwd(x, r_gate, i_gate, a_param, h0, dhs, dhT=None,
                c: float = 8.0, *, need_a: bool = True, h_final_out=None,
                ck=None):
    """The backward kernel; arguments and results as
    :func:`rglru_bwd_torch`. ``ck`` is the forward kernel's checkpoint
    buffer (:func:`checkpoints`, as autograd keeps it); a caller that has
    none (a test, ``chip_smoke.py``) gets one from a launch of the forward
    kernel here, counted in ``launches``. a_param's gradient comes from
    per-row partials summed here over the rows (a fixed order: a second
    call gives the same bits). ``h_final_out``, a (B, W) f32 tensor,
    receives the state the kernel's recompute of the last chunk ends in
    (the forward kernel's ``h_final``, bit for bit)."""
    global bwd_launches, last_bwd_plan
    B, S, W = x.shape
    if ck is None:
        ck = checkpoints(x)
        _launch(x, r_gate, i_gate, a_param, h0, c, ck=ck)
    extra = {"dhs": dhs, "ck": ck}
    if dhT is not None:
        extra["dhT"] = dhT
    if dhs.shape != x.shape or (dhT is not None and dhT.shape != (B, W)):
        raise ValueError(f"rglru_bwd: dhs {tuple(dhs.shape)}, dhT "
                         f"{None if dhT is None else tuple(dhT.shape)} do "
                         f"not match x {tuple(x.shape)}")
    code, _, _ = _checked("rglru_bwd", x, r_gate, i_gate, a_param, h0,
                          extra)
    if ck.shape != (B, -(-S // CHUNK), W):
        raise ValueError(f"rglru_bwd: ck {tuple(ck.shape)} is not "
                         f"{(B, -(-S // CHUNK), W)}")
    if h_final_out is not None and (
            h_final_out.shape != (B, W) or not h_final_out.is_cuda or
            h_final_out.dtype != torch.float32 or
            not h_final_out.is_contiguous()):
        raise ValueError("rglru_bwd: h_final_out must be a contiguous "
                         "(B, W) f32 CUDA tensor")
    lib = _build.bind("rglru_scan_bwd", _BWD_ARGS)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    da = torch.empty((B, W), **f32) if need_a else None
    dh0 = torch.empty((B, W), **f32)
    p = bwd_plan(B, W, x.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, r_gate, i_gate, dhs, dx, dr,
                                         di)))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.rglru_scan_bwd_launch(
        x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
        a_param.data_ptr(), ck.data_ptr(), dhs.data_ptr(), ptr(dhT),
        dx.data_ptr(), dr.data_ptr(), di.data_ptr(), ptr(da),
        dh0.data_ptr(), ptr(h_final_out), B, S, W, float(c), p["warps"],
        p["ahead"], int(p["route"] == "cp.async"), code, _build.stream(x))
    _build.check(lib, "rglru_scan_bwd", err)
    bwd_launches += 1
    last_bwd_plan = p
    return dx, dr, di, None if da is None else da.sum(0), dh0


class _RGLRU(torch.autograd.Function):
    """The recurrence for autograd: the forward kernel and the backward
    kernel (``impl`` "cuda"), or the plain versions of both ("torch").
    The forward stores its checkpoints, which the backward starts from."""

    @staticmethod
    def forward(ctx, x, r_gate, i_gate, a_param, h0, c, impl):
        ck = checkpoints(x)
        ctx.save_for_backward(x, r_gate, i_gate, a_param, h0, ck)
        ctx.c, ctx.impl = c, impl
        ctx.set_materialize_grads(False)
        fwd = rglru_torch if impl == "torch" else _launch
        return fwd(x, r_gate, i_gate, a_param, h0, c, ck=ck)

    @staticmethod
    def backward(ctx, dhs, dhT):
        x, r_gate, i_gate, a_param, h0, ck = ctx.saved_tensors
        need = ctx.needs_input_grad
        dhs = torch.zeros_like(x) if dhs is None else dhs.contiguous()
        if dhT is not None:
            dhT = dhT.contiguous()
        bwd = rglru_bwd_torch if ctx.impl == "torch" else _launch_bwd
        grads = bwd(x, r_gate, i_gate, a_param, h0, dhs, dhT, ctx.c,
                    need_a=need[3], ck=ck)
        return tuple(g if n else None for g, n in zip(grads, need)) + \
            (None, None)


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          a_param: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
          c: float = 8.0, backend: Optional[str] = None):
    """x, r_gate, i_gate: (B, S, W); a_param: (W,) f32; h0: None, (B, W)
    or (W,), f32. Returns (h_seq (B, S, W) in x.dtype, h_final (B, W)
    f32). Differentiable in every tensor argument; a (W,) h0 gets the sum
    of its rows' gradients."""
    if backend not in (None, "cuda", "torch"):
        raise ValueError(f"rglru: unknown backend {backend!r}")
    impl = "torch" if backend == "torch" or (
        backend is None and x.device.type == "cpu") else "cuda"
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(x.shape[0], -1)
    ins = (x, r_gate, i_gate, a_param, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        return _RGLRU.apply(*ins, float(c), impl)
    fwd = rglru_torch if impl == "torch" else _launch
    return fwd(*ins, c)
