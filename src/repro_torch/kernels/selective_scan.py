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

The TPU kernel has no backward: the reference differentiates the scan
through XLA (``repro/kernels/ops.py::_selective_scan_assoc``). Here the
scan's VJP is a kernel of its own (``csrc/selective_scan_bwd.cu``) with
its plain version :func:`selective_scan_bwd_torch`, which follows the
kernel's order: the chunks of ``CHUNK`` steps in reverse, each
recomputing its states from its checkpoint (the state before the chunk)
before the reverse recurrence. The checkpoints come from the forward:
given a ``ck`` buffer, both forwards store the state before every chunk
into it. :class:`_SelectiveScan` ties the two directions together for
autograd and keeps the forward's checkpoints for the backward.

``selective_scan`` launches the kernels for CUDA tensors and takes the
plain versions only for CPU tensors or when the caller passes
``backend="torch"``. ``launches`` and ``bwd_launches`` count kernel
launches, nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

launches = 0
bwd_launches = 0

NMAX = 16                  # largest state width the kernel takes
CHUNK = 16                 # steps between the backward's checkpoints
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = [_P] * 10 + [_I] * 4 + [_L] * 3 + [_I, _P]
_BWD_ARGS = [_P] * 16 + [_I] * 4 + [_L] * 2 + [_I, _P]


def _step(h, xt, dtt, Af, bt):
    """One step of the recurrence, f32: ``h exp(dt A) + (dt x) B``."""
    dA = torch.exp(dtt[..., None] * Af)
    return h * dA + (dtt * xt)[..., None] * bt[:, None, :]


def checkpoints(x, A) -> torch.Tensor:
    """An empty checkpoint buffer for a forward on ``x``: (B, ceil(S /
    CHUNK), N, Di) f32, the state before every ``CHUNK`` steps."""
    Bb, S, Di = x.shape
    return torch.empty((Bb, -(-S // CHUNK), A.shape[-1], Di),
                       dtype=torch.float32, device=x.device)


def selective_scan_torch(x, dt, A, Bm, C, D, h0=None, *, ck=None):
    """Plain version: the kernel's step order, one vectorised step per
    time step. Shapes as :func:`selective_scan`; ``ck``, a
    :func:`checkpoints` buffer or None, receives the state before every
    ``CHUNK`` steps."""
    Bb, S, Di = x.shape
    Af, Df = A.float(), D.float()
    h = torch.zeros((Bb, Di, A.shape[-1]), dtype=torch.float32,
                    device=x.device) if h0 is None else \
        h0.float().expand(Bb, Di, A.shape[-1])
    ys = []
    for t in range(S):
        if ck is not None and t % CHUNK == 0:
            ck[:, t // CHUNK] = h.transpose(1, 2)
        xt = x[:, t].float()
        h = _step(h, xt, dt[:, t].float(), Af, Bm[:, t].float())
        ys.append((h * C[:, t].float()[:, None, :]).sum(-1) + Df * xt)
    return torch.stack(ys, 1).to(x.dtype), h


def selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dhT=None, *,
                             need_A: bool = True, need_D: bool = True,
                             ck=None):
    """Plain VJP of :func:`selective_scan_torch` in the kernel's order:
    chunk by chunk in reverse, the chunk's states recomputed from its
    checkpoint (``ck``, the forward's :func:`checkpoints`; without it the
    forward's steps are rerun from h0 to make them, the same bits), then
    the reverse recurrence with ``g`` (dL/dh, ``dhT`` at the end): ``g +=
    dy C``, ``σ = Σ_n g B``, ``dB = Σ_d g dt x``, ``dC = Σ_d dy h``, ``g
    *= dA``, ``dx = D dy + dt σ``, ``ddt = Σ_n A g h_prev + x σ``, ``dA +=
    dt g h_prev``, ``dD += dy x``. Shapes as :func:`selective_scan`; dy
    (B, S, Di), dhT (B, Di, N) f32 or None. Returns (dx, ddt in x's dtype,
    dA (Di, N) f32 or None, dB, dC (B, S, N) in B's dtype, dD (Di,) f32
    or None, dh0 (B, Di, N) f32)."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    Af, Df = A.float(), D.float()
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, Bm, C, dy))
    if ck is None:
        ck = checkpoints(x, A)
        selective_scan_torch(x, dt, A, Bm, C, D, h0, ck=ck)
    cks = [ck[:, k].transpose(1, 2) for k in range(ck.shape[1])]
    g = torch.zeros((Bb, Di, N), **f32) if dhT is None else \
        dhT.float().expand(Bb, Di, N)
    dx, ddt = torch.empty((Bb, S, Di), **f32), torch.empty((Bb, S, Di), **f32)
    dB, dC = torch.empty((Bb, S, N), **f32), torch.empty((Bb, S, N), **f32)
    dA = torch.zeros((Di, N), **f32) if need_A else None
    dD = torch.zeros((Di,), **f32) if need_D else None
    for k in reversed(range(len(cks))):
        t0, t1 = k * CHUNK, min(S, (k + 1) * CHUNK)
        hs = [cks[k]]
        for t in range(t0, t1):
            hs.append(_step(hs[-1], xf[:, t], dtf[:, t], Af, Bf[:, t]))
        for t in reversed(range(t0, t1)):
            hp, ht = hs[t - t0], hs[t - t0 + 1]
            xt, dtt, dyt, bt = xf[:, t], dtf[:, t], dyf[:, t], Bf[:, t]
            e = torch.exp(dtt[..., None] * Af)
            g = g + dyt[..., None] * Cf[:, t, None, :]
            sx = (g * bt[:, None, :]).sum(-1)
            dB[:, t] = (g * (dtt * xt)[..., None]).sum(1)
            dC[:, t] = (dyt[..., None] * ht).sum(1)
            g = g * e
            gh = g * hp
            dx[:, t] = Df * dyt + dtt * sx
            ddt[:, t] = (Af * gh).sum(-1) + xt * sx
            if need_A:
                dA += (dtt[..., None] * gh).sum(0)
            if need_D:
                dD += (dyt * xt).sum(0)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bm.dtype),
            dC.to(C.dtype), dD, g)


def _checked(name, x, dt, A, Bm, C, D, h0, extra=None):
    """Validate a launch's operands (and ``extra``, tensors in x's dtype
    or, by name, f32); returns the csrc dtype code, h0 as (B, Di, N) or
    None, and h0's batch stride."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    if dt.shape != x.shape or A.shape != (Di, N) or D.shape != (Di,) or \
            Bm.shape != (Bb, S, N) or C.shape != Bm.shape or \
            (h0 is not None and h0.shape[-2:] != (Di, N)):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(C.shape)}, D "
            f"{tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} do not match")
    if not 1 <= N <= NMAX:
        raise ValueError(f"{name}: the kernel takes a state width "
                         f"of 1..{NMAX}, not {N}")
    ts = {"x": x, "dt": dt, "A": A, "D": D, "B": Bm, "C": C}
    if h0 is not None:
        ts["h0"] = h0
    ts.update(extra or {})
    code = _build.checked_args(name, ts, x.dtype,
                               f32=("A", "D", "h0", "dhT", "ck"),
                               strided=("B", "C", "h0"))
    if Bm.stride() != C.stride():
        raise ValueError(f"{name}: B {Bm.stride()} and C "
                         f"{C.stride()} must share their strides")
    h0_sb = 0
    if h0 is not None:
        if h0.dim() == 2:
            h0 = h0.expand(Bb, Di, N)
        if h0.dim() != 3 or h0.stride(1) != N or \
                h0.stride(0) not in (0, Di * N) and Bb > 1:
            raise ValueError(
                f"{name}: h0 {tuple(h0.shape)} with strides "
                f"{h0.stride()} must be (Di, N)-contiguous per row")
        h0_sb = h0.stride(0)
    return code, h0, h0_sb


def _launch(x, dt, A, Bm, C, D, h0, *, ck=None):
    global launches
    Bb, S, Di = x.shape
    N = A.shape[-1]
    code, h0, h0_sb = _checked("selective_scan", x, dt, A, Bm, C, D, h0,
                               None if ck is None else {"ck": ck})
    if ck is not None and ck.shape != (Bb, -(-S // CHUNK), N, Di):
        raise ValueError(f"selective_scan: ck {tuple(ck.shape)} is not "
                         f"{(Bb, -(-S // CHUNK), N, Di)}")
    lib = _build.bind("selective_scan", _ARGS)
    y = torch.empty_like(x)
    hT = torch.empty((Bb, Di, N), dtype=torch.float32, device=x.device)
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        C.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), hT.data_ptr(), None if ck is None else ck.data_ptr(),
        Bb, S, Di, N, Bm.stride(0), Bm.stride(1), h0_sb, code,
        _build.stream(x))
    _build.check(lib, "selective_scan", err)
    launches += 1
    return y, hT


def _launch_bwd(x, dt, A, Bm, C, D, h0, dy, dhT=None, *, need_A=True,
                need_D=True, h_final_out=None, ck=None):
    """The backward kernel; arguments and results as
    :func:`selective_scan_bwd_torch`. ``ck`` is the forward kernel's
    checkpoint buffer (:func:`checkpoints`, as autograd keeps it); a
    caller that has none (a test, ``chip_smoke.py``) gets one from a
    launch of the forward kernel here, counted in ``launches``. dB and dC
    come from per-block partials (each block's 32 channels) summed here
    over the blocks, and dA and dD from per-row partials summed over the
    rows: torch sums in a fixed order, so a second call gives the same
    bits. ``h_final_out``, a (B, Di, N) f32 tensor, receives the state the
    kernel's recompute of the last chunk ends in (the forward kernel's
    ``h_final``, bit for bit)."""
    global bwd_launches
    Bb, S, Di = x.shape
    N = A.shape[-1]
    if ck is None:
        ck = checkpoints(x, A)
        _launch(x, dt, A, Bm, C, D, h0, ck=ck)
    extra = {"dy": dy, "ck": ck}
    if dhT is not None:
        extra["dhT"] = dhT
    if dy.shape != x.shape or (dhT is not None and dhT.shape != (Bb, Di, N)):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)}, dhT "
                         f"{None if dhT is None else tuple(dhT.shape)} do "
                         f"not match x {tuple(x.shape)}")
    code, _, _ = _checked("selective_scan_bwd", x, dt, A, Bm, C, D, h0,
                          extra)
    if ck.shape != (Bb, -(-S // CHUNK), N, Di):
        raise ValueError(f"selective_scan_bwd: ck {tuple(ck.shape)} is not "
                         f"{(Bb, -(-S // CHUNK), N, Di)}")
    if h_final_out is not None and (
            h_final_out.shape != (Bb, Di, N) or not h_final_out.is_cuda or
            h_final_out.dtype != torch.float32 or
            not h_final_out.is_contiguous()):
        raise ValueError("selective_scan_bwd: h_final_out must be a "
                         "contiguous (B, Di, N) f32 CUDA tensor")
    lib = _build.bind("selective_scan_bwd", _BWD_ARGS)
    f32 = dict(dtype=torch.float32, device=x.device)
    nblk = -(-Di // 32)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbc = torch.empty((Bb, nblk, S, 2, N), **f32)
    dA = torch.empty((Bb, Di, N), **f32) if need_A else None
    dD = torch.empty((Bb, Di), **f32) if need_D else None
    dh0 = torch.empty((Bb, Di, N), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        C.data_ptr(), D.data_ptr(), ck.data_ptr(), dy.data_ptr(), ptr(dhT),
        dx.data_ptr(), ddt.data_ptr(), dbc.data_ptr(), ptr(dA), ptr(dD),
        dh0.data_ptr(), ptr(h_final_out), Bb, S, Di, N, Bm.stride(0),
        Bm.stride(1), code, _build.stream(x))
    _build.check(lib, "selective_scan_bwd", err)
    bwd_launches += 1
    bc = dbc.sum(1)
    return (dx, ddt, None if dA is None else dA.sum(0),
            bc[:, :, 0].to(Bm.dtype), bc[:, :, 1].to(C.dtype),
            None if dD is None else dD.sum(0), dh0)


class _SelectiveScan(torch.autograd.Function):
    """The scan for autograd: the forward kernel and the backward kernel
    (``impl`` "cuda"), or the plain versions of both ("torch"). The
    forward stores its checkpoints, which the backward starts from."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, D, h0, impl):
        ck = checkpoints(x, A)
        ctx.save_for_backward(x, dt, A, Bm, C, D, h0, ck)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        fwd = selective_scan_torch if impl == "torch" else _launch
        return fwd(x, dt, A, Bm, C, D, h0, ck=ck)

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, Bm, C, D, h0, ck = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dhT is not None:
            dhT = dhT.contiguous()
        bwd = selective_scan_bwd_torch if ctx.impl == "torch" \
            else _launch_bwd
        grads = bwd(x, dt, A, Bm, C, D, h0, dy, dhT, need_A=need[2],
                    need_D=need[5], ck=ck)
        return tuple(g if n else None for g, n in zip(grads, need)) + \
            (None,)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   backend: Optional[str] = None):
    """x, dt: (B, S, Di); A: (Di, N) f32; Bm, C: (B, S, N); D: (Di,) f32;
    h0: None, (B, Di, N) or (Di, N), f32. Returns (y (B, S, Di) in
    x.dtype, h_final (B, Di, N) f32). Differentiable in every tensor
    argument; a (Di, N) h0 gets the sum of its rows' gradients."""
    if backend not in (None, "cuda", "torch"):
        raise ValueError(f"selective_scan: unknown backend {backend!r}")
    impl = "torch" if backend == "torch" or (
        backend is None and x.device.type == "cpu") else "cuda"
    if h0 is not None and h0.dim() == 2:
        h0 = h0.expand(x.shape[0], *h0.shape)
    ins = (x, dt, A, Bm, C, D, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        return _SelectiveScan.apply(*ins, impl)
    fwd = selective_scan_torch if impl == "torch" else _launch
    return fwd(*ins)
