"""The selective-scan backward kernel (``csrc/selective_scan_bwd.cu``) on
the CPU: its arithmetic emulated in torch, and the checkpoints it starts
from.

A CUDA kernel has no CPU mode, so :func:`emulate_bwd` repeats what the
kernel computes: blocks of 32 channels (zero past Di), a channel's states
over four warps of NPL each (NM = N for N 16 and 8, else 16 with the
states past N zero), chunks of 16 steps in reverse (zero past S), each
chunk's states recomputed from the checkpoint the forward stored (the
forward kernel's step: 2^(dt (A log2 e)) and one fused multiply-add,
:func:`emulate_ck`), then the reverse step per state ``g += dy C``, a
warp's ``Σ g B`` and ``Σ A (g e) h_prev`` over its states in rising n
(fused multiply-adds), ``g *= e``; dx and ddt from the four warps'
partials added as ((p0 + p1) + (p2 + p3)); dB and dC summed over a
block's 32 lanes in the butterfly's order (lanes 16, 8, 4, 2, 1 apart)
into per-block partials that are summed over the blocks; dA and dD per
row, summed over the rows. A fused multiply-add is taken in f64 and
rounded once (ex2.approx's and the fused operations' last bits aside).

It is held against ``jax.vjp`` of the reference's scan (the XLA step
loop; no TPU kernel has a backward) within the scans' 1e-3 of each
output's largest value (outputs in bf16: 2e-2), at widths that are not
multiples of 32, lengths across a chunk and no, per-row and shared
initial states. The plain backward's checkpoints are checked too: the
plain forward stores the states its steps reach, and the plain backward
gives the same bits from them as from its own rerun. Inputs are made
from a seed with numpy and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import selective_scan as ss

LPC, CB, TS = 4, 32, 16            # warps a channel, lanes, chunk steps
LOG2E = 1.4426950408889634
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def fma(a, b, c):
    """a b + c rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def lane_states(N):
    """(NM, NPL): the kernel's state slots and slots a warp."""
    nm = N if N in (8, 16) else ss.NMAX
    return nm, nm // LPC


def butterfly(v):
    """The sum over the last axis (32 lanes) in the order of the kernel's
    transposing butterfly: lanes 16, then 8, 4, 2, 1 apart."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def emulate_ck(x, dt, A, Bm, h0=None):
    """The forward kernel's checkpoints (B, ceil(S / 16), N, Di) and final
    state: the state before every 16 steps."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    a2 = A.float() * LOG2E
    h = torch.zeros(Bb, Di, N) if h0 is None else \
        h0.float().expand(Bb, Di, N).clone()
    ck = torch.empty(Bb, -(-S // TS), N, Di)
    for t in range(S):
        if t % TS == 0:
            ck[:, t // TS] = h.transpose(1, 2)
        dv = dt[:, t].float()
        dtx = dv * x[:, t].float()
        e = torch.exp2(dv[..., None] * a2)
        h = fma(h, e, dtx[..., None] * Bm[:, t].float()[:, None, :])
    return ck, h


def emulate_bwd(x, dt, A, Bm, C, D, ck, dy, dhT=None):
    """The kernel's (dx, ddt, dA, dB, dC, dD, dh0), as
    ``selective_scan_bwd_torch`` returns them."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    nm, npl = lane_states(N)
    nblk, nck = -(-Di // CB), -(-S // TS)
    Dp, Sp = nblk * CB, nck * TS

    def pad(t, *sizes):                  # zero-fill to the given sizes
        out = torch.zeros(*sizes)
        out[tuple(slice(0, n) for n in t.shape)] = t.float()
        return out

    xf, dtf, dyf = (pad(t, Bb, Sp, Dp) for t in (x, dt, dy))
    bf, cf = pad(Bm, Bb, Sp, nm), pad(C, Bb, Sp, nm)
    af = pad(A, Dp, nm)
    a2 = af * LOG2E
    d = pad(D, Dp)
    g = torch.zeros(Bb, Dp, nm) if dhT is None else pad(dhT, Bb, Dp, nm)
    dx, ddt = torch.zeros(Bb, Sp, Dp), torch.zeros(Bb, Sp, Dp)
    dbc = torch.zeros(Bb, nblk, Sp, 2, nm)
    dA, dD = torch.zeros(Bb, Dp, nm), torch.zeros(Bb, Dp)
    for k in reversed(range(nck)):
        hk = pad(ck[:, k].transpose(1, 2), Bb, Dp, nm)
        hs, h = [], hk
        for tt in range(TS):
            t = k * TS + tt
            dv = dtf[:, t]
            e = torch.exp2(dv[..., None] * a2)
            h = fma(h, e, (dv * xf[:, t])[..., None] * bf[:, t, None, :])
            hs.append(h)
        for tt in reversed(range(TS)):
            t = k * TS + tt
            xv, dv, gy = xf[:, t], dtf[:, t], dyf[:, t]
            bt, ct = bf[:, t, None, :], cf[:, t, None, :]
            dtx = dv * xv
            hp = hs[tt - 1] if tt else hk
            g = fma(gy[..., None], ct, g)
            vb, vc = g * dtx[..., None], gy[..., None] * hs[tt]
            px = torch.zeros(Bb, Dp, LPC)
            for j in range(npl):
                sl = slice(j, nm, npl)       # state q NPL + j of warp q
                px = fma(g[..., sl], bt[..., sl], px)
            g = g * torch.exp2(dv[..., None] * a2)
            gh = g * hp
            pd = torch.zeros(Bb, Dp, LPC)
            for j in range(npl):
                sl = slice(j, nm, npl)
                pd = fma(af[:, sl], gh[..., sl], pd)
            dA = fma(dv[..., None], gh, dA)
            dD = fma(gy, xv, dD)
            sx = (px[..., 0] + px[..., 1]) + (px[..., 2] + px[..., 3])
            sd = (pd[..., 0] + pd[..., 1]) + (pd[..., 2] + pd[..., 3])
            dx[:, t] = fma(d, gy, dv * sx)
            ddt[:, t] = fma(xv, sx, sd)
            for which, v in ((0, vb), (1, vc)):
                lanes = v.reshape(Bb, nblk, CB, nm).transpose(2, 3)
                dbc[:, :, t, which] = butterfly(lanes)
    bc = dbc.sum(1)
    return (dx[:, :S, :Di].to(x.dtype), ddt[:, :S, :Di].to(dt.dtype),
            dA.sum(0)[:Di, :N], bc[:, :S, 0, :N].to(Bm.dtype),
            bc[:, :S, 1, :N].to(C.dtype), dD.sum(0)[:Di],
            g[:, :Di, :N])


def _inputs(B, S, Di, N, h0_kind, seed):
    """x, dt, A, the x_proj-shaped array holding B and C, D, h0, dy,
    dh_final as numpy f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((B, S, Di))).astype(f)
    dt = (0.1 * np.log1p(np.exp(rng.standard_normal((B, S, Di))))).astype(f)
    A = -np.exp(0.3 * rng.standard_normal((Di, N))).astype(f)
    xdbc = (0.5 * rng.standard_normal((B, S, 5 + 2 * N))).astype(f)
    D = rng.standard_normal(Di).astype(f)
    h0 = {"none": None,
          "row": (0.1 * rng.standard_normal((B, Di, N))).astype(f),
          "shared": (0.1 * rng.standard_normal((Di, N))).astype(f)}[h0_kind]
    dy = rng.standard_normal((B, S, Di)).astype(f)
    dh = rng.standard_normal((B, Di, N)).astype(f)
    return x, dt, A, xdbc, D, h0, dy, dh


def _rounded(a, dtype):
    """``a`` as the kernel sees it in ``dtype``, back in numpy f32."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _jax_grads(x, dt, A, xdbc, D, h0, dy, dh, N):
    """``jax.vjp`` of the reference's scan (XLA step loop); a shared h0 is
    broadcast over the rows inside, so its gradient is the rows' sum."""
    B, _, Di = x.shape

    def f(x, dt, A, xdbc, D, s0):
        if s0 is not None and s0.ndim == 2:
            s0 = jnp.broadcast_to(s0, (B, Di, N))
        return jops.selective_scan(x, dt, A, xdbc[..., 5:5 + N],
                                   xdbc[..., 5 + N:], D, s0, backend="xla")

    args = [jnp.asarray(a) for a in (x, dt, A, xdbc, D)]
    _, vjp = jax.vjp(f, *args, None if h0 is None else jnp.asarray(h0))
    gx, gdt, gA, gxdbc, gD, gh0 = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    gxdbc = np.asarray(gxdbc)
    return [np.asarray(gx), np.asarray(gdt), np.asarray(gA),
            gxdbc[..., 5:5 + N], gxdbc[..., 5 + N:], np.asarray(gD),
            None if gh0 is None else np.asarray(gh0)]


def _close(name, got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, tol * scale)


@pytest.mark.parametrize("B,S,Di,N,h0_kind", [
    (2, 1, 33, 16, "row"), (2, 5, 33, 16, "none"), (2, 17, 200, 16, "shared"),
    (1, 37, 40, 16, "row"), (2, 37, 33, 5, "shared"), (2, 20, 48, 8, "none")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_bwd_matches_jax_vjp(B, S, Di, N, h0_kind, dtype):
    tdt = getattr(torch, dtype)
    x, dt, A, xdbc, D, h0, dy, dh = _inputs(B, S, Di, N, h0_kind,
                                            seed=S * Di + N)
    x, dt, xdbc, dy = (_rounded(a, tdt) for a in (x, dt, xdbc, dy))
    tx, tdt_, txd, tdy = (torch.from_numpy(a).to(tdt)
                          for a in (x, dt, xdbc, dy))
    tA, tD = torch.from_numpy(A), torch.from_numpy(D)
    th0 = None if h0 is None else torch.from_numpy(h0)
    Bm, C = txd[..., 5:5 + N], txd[..., 5 + N:]
    ck, _ = emulate_ck(tx, tdt_, tA, Bm, th0)
    got = emulate_bwd(tx, tdt_, tA, Bm, C, tD, ck, tdy, torch.from_numpy(dh))
    want = _jax_grads(x, dt, A, xdbc, D, h0, dy, dh, N)
    if want[6] is not None and want[6].ndim == 2:      # a shared h0
        got = list(got)
        got[6] = got[6].sum(0)
    low = 2e-2 if dtype == "bfloat16" else 1e-3
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            continue
        low_out = name in ("dx", "ddt", "dB", "dC")
        _close(name, g, w, low if low_out else 1e-3)


def test_emulated_bwd_is_the_plain_backward_in_f32():
    """The emulation and the port's plain backward, which the card's
    tests hold the kernel to, agree in f32 within 1e-5 of each output's
    largest value (the same algorithm; fused operations and sum orders
    differ)."""
    x, dt, A, xdbc, D, h0, dy, dh = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs(3, 37, 200, 16, "row", seed=3))
    Bm, C = xdbc[..., 5:21], xdbc[..., 21:]
    ck, hT = emulate_ck(x, dt, A, Bm, h0)
    got = emulate_bwd(x, dt, A, Bm, C, D, ck, dy, dh)
    want = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dh)
    for name, g, w in zip(GRADS, got, want):
        _close(name, g, w.numpy(), 1e-5)
    _, hw = ss.selective_scan_torch(x, dt, A, Bm, C, D, h0)
    _close("h_final", hT, hw.numpy(), 1e-5)


@pytest.mark.parametrize("S,h0_kind", [(1, "none"), (16, "row"),
                                       (37, "shared")])
def test_plain_checkpoints_are_the_forward_states(S, h0_kind):
    """The plain forward's checkpoints are the states its steps reach
    before every 16th step (taken here one step at a time), the last
    chunk's steps from the last checkpoint end in h_final, and the plain
    backward gives the same bits from them as from its own rerun."""
    x, dt, A, xdbc, D, h0, dy, dh = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs(2, S, 40, 16, h0_kind, seed=S))
    Bm, C = xdbc[..., 5:21], xdbc[..., 21:]
    ck = ss.checkpoints(x, A)
    assert ck.shape == (2, -(-S // ss.CHUNK), 16, 40)
    _, hT = ss.selective_scan_torch(x, dt, A, Bm, C, D, h0, ck=ck)
    h = torch.zeros(2, 40, 16) if h0 is None else h0.expand(2, 40, 16)
    for t in range(S):
        if t % ss.CHUNK == 0:
            assert torch.equal(ck[:, t // ss.CHUNK], h.transpose(1, 2)), t
        h = ss._step(h, x[:, t], dt[:, t], A, Bm[:, t])
    assert torch.equal(h, hT)
    h = ck[:, -1].transpose(1, 2)
    for t in range((ck.shape[1] - 1) * ss.CHUNK, S):
        h = ss._step(h, x[:, t], dt[:, t], A, Bm[:, t])
    assert torch.equal(h, hT)
    if h0 is not None and h0.dim() == 2:
        h0 = h0.expand(2, 40, 16)
    rerun = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dh)
    fed = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dh, ck=ck)
    for name, a, b in zip(GRADS, rerun, fed):
        assert torch.equal(a, b), name
