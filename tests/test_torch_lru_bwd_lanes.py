"""The RG-LRU backward kernel (``csrc/rglru_scan_bwd.cu``) on the CPU: its
arithmetic emulated in torch, and the checkpoints it starts from.

A CUDA kernel has no CPU mode, so :func:`emulate_bwd` repeats what the
kernel computes, in its f32 operation order: the gates once per step
(``sigmoid(v) = rcp(1 + ex2(v (-log2 e)))``, ``a_t = ex2(sigmoid(r_t)
log_a2)``, ``s_t = sqrt(max(1 - a_t a_t, 0))``; a_t = 1 and s_t = 0 past
S), chunks of 32 steps in reverse; in each, the h chain from the chunk's
checkpoint (:func:`emulate_ck`, the forward kernel's state before every
32 steps), ``h = a_t h + u_t`` with ``u_t = s_t (sigmoid(i_t) x_t)``, a
product then a sum, and the g chain ``g += dhs_t``, then ``g *= a_t``;
then per element ``dx = (g s) σ(i)``, ``di = ((g s) x) (σ(i) (1 -
σ(i)))``, ``∂a = g h_prev + (g (σ(i) x)) ds/da`` (one fused
multiply-add), ``dr = ((∂a a) log_a) (σ(r) (1 - σ(r)))``; and a_param's
gradient in the kernel's order: each thread (one step slot of a chunk and
a vector of channels) sums ``(∂a a) σ(r)`` over the chunks by fused
multiply-adds, a channel's threads are added in rising order, the sum
times ``c σ(-a_param)`` per row, the rows summed. Each ex2, rcp and sqrt
is taken in f64 and rounded to f32 (subnormals flushed), as in
tests/test_torch_lru_lanes.py.

It is held against ``jax.vjp`` of the reference's recurrence (the XLA
step loop; no TPU kernel has a backward) within the scans' 1e-3 of each
output's largest value (outputs in bf16: 2e-2), at widths that are not
multiples of 32 (33, 200), lengths across a chunk (1, 5, 17, 37), no,
per-row and shared initial states. The plain backward's checkpoints are
checked too, and :func:`rglru_scan.bwd_plan`. Inputs are made from a
seed with numpy and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import rglru_scan as rg

F32 = torch.float32
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)   # the kernel's LOG2E
TS = 32                                               # chunk steps
GRADS = ("dx", "dr", "di", "da_param", "dh0")


def _sfu(v):
    """A special-function result: ``v`` (f64) rounded to f32, subnormals
    flushed."""
    v = v.to(F32)
    return torch.where(v.abs() < 2.0 ** -126, torch.zeros_like(v), v)


def ex2(v):
    return _sfu(torch.exp2(v.double()))


def rcp(v):
    return _sfu(1.0 / v.double())


def sqrt(v):
    return _sfu(torch.sqrt(v.double()))


def sigmoid(v):
    """The kernel's ``sigmoid_f`` on f32 ``v``."""
    return rcp(1.0 + ex2(v * -LOG2E))


def fma(a, b, c):
    """a b + c rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def softplus_neg(a_param):
    """The kernel's precise ``softplus(-a_param)`` (torch's threshold 20)."""
    v = -a_param.to(F32)
    return torch.where(v > 20, v, torch.log1p(torch.exp(v.double())).to(F32))


def gates(x, r, i, a_param, c):
    """(a_t, s_t, σ(r), σ(i)), f32, padded to whole chunks: a_t = 1 and
    s_t = 0 past S."""
    B, S, W = x.shape
    n = -(-S // TS) * TS
    la2 = torch.tensor(-c, dtype=F32) * softplus_neg(a_param) * LOG2E
    sr, si = sigmoid(r.to(F32)), sigmoid(i.to(F32))
    a = ex2(sr * la2)
    s = sqrt(torch.clamp(1.0 - a * a, min=0.0))
    pad = (0, 0, 0, n - S)
    return (torch.nn.functional.pad(a, pad, value=1.0),
            torch.nn.functional.pad(s, pad), torch.nn.functional.pad(sr, pad),
            torch.nn.functional.pad(si, pad))


def emulate_ck(x, r, i, a_param, h0=None, c=8.0):
    """The forward kernel's checkpoints (B, ceil(S / 32), W): the state
    before every 32 steps."""
    B, S, W = x.shape
    a, s, _, si = gates(x, r, i, a_param, c)
    h = torch.zeros(B, W) if h0 is None else h0.float().expand(B, W)
    ck = torch.empty(B, -(-S // TS), W)
    for t in range(S):
        if t % TS == 0:
            ck[:, t // TS] = h
        h = a[:, t] * h + s[:, t] * (si[:, t] * x[:, t].float())
    return ck


def emulate_bwd(x, r, i, a_param, ck, dhs, dhT=None, c=8.0):
    """The kernel's (dx, dr, di, da_param, dh0), as ``rglru_bwd_torch``
    returns them."""
    B, S, W = x.shape
    plan = rg.bwd_plan(B, W, x.dtype)
    vec = 16 // x.element_size()
    assert plan["warps"] * 32 >= TS * 32 // vec      # a vector a thread
    nck = ck.shape[1]
    n = nck * TS
    a, s, sr, si = gates(x, r, i, a_param, c)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, n - S))
    dh = torch.nn.functional.pad(dhs.float(), (0, 0, 0, n - S))
    log_a = torch.tensor(-c, dtype=F32) * softplus_neg(a_param)
    g = torch.zeros(B, W) if dhT is None else dhT.float().clone()
    dx, dr, di = (torch.zeros(B, S, W) for _ in range(3))
    part = torch.zeros(B, TS, W)           # a_param's per-thread partials
    for k in reversed(range(nck)):
        t0 = k * TS
        h, hp = ck[:, k], []
        for t in range(t0, t0 + TS):
            hp.append(h)
            h = a[:, t] * h + s[:, t] * (si[:, t] * xf[:, t])
        gs_ = [None] * TS
        for t in reversed(range(t0, t0 + TS)):
            g = g + dh[:, t]
            gs_[t - t0] = g
            g = g * a[:, t]
        for tt in range(min(TS, S - t0)):
            t = t0 + tt
            gv, at, st = gs_[tt], a[:, t], s[:, t]
            siv, srv, xv = si[:, t], sr[:, t], xf[:, t]
            gs = gv * st
            dsda = torch.where(1.0 - at * at >= 0, -at * rcp(st),
                               torch.zeros(()))
            da = fma(gv, hp[tt], (gv * (siv * xv)) * dsda)
            dx[:, t] = gs * siv
            di[:, t] = gs * xv * (siv * (1.0 - siv))
            dr[:, t] = da * at * log_a * (srv * (1.0 - srv))
            part[:, tt] = fma(da * at, srv, part[:, tt])
    acc = torch.zeros(B, W)
    for tt in range(TS):
        acc = acc + part[:, tt]
    sig = 1.0 / (1.0 + torch.exp(a_param.double())).float()
    da_param = (acc * torch.tensor(c, dtype=F32) * sig).sum(0)
    return (dx.to(x.dtype), dr.to(r.dtype), di.to(i.dtype), da_param, g)


def _inputs(B, S, W, h0_kind, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((B, S, W))).astype(f)
    r, i = (rng.standard_normal((B, S, W)).astype(f) for _ in range(2))
    a = rng.standard_normal(W).astype(f)
    h0 = {"none": None,
          "row": (0.1 * rng.standard_normal((B, W))).astype(f),
          "shared": (0.1 * rng.standard_normal(W)).astype(f)}[h0_kind]
    dhs = rng.standard_normal((B, S, W)).astype(f)
    dh = rng.standard_normal((B, W)).astype(f)
    return x, r, i, a, h0, dhs, dh


def _rounded(a, dtype):
    """``a`` as the kernel sees it in ``dtype``, back in numpy f32."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _jax_grads(x, r, i, a, h0, dhs, dh):
    """``jax.vjp`` of the reference's recurrence (XLA step loop); a shared
    h0 is broadcast over the rows inside, so its gradient is the rows'
    sum."""
    B, _, W = x.shape

    def f(x, r, i, a, s0):
        if s0 is not None and s0.ndim == 1:
            s0 = jnp.broadcast_to(s0, (B, W))
        return jops.rglru(x, r, i, a, s0, backend="xla")

    args = [jnp.asarray(v) for v in (x, r, i, a)]
    _, vjp = jax.vjp(f, *args, None if h0 is None else jnp.asarray(h0))
    return [None if v is None else np.asarray(v)
            for v in vjp((jnp.asarray(dhs), jnp.asarray(dh)))]


def _close(name, got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, tol * scale)


@pytest.mark.parametrize("B,S,W,h0_kind", [
    (2, 1, 33, "row"), (2, 5, 33, "none"), (2, 17, 200, "shared"),
    (1, 37, 200, "row"), (3, 37, 33, "shared")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_bwd_matches_jax_vjp(B, S, W, h0_kind, dtype):
    tdt = getattr(torch, dtype)
    x, r, i, a, h0, dhs, dh = _inputs(B, S, W, h0_kind, seed=S * W)
    x, r, i, dhs = (_rounded(v, tdt) for v in (x, r, i, dhs))
    tx, tr, ti, tdhs = (torch.from_numpy(v).to(tdt) for v in (x, r, i, dhs))
    ta = torch.from_numpy(a)
    th0 = None if h0 is None else torch.from_numpy(h0)
    ck = emulate_ck(tx, tr, ti, ta, th0)
    got = list(emulate_bwd(tx, tr, ti, ta, ck, tdhs, torch.from_numpy(dh)))
    want = _jax_grads(x, r, i, a, h0, dhs, dh)
    if h0 is not None and h0.ndim == 1:                # a shared h0
        got[4] = got[4].sum(0)
    low = 2e-2 if dtype == "bfloat16" else 1e-3
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            continue
        _close(name, g, w, low if name in ("dx", "dr", "di") else 1e-3)


def test_emulated_bwd_keeps_the_saturated_gate():
    """r_gate = -1e9 on steps of one row (a ragged row's padding): dr_gate
    is not finite on exactly those entries and da_param on every channel,
    in the emulation as in the plain backward; dx, di and dh0 stay
    finite."""
    x, r, i, a, h0, dhs, dh = (torch.from_numpy(v) for v in
                               _inputs(2, 40, 40, "row", seed=9))
    r = r.clone()
    r[1, 30:] = -1e9
    ck = emulate_ck(x, r, i, a, h0)
    got = emulate_bwd(x, r, i, a, ck, dhs, dh)
    want = rg.rglru_bwd_torch(x, r, i, a, h0, dhs, dh)
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(~torch.isfinite(g), ~torch.isfinite(w)), name
    assert int((~torch.isfinite(got[1])).sum()) == 10 * 40
    assert not torch.isfinite(got[3]).any()
    for k in (0, 2, 4):
        assert torch.isfinite(got[k]).all()


@pytest.mark.parametrize("S,h0_kind", [(1, "none"), (32, "row"),
                                       (70, "shared")])
def test_plain_checkpoints_are_the_forward_states(S, h0_kind):
    """The plain forward's checkpoints are the states of its chain before
    every 32nd step (taken here one step at a time), the last chunk's
    steps from the last checkpoint end in h_final, and the plain backward
    gives the same bits from them as from its own rerun."""
    x, r, i, a, h0, dhs, dh = (None if v is None else torch.from_numpy(v)
                               for v in _inputs(2, S, 40, h0_kind, seed=S))
    ck = rg.checkpoints(x)
    assert ck.shape == (2, -(-S // rg.CHUNK), 40)
    _, hT = rg.rglru_torch(x, r, i, a, h0, ck=ck)
    at, ut = rg.gates(x, r, i, a)
    h = torch.zeros(2, 40) if h0 is None else h0.expand(2, 40)
    for t in range(S):
        if t % rg.CHUNK == 0:
            assert torch.equal(ck[:, t // rg.CHUNK], h), t
        h = at[:, t] * h + ut[:, t]
    assert torch.equal(h, hT)
    h = ck[:, -1]
    for t in range((ck.shape[1] - 1) * rg.CHUNK, S):
        h = at[:, t] * h + ut[:, t]
    assert torch.equal(h, hT)
    rerun = rg.rglru_bwd_torch(x, r, i, a, h0, dhs, dh)
    fed = rg.rglru_bwd_torch(x, r, i, a, h0, dhs, dh, ck=ck)
    for name, p, q in zip(GRADS, rerun, fed):
        assert torch.equal(p, q), name


def test_bwd_plan_picks_block_shape_and_route():
    """The HFSL round's call (B 4, W 2560): 320 blocks of 32 channels, 8
    warps, a ring 3 chunks ahead, 16-byte copies; a row pitch that is no
    multiple of 16 bytes, or an unaligned operand, takes element loads."""
    p = rg.bwd_plan(4, 2560, torch.bfloat16)
    assert p == dict(cb=32, chunk=32, warps=8, ahead=3, blocks=320,
                     route="cp.async")
    assert rg.bwd_plan(2, 2561, torch.bfloat16)["route"] == "element"
    assert rg.bwd_plan(2, 2560, torch.float32, aligned=False)["route"] == \
        "element"
    assert rg.bwd_plan(3, 36, torch.float32)["route"] == "cp.async"
