"""The RG-LRU kernel (``csrc/rglru_scan.cu``) on the CPU: its arithmetic
emulated in torch.

A CUDA kernel has no CPU mode, so :func:`emulate` repeats what the kernel
computes, in its f32 operation order: per channel ``log_a2 = (-c
softplus(-a_param)) log2 e``; each step's gates ``sigmoid(v) = rcp(1 +
ex2(v (-log2 e)))``, ``a_t = ex2(sigmoid(r_t) log_a2)`` and ``u_t =
sqrt(max(1 - a_t a_t, 0)) (sigmoid(i_t) x_t)``, every product, sum and
difference rounded to f32 as the kernel rounds it; every step at or past
S in the last tile of ``rglru_scan.plan(...)["tile"]`` steps as ``a_t =
1, u_t = 0``; and the chain ``h = a_t h + u_t`` in time order, a product
then a sum (no fused multiply-add), over whole tiles; one cast of h to
x's dtype. The kernel takes each ex2, rcp and sqrt from one ``.approx.ftz``
special-function instruction; here each is taken in f64 and rounded to
f32, subnormal results flushed to 0 as ``.ftz`` does. The instructions'
own error (PTX ISA: about 2^-22 relative for ex2, about 1 ulp for rcp and
sqrt) is bounded by running the emulation again with every such result
scaled by 1 + 2^-21 and by 1 - 2^-21: it must stay within the same
tolerance.

It is held against the JAX package's ``rglru_pallas`` in interpret mode
and its oracle ``ref.rglru`` within the scans' tolerance of
tests/test_kernels.py (1e-3; bf16 outputs 2e-2, a bf16 ulp), at small
widths that are no multiple of the kernel's 32-channel blocks (33, 200),
lengths across the tile (1, 5, 17, 37), no, per-row and shared initial
states, f32 and bf16. A right-padded row (r = -1e9 past its length) must
end in its solo state bit for bit, which holds because in f32 ``rcp(1 +
ex2(1e9 log2 e)) = rcp(inf) = 0``, ``ex2(0 log_a2) = 1`` and ``sqrt(1 -
1) = 0``; the steps past S must leave h as it was (a zero-filled step
would not: x = r = i = 0 gives a_t < 1); and ``plan`` must pick the
kernel's block shape and copy route. Inputs are made from a seed with
numpy and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro_torch.kernels import rglru_scan as rg

F32 = torch.float32
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)   # the kernel's LOG2E
APPROX = 2.0 ** -21     # bound on a special-function instruction's error


def _sfu(v, rel):
    """A special-function result: ``v`` (f64) rounded to f32, subnormals
    flushed, scaled by ``1 + rel``."""
    v = v.to(F32)
    v = torch.where(v.abs() < 2.0 ** -126, torch.zeros_like(v), v)
    return v * torch.tensor(1.0 + rel, dtype=F32) if rel else v


def ex2(v, rel=0.0):
    return _sfu(torch.exp2(v.double()), rel)


def rcp(v, rel=0.0):
    return _sfu(1.0 / v.double(), rel)


def sqrt(v, rel=0.0):
    return _sfu(torch.sqrt(v.double()), rel)


def sigmoid(v, rel=0.0):
    """The kernel's ``sigmoid_f`` on f32 ``v``."""
    return rcp(1.0 + ex2(v * -LOG2E, rel), rel)


def log_a2(a_param, c=8.0):
    """The kernel's per-channel ``log_a2``: precise ``softplus`` (torch's
    threshold 20), then two f32 products."""
    v = -a_param.to(F32)
    sp = torch.where(v > 20, v, torch.log1p(torch.exp(v.double())).to(F32))
    return torch.tensor(-c, dtype=F32) * sp * LOG2E


def emulate(x, r_gate, i_gate, a_param, h0=None, c=8.0, tile=None,
            rel=0.0):
    """The kernel's (h_seq in x.dtype, h_final f32); shapes as ``rglru``;
    ``tile`` defaults to the plan's; ``rel`` scales every special-function
    result by ``1 + rel``."""
    B, S, W = x.shape
    ts = tile or rg.plan(B, W, x.dtype)["tile"]
    n = -(-S // ts) * ts
    a = ex2(sigmoid(r_gate.to(F32), rel) * log_a2(a_param, c), rel)
    u = sqrt(torch.clamp(1.0 - a * a, min=0.0), rel) \
        * (sigmoid(i_gate.to(F32), rel) * x.to(F32))
    a = torch.cat([a, torch.ones(B, n - S, W)], 1)
    u = torch.cat([u, torch.zeros(B, n - S, W)], 1)
    h = torch.zeros(B, W) if h0 is None else h0.float().expand(B, W)
    hs = []
    for t in range(n):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs[:S], 1).to(x.dtype), h


def _inputs(B, S, W, h0_kind, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, W)) * 0.5).astype(np.float32)
    r = rng.standard_normal((B, S, W)).astype(np.float32)
    i = rng.standard_normal((B, S, W)).astype(np.float32)
    a = rng.standard_normal(W).astype(np.float32)
    h0 = {"none": None,
          "row": (rng.standard_normal((B, W)) * 0.1).astype(np.float32),
          "shared": (rng.standard_normal(W) * 0.1).astype(np.float32)
          }[h0_kind]
    return x, r, i, a, h0


def _torch_args(x, r, i, a, h0, dtype):
    t = lambda v: torch.from_numpy(v).to(dtype)  # noqa: E731
    return (t(x), t(r), t(i), torch.from_numpy(a),
            None if h0 is None else torch.from_numpy(h0))


@pytest.mark.parametrize("B,S,W,h0_kind", [
    (2, 17, 33, "row"), (2, 37, 200, "shared"), (1, 1, 33, "none"),
    (3, 5, 200, "row"), (2, 37, 33, "none")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_lanes_match_jax(B, S, W, h0_kind, dtype):
    x, r, i, a, h0 = _inputs(B, S, W, h0_kind, seed=S * W + B)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = _torch_args(x, r, i, a, h0, tdt)
    hs, h = emulate(*args)
    assert hs.dtype == tdt and hs.shape == (B, S, W)
    assert h.dtype == torch.float32 and h.shape == (B, W)
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt),
             jnp.asarray(i).astype(jdt), jnp.asarray(a))
    jh0 = None if h0 is None else jnp.broadcast_to(jnp.asarray(h0), (B, W))
    tol = 2e-2 if dtype == "bfloat16" else 1e-3
    wants = (rglru_pallas(*jargs, jh0, interpret=True),
             jref.rglru(*jargs, jh0))
    # exact special functions, then each off by the bound of its .approx
    for rel in (0.0, APPROX, -APPROX):
        hs_r, h_r = (hs, h) if not rel else emulate(*args, rel=rel)
        for hw, hTw in wants:
            np.testing.assert_allclose(hs_r.float().numpy(),
                                       np.asarray(hw, dtype=np.float32),
                                       atol=tol, rtol=tol)
            np.testing.assert_allclose(h_r.numpy(), np.asarray(hTw),
                                       atol=1e-3, rtol=1e-3)
    # and the port's plain version, which the card's tests hold the kernel to
    hp, hTp = rg.rglru_torch(*_torch_args(x, r, i, a, h0, tdt))
    np.testing.assert_allclose(hs.float().numpy(), hp.float().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), hTp.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_row_state_passes_through_bit_for_bit(dtype):
    """r = -1e9 past a row's length: sigmoid is 1 / inf = 0, a_t = 2^0 = 1
    and u_t = 0, so the emulated state at the end of the padded row is its
    solo state, bit for bit."""
    B, S, W = 3, 40, 33
    x, r, i, a, h0 = _inputs(B, S, W, "row", seed=7)
    lens = [40, 9, 17]
    rp = r.copy()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
    _, h = emulate(*_torch_args(x, rp, i, a, h0, dtype))
    for b, n in enumerate(lens):
        _, hb = emulate(*_torch_args(x[b:b + 1, :n], r[b:b + 1, :n],
                                     i[b:b + 1, :n], a, h0[b:b + 1], dtype))
        assert torch.equal(h[b], hb[0]), b
    # the f32 facts it rests on
    s = sigmoid(torch.tensor([-1e9]))
    at = ex2(s * log_a2(torch.from_numpy(a)))
    assert torch.equal(s, torch.zeros(1)) and bool((at == 1).all())
    assert bool((sqrt(torch.clamp(1.0 - at * at, min=0.0)) == 0).all())


@pytest.mark.parametrize("S", [1, 17, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_steps_past_S_leave_h_as_it_was(S, dtype):
    """The last tile's steps past S (a_t = 1, u_t = 0) give the final state
    of the unpadded chain bit for bit; zero-filled steps would decay it,
    since x = r = i = 0 gives a_t = ex2(log_a2 / 2) < 1."""
    x, r, i, a, h0 = _inputs(2, S, 40, "row", seed=S)
    args = _torch_args(x, r, i, a, h0, dtype)
    ts = rg.plan(2, 40, dtype)["tile"]
    assert ts == (16 if dtype == torch.float32 else 32) and S % ts
    hs, h = emulate(*args)
    hs1, h1 = emulate(*args, tile=1)
    assert torch.equal(h, h1) and torch.equal(hs, hs1)
    pad = -(-S // ts) * ts - S
    zeros = [np.concatenate([v, np.zeros((2, pad, 40), np.float32)], 1)
             for v in (x, r, i)]
    _, hz = emulate(*_torch_args(*zeros, a, h0, dtype), tile=1)
    assert not torch.equal(hz, h)
    a_zero = ex2(sigmoid(torch.zeros(40)) * log_a2(torch.from_numpy(a)))
    assert bool((a_zero < 1).all())


def test_plan_picks_block_shape_and_route():
    """4 warps and 2 tiles ahead where the grid has two blocks or more for
    each SM (B 8 at recurrentgemma-2b's width: 640 blocks), 16 warps and 3
    ahead below (a one-row refill: 80 blocks); the cp.async route only for
    a row pitch that is a multiple of 16 bytes and aligned operands."""
    p = rg.plan(8, 2560)
    assert p == dict(cb=32, tile=32, warps=4, ahead=2, blocks=640,
                     route="cp.async")
    p = rg.plan(1, 2560)
    assert (p["warps"], p["ahead"], p["blocks"]) == (16, 3, 80)
    assert rg.plan(4, 2560)["warps"] == 4 and rg.plan(3, 2560)["warps"] == 16
    assert rg.plan(3, 2560, n_sm=60)["warps"] == 4
    assert rg.plan(8, 2560, torch.float32)["tile"] == 16
    for W, dtype, route in ((200, torch.bfloat16, "cp.async"),
                            (200, torch.float32, "cp.async"),
                            (33, torch.bfloat16, "element"),
                            (33, torch.float32, "element"),
                            (2561, torch.bfloat16, "element"),
                            (2564, torch.float32, "cp.async"),
                            (2564, torch.bfloat16, "element")):
        assert rg.plan(2, W, dtype)["route"] == route, (W, dtype)
        assert rg.plan(2, W, dtype)["blocks"] == 2 * -(-W // 32)
    assert rg.plan(8, 2560, aligned=False)["route"] == "element"
