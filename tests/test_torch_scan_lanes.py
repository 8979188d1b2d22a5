"""The selective-scan kernel (``csrc/selective_scan.cu``) on the CPU: its
arithmetic emulated in torch.

A CUDA kernel has no CPU mode, so :func:`emulate` repeats what the kernel
computes: a channel's states split over four warps, warp q owning states
q NPL .. q NPL + NPL - 1 of NM (NM = N for N 16 and 8, else 16 with the
states past N zero; NPL = NM / 4); each step's exponential as
2^(dt (A log2 e)), with A scaled by log2 e once in f32; h = h dA + (dt x) B
per state; y = each warp's h C summed over its states in rising n, the
four partials added as (s0 + s1) + (s2 + s3), then D x; one cast of y to
x's dtype (the kernel's fused multiply-adds and ex2.approx's last bits
aside).
It is held against the JAX package's ``selective_scan_pallas`` in
interpret mode and its oracle ``ref.selective_scan`` within the scans'
tolerance 1e-3 of tests/test_kernels.py, at small widths: state widths 1,
5, 8 and 16, no, per-row and shared initial states, B and C as strided
views of one x_proj-shaped array, one step and a ragged length; and a
right-padded row (dt = 0 past its length) must end in its solo state bit
for bit, since 2^0 is exactly 1. Inputs are made from a seed with numpy
and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan_pallas
from repro_torch.kernels import selective_scan as ss

LPC = 4                            # warps (state groups) a channel
LOG2E = 1.4426950408889634


def lane_states(N):
    """(NM, NPL): the kernel's state slots and slots a warp."""
    nm = N if N in (8, 16) else ss.NMAX
    return nm, nm // LPC


def emulate(x, dt, A, Bm, C, D, h0=None):
    """The kernel's (y in x.dtype, h_final f32); shapes as
    ``selective_scan``."""
    Bb, S, Di = x.shape
    N = A.shape[-1]
    nm, npl = lane_states(N)
    pad = nm - N
    a2 = torch.nn.functional.pad(A.float() * torch.tensor(LOG2E), (0, pad))
    bf = torch.nn.functional.pad(Bm.float(), (0, pad))
    cf = torch.nn.functional.pad(C.float(), (0, pad))
    h = torch.zeros(Bb, Di, nm)
    if h0 is not None:
        h[..., :N] = h0.float().expand(Bb, Di, N)
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        dA = torch.exp2(dtt[..., None] * a2)
        h = h * dA + (dtt * xt)[..., None] * bf[:, t, None, :]
        hc = h * cf[:, t, None, :]
        parts = []
        for q in range(LPC):
            s = torch.zeros(Bb, Di)
            for i in range(npl):
                s = s + hc[..., q * npl + i]
            parts.append(s)
        acc = (parts[0] + parts[1]) + (parts[2] + parts[3])
        ys.append(acc + D.float() * xt)
    return torch.stack(ys, 1).to(x.dtype), h[..., :N]


def _inputs(B, S, Di, N, h0_kind, seed):
    """x, dt, A, B, C, D, h0 as numpy f32, B and C as column views of one
    x_proj-shaped array, as the ssm layer makes them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, Di)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * 0.1
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal((Di, N)) * 0.3).astype(np.float32)
    xdbc = (rng.standard_normal((B, S, 5 + 2 * N)) * 0.5).astype(np.float32)
    D = rng.standard_normal(Di).astype(np.float32)
    h0 = {"none": None,
          "row": (rng.standard_normal((B, Di, N)) * 0.1).astype(np.float32),
          "shared": (rng.standard_normal((Di, N)) * 0.1).astype(np.float32)
          }[h0_kind]
    return x, dt, A, xdbc, D, h0


def _torch_args(x, dt, A, xdbc, D, h0, N, dtype):
    t = lambda v: torch.from_numpy(v).to(dtype)  # noqa: E731
    xd = t(xdbc)
    return (t(x), t(dt), torch.from_numpy(A), xd[..., 5:5 + N],
            xd[..., 5 + N:], torch.from_numpy(D),
            None if h0 is None else torch.from_numpy(h0))


@pytest.mark.parametrize("B,S,Di,N,h0_kind", [
    (2, 16, 32, 16, "row"), (2, 37, 40, 5, "shared"), (1, 1, 24, 1, "none"),
    (2, 24, 16, 8, "row")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_lanes_match_jax(B, S, Di, N, h0_kind, dtype):
    x, dt, A, xdbc, D, h0 = _inputs(B, S, Di, N, h0_kind, seed=S * Di + N)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, h = emulate(*_torch_args(x, dt, A, xdbc, D, h0, N, tdt))
    assert y.dtype == tdt and y.shape == (B, S, Di)
    assert h.dtype == torch.float32 and h.shape == (B, Di, N)
    xd = jnp.asarray(xdbc).astype(jdt)
    jargs = (jnp.asarray(x).astype(jdt), jnp.asarray(dt).astype(jdt),
             jnp.asarray(A), xd[..., 5:5 + N], xd[..., 5 + N:],
             jnp.asarray(D))
    jh0 = None if h0 is None else jnp.broadcast_to(jnp.asarray(h0),
                                                   (B, Di, N))
    tol = 2e-2 if dtype == "bfloat16" else 1e-3
    for yw, hw in (selective_scan_pallas(*jargs, jh0, interpret=True),
                   jref.selective_scan(*jargs, jh0)):
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(yw, dtype=np.float32),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), atol=1e-3,
                                   rtol=1e-3)
    # and the port's plain version, which the card's tests hold the kernel to
    yp, hp = ss.selective_scan_torch(*_torch_args(x, dt, A, xdbc, D, h0, N,
                                                  tdt))
    np.testing.assert_allclose(y.float().numpy(), yp.float().numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(h.numpy(), hp.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("N", [16, 5])
def test_padded_row_state_passes_through_bit_for_bit(N):
    """dt = 0 past a row's length: 2^(0 A) = 1 and (0 x) B = 0, so the
    emulated state at the end of the padded row is its solo state, bit for
    bit."""
    B, S, Di = 3, 30, 16
    x, dt, A, xdbc, D, h0 = _inputs(B, S, Di, N, "row", seed=7)
    lens = [30, 9, 17]
    for b, n in enumerate(lens):
        dt[b, n:] = 0.0
    args = _torch_args(x, dt, A, xdbc, D, h0, N, torch.float32)
    _, h = emulate(*args)
    for b, n in enumerate(lens):
        solo = [args[0][b:b + 1, :n], args[1][b:b + 1, :n], args[2],
                args[3][b:b + 1, :n], args[4][b:b + 1, :n], args[5],
                args[6][b:b + 1]]
        _, hb = emulate(*solo)
        assert torch.equal(h[b], hb[0]), b
    assert torch.equal(torch.exp2(torch.zeros(4) * -3.0), torch.ones(4))
