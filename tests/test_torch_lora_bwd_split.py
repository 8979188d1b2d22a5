"""The split adapter-gradient kernel (``csrc/lora_matmul_bwd.cu``) on the
CPU: its plan (``lora_matmul.bwd_plan``) and its arithmetic emulated in
torch.

A CUDA kernel has no CPU mode, so :func:`emulate` repeats what the two
launches compute, in their order of summation: the rank pass's
``u = x A`` and ``g = s dy Bᵀ`` per row, on the plan's route: ``mma``
(bf16, r <= 16: warp w of 16 sums the 32-column chunks w, w + 16, ... of
the row, each chunk's 32 products summed in f32 as the tensor core does,
the warps added in order) or ``cuda-core`` (thread t of 256 sums the chunks
t, t + 256, ... of 16 bytes in rising order, a butterfly adds a warp's
lanes, the 8 warps are added in order); then the sweep's splits of
``bwd_plan(...)["rows"]`` rows (thread row group rg of 32 sums rows rg,
rg + 32, ... of its split, a warp's 4 row groups add as
(rg0 + rg1) + (rg2 + rg3), the warps in order), the splits' partials added
in split order and dB scaled by s (the kernel's fused multiply-adds and
the tensor core's order within a chunk aside). It is held against the JAX
package's ``lora_matmul_bwd_pallas`` in interpret mode and its oracle
``ref.lora_matmul_bwd`` within the 1e-4 relative f32 tolerance of the GPU
test, at small widths: M below one split, at and past a split boundary,
several splits, no rows; ranks 1, 8, 9, 16 and 32 (below and at each
register bucket); widths that are no multiple of a chunk or a column tile,
and so both rank routes. Inputs are made from a seed with numpy and fed
to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.lora_matmul import lora_matmul_bwd_pallas
from repro_torch.kernels import lora_matmul as lm

NT, NW, TPR = 256, 8, 8            # threads, warps; sweep threads a row
RG = NT // TPR                     # sweep row groups
UG_NW = 16                         # warps of the tensor-core rank pass


def _butterfly(v):
    """warp_sum over the last dim (32 lanes): xor 16, 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def rank_pass(src, w, vec):
    """Rows of src (M, C) against w (C, r): what lora_bwd_ug_kernel sums
    per (row, rank) entry, f32."""
    M, C = src.shape
    r = w.shape[1]
    n_chunks = -(-C // vec)
    iters = -(-n_chunks // NT)
    pad = iters * NT * vec - C
    s = torch.nn.functional.pad(src, (0, pad)).view(M, iters, NT, vec)
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad)).view(iters, NT, vec, r)
    acc = torch.zeros(M, NT, r)
    for i in range(iters):                  # a thread's chunks, then its
        for t in range(vec):                # chunk's elements, in order
            acc = acc + s[:, i, :, t, None] * wp[i, :, t][None]
    lanes = acc.view(M, NW, 32, r).permute(0, 1, 3, 2)
    warps = _butterfly(lanes)               # (M, NW, r)
    out = torch.zeros(M, r)
    for w_ in range(NW):
        out = out + warps[:, w_]
    return out


def rank_pass_mma(src, w):
    """What lora_bwd_ug_mma_kernel sums per (row, rank) entry: warp w_ of
    16 takes the 32-column chunks w_, w_ + 16, ...; the warps in order."""
    M, C = src.shape
    out = torch.zeros(M, w.shape[1])
    for w_ in range(UG_NW):
        acc = torch.zeros(M, w.shape[1])
        for c0 in range(32 * w_, C, 32 * UG_NW):
            acc = acc + src[:, c0:c0 + 32] @ w[c0:c0 + 32]
        out = out + acc
    return out


def sweep(src, rk, rows, splits):
    """Σ_m src[m, c] rk[m, j] as lora_bwd_split_kernel sums it: (C, r)."""
    M, C = src.shape
    r = rk.shape[1]
    total = torch.zeros(C, r)
    for sp in range(splits):
        lo, hi = sp * rows, min(M, (sp + 1) * rows)
        acc = torch.zeros(RG, C, r)
        for i in range(-(-(hi - lo) // RG) if hi > lo else 0):
            m = lo + torch.arange(RG) + i * RG
            on = (m < hi).float()[:, None, None]
            mm = m.clamp(max=M - 1)
            acc = acc + on * src[mm][:, :, None] * rk[mm][:, None, :]
        acc = acc.view(NW, 4, C, r)
        pair = acc[:, [0, 2]] + acc[:, [1, 3]]    # xor 8
        warp = pair[:, 0] + pair[:, 1]            # xor 16
        part = torch.zeros(C, r)
        for w_ in range(NW):
            part = part + warp[w_]
        total = total + part                      # split order
    return total


def emulate(x, dy, a, b, scale):
    """The kernel's (dA (K, r), dB (r, N)) in f32 from one dtype's x, dy,
    a, b (torch tensors)."""
    M, K = x.shape
    N, r = dy.shape[1], a.shape[1]
    p = lm.bwd_plan(M, K, N, r, dtype=x.dtype)
    xf, dyf, af, bf = (t.float() for t in (x, dy, a, b))
    if p["rank"] == "mma":
        u, g = rank_pass_mma(xf, af), scale * rank_pass_mma(dyf, bf.T)
    else:
        vec = 16 // x.element_size()
        u = rank_pass(xf, af, vec)
        g = scale * rank_pass(dyf, bf.T.contiguous(), vec)
    da = sweep(xf, g, p["rows"], p["splits"])
    db = scale * sweep(dyf, u, p["rows"], p["splits"]).T
    return da, db


def _inputs(M, K, N, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32),
            (rng.standard_normal((K, r)) * K ** -0.5).astype(np.float32),
            (rng.standard_normal((r, N)) * 0.1).astype(np.float32))


def _close(got, want):
    want = np.asarray(want, dtype=np.float32)
    t = 1e-4 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, atol=t, rtol=1e-4)


CASES = [(31, 72, 40, 1),          # M below one split of 32 rows
         (65, 130, 97, 9),         # a row past a split boundary, odd
                                   # widths, rank just past the first bucket
         (96, 56, 296, 16),        # three whole splits, several dB tiles,
                                   # rank 16's tile
         (70, 33, 17, 32),         # rank 32's 16-column tiles
         (0, 16, 8, 4)]            # no rows: zeros


@pytest.mark.parametrize("M,K,N,r", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_split_kernel_matches_jax(M, K, N, r, dtype):
    xs, dys, as_, bs = _inputs(M, K, N, r, seed=M + K + N + r)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    t_in = [torch.from_numpy(v).to(tdt) for v in (xs, dys, as_, bs)]
    j_in = [jnp.asarray(v).astype(jdt) for v in (xs, dys, as_, bs)]
    scale = 2.0
    da, db = emulate(*t_in, scale)
    assert da.shape == (K, r) and db.shape == (r, N)
    if M == 0:
        assert not da.any() and not db.any()
        return
    pda, pdb = lora_matmul_bwd_pallas(*j_in, scale, interpret=True)
    _close(da.numpy(), pda)
    _close(db.numpy(), pdb)
    # the oracle takes (x, w, a, b, scale, dy); w only feeds dx
    x_, dy_, a_, b_ = j_in
    _, rda, rdb = jref.lora_matmul_bwd(
        x_, jnp.zeros((K, N), jdt), a_, b_, scale, dy_)
    _close(da.numpy(), rda)
    _close(db.numpy(), rdb)
    # the port's plain version, which the card's test holds the kernel to
    wda, wdb = lm.lora_matmul_bwd_torch(*t_in, scale)
    _close(da.numpy(), wda.numpy())
    _close(db.numpy(), wdb.numpy())


@pytest.mark.parametrize("M,K,N,r", [(1024, 3584, 3584, 8),
                                     (1024, 3584, 512, 8), (1000, 3584,
                                                            512, 32),
                                     (1, 7, 5, 1), (0, 16, 8, 4)] + CASES)
def test_split_plan_covers_m_and_fills_the_card(M, K, N, r):
    p = lm.bwd_plan(M, K, N, r)
    assert p["rt"] in (8, 16, 32) and r <= p["rt"] and p["tc"] * p["rt"] \
        == 512
    assert p["n_k"] * p["tc"] >= K > (p["n_k"] - 1) * p["tc"]
    assert p["n_n"] * p["tc"] >= N > (p["n_n"] - 1) * p["tc"]
    assert p["rows"] % RG == 0 and p["splits"] >= 1
    assert p["splits"] * p["rows"] >= M > (p["splits"] - 1) * p["rows"] \
        or M == 0
    blocks = (p["n_k"] + p["n_n"]) * p["splits"]
    if (M, K, N) == (1024, 3584, 3584):
        assert (p["n_k"] + p["n_n"], p["splits"], p["rows"]) == (112, 2, 512)
    if (M, K, N, r) == (1024, 3584, 512, 8):
        assert (p["n_k"] + p["n_n"], p["splits"], p["rows"]) == (64, 4, 256)
    if M >= 1024:                 # the round's shapes: one wave, 2 an SM
        assert 132 <= blocks <= 2 * 132
    want = "mma" if r <= 16 and K % 8 == 0 and N % 8 == 0 else "cuda-core"
    assert p["rank"] == want
    assert lm.bwd_plan(M, K, N, r, dtype=torch.float32)["rank"] == \
        "cuda-core"
