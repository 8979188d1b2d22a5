"""The bf16 tensor-core flash_attention kernel (``csrc/attn_wgmma.cuh``) on
the CPU: its arithmetic emulated in torch, and its wrapper's padding for
TMA (``flash_attention._pad_for_tma``).

A CUDA kernel has no CPU mode, so :func:`emulate` repeats what the kernel
computes, block by block: 64 query rows a block (128 at head dims above
128), 64-key tiles, the tiles
some row of the block may see (each key's position against the rows'
least and greatest q_pos) folded first and in order, the other tiles only
if a row has then seen nothing; scores from bf16 operands summed in f32,
scaled into base 2, -1e30 for a masked key; p rounded to bf16 for the P V
product while l sums the f32 p; O / max(l, 1e-30), one cast to bf16 (the
kernel's fused multiply-adds and orders of summation aside). It is
held against the JAX package's ``flash_attention`` on its XLA backend and
against its oracle ``ref.attention`` within the bf16 tolerance 2e-2 of
tests/test_kernels.py, at small widths and the edge cases of the GPU
tests: partial q tiles (S 129, 200), T not a multiple of 64, prefix slots
0, 3 and 16, windows 16 and 100, non-causal masks, sentinel tails, rows
that see no key at all, groups 7 and 10, more tiles than the deepest
ring has stages (T 400). Skipping tiles must change no bit. Inputs are
made from a seed with numpy and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa

BN = 64                            # keys a tile
LOG2E = 1.4426950408889634
NEG_INF = -1e30
SENT = 10 ** 9


def _may_see(qlo, qhi, kp, window, causal):
    """attn_wgmma.cuh's may_see: could a row in [qlo, qhi] see key kp?"""
    vis = (kp <= qhi) if causal else (kp < 10 ** 8)
    if window > 0:
        vis = vis & ((qlo - kp) < window)
    return vis | (kp < 0)


def block_rows(D):
    """Query rows a block of the kernel's instance for head dim D."""
    return 64 if D <= 128 else 128


def emulate(q, k, v, q_pos, kv_pos, window=0, causal=True, skip=True,
            bm=None):
    """The kernel's arithmetic; q (B, S, Hq, D), k / v (B, T, Hkv, D) bf16;
    ``bm`` query rows a block (the instance's by default). With
    ``skip=False`` every tile is folded in order. Returns the output and
    the number of tiles folded per (b, h) over all q tiles."""
    B, S, Hq, D = q.shape
    BM = bm or block_rows(D)
    T, g = k.shape[1], Hq // k.shape[2]
    scale = D ** -0.5 * LOG2E
    kf = k.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(g, 2).permute(0, 2, 1, 3)
    qp_all, kp = q_pos.long(), kv_pos.long()
    n_tiles = -(-T // BN)
    out = torch.empty(B, S, Hq, D, dtype=torch.bfloat16)
    folded = 0
    for s0 in range(0, S, BM):
        s1 = min(s0 + BM, S)
        qp = qp_all[s0:s1]
        qb = q[:, s0:s1].float().permute(0, 2, 1, 3)        # (B, Hq, R, D)
        m = torch.full(qb.shape[:3], NEG_INF)
        l = torch.zeros(qb.shape[:3])
        o = torch.zeros(qb.shape)
        maybe = _may_see(qp.min(), qp.max(), kp, window, causal)
        marked = [c for c in range(n_tiles)
                  if not skip or maybe[c * BN:(c + 1) * BN].any()]
        rest = [c for c in range(n_tiles) if c not in marked]
        for tiles in (marked, rest):
            if tiles is rest and not (m <= -1e29).any():
                break
            for c in tiles:
                t0, t1 = c * BN, min(c * BN + BN, T)
                s = qb @ kf[:, :, t0:t1].transpose(-1, -2)
                vis = fa.visible(qp[:, None], kp[None, t0:t1], window,
                                 causal)
                x = torch.where(vis, s * scale, torch.full_like(s, NEG_INF))
                mn = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - mn)
                p = torch.exp2(x - mn[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + \
                    p.to(torch.bfloat16).float() @ vf[:, :, t0:t1]
                m = mn
                folded += 1
        out[:, s0:s1] = (o / l.clamp_min(1e-30)[..., None]).permute(
            0, 2, 1, 3).to(torch.bfloat16)
    return out, folded


# (B, S, T, Hq, Hkv, D): `prefix` prefix slots (position -1), then keys at
# positions 0, 1, ...; the S queries sit at the last S of them (+ shift)
SHAPES = {"s129": (2, 129, 150, 7, 1, 8), "s200": (1, 200, 216, 10, 1, 16),
          "t400": (1, 130, 400, 2, 1, 8)}
# (shape, prefix, sentinels, window, causal, shift of q_pos)
CASES = [("s129", 0, 0, 0, True, 0), ("s129", 3, 20, 16, True, 0),
         ("s129", 16, 0, 100, True, 0), ("s129", 3, 0, 0, False, 0),
         ("s129", 0, 0, 16, True, -60), ("s129", 0, 0, 0, True, -400),
         ("s200", 16, 40, 0, True, 0), ("s200", 0, 0, 100, True, 0),
         ("s200", 3, 17, 16, False, 0), ("s200", 0, 0, 8, False, 200),
         ("t400", 16, 64, 0, True, 0)]


def inputs(shape, prefix, n_sent, shift, seed):
    B, S, T, Hq, Hkv, D = SHAPES[shape]
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(s) for s in
            ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]
    kv_pos = np.concatenate([np.full(prefix, -1), np.arange(T - prefix)])
    if n_sent:
        kv_pos[-n_sent:] = SENT                     # never-visible padding
    q_pos = np.arange(S) + (T - prefix - S) + shift
    return ([jnp.asarray(x, jnp.bfloat16) for x in vals],
            [torch.from_numpy(x).to(torch.bfloat16) for x in vals],
            q_pos.astype(np.int32), kv_pos.astype(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_matches_jax(case):
    shape, prefix, n_sent, window, causal, shift = case
    (jq, jk, jv), (q, k, v), q_pos, kv_pos = inputs(shape, prefix, n_sent,
                                                   shift, len(str(case)))
    got, _ = emulate(q, k, v, torch.from_numpy(q_pos),
                     torch.from_numpy(kv_pos), window, causal)
    S, T = q.shape[1], k.shape[1]
    kw = dict(q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
              window=window, causal=causal)
    for want in (jops.flash_attention(jq, jk, jv, block_q=S, block_kv=T,
                                      backend="xla", **kw),
                 jref.attention(jq, jk, jv, **kw)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
            atol=2e-2, rtol=2e-2)
    # and the port's plain version, which the kernel is held to on the card
    plain = fa.flash_attention_torch(q, k, v, q_pos=torch.from_numpy(q_pos),
                                     kv_pos=torch.from_numpy(kv_pos),
                                     window=window, causal=causal)
    torch.testing.assert_close(got.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", CASES)
def test_tile_skipping_changes_no_bit(case, bm):
    """Folding only the tiles some row may see (and the rest only for a
    row that has seen nothing) gives the bits of folding every tile: a
    skipped tile adds exp(-1e30 - m) == 0 to a row that has seen a visible
    key, and is wiped by alpha == 0 at the first visible key before."""
    shape, prefix, n_sent, window, causal, shift = case
    _, (q, k, v), q_pos, kv_pos = inputs(shape, prefix, n_sent, shift, 7)
    args = (q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
            window, causal)
    got, folded = emulate(*args, bm=bm)
    every, all_tiles = emulate(*args, skip=False, bm=bm)
    assert torch.equal(got, every)
    assert folded <= all_tiles
    if shape == "s200" and causal and shift == 0:
        assert folded < all_tiles      # the first q tile skips the last


def _qkv(D, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed + D)
    B, S, T, Hq, Hkv = 2, 37, 40, 4, 2
    return [torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in
            ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]


POS = dict(q_pos=torch.arange(37, dtype=torch.int32),
           kv_pos=torch.arange(-3, 37, dtype=torch.int32))


@pytest.mark.parametrize("D", [4, 36, 100, 201])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_padding_gives_the_plain_result(D, dtype):
    """D zero-padded to a multiple of 8, through the plain version at the
    true D's scale and sliced back, gives the unpadded result (zero
    columns add exact zeros); one call counts one copy."""
    q, k, v = _qkv(D, dtype=dtype)
    n0 = fa.pad_copies
    pq, pk, pv = fa._pad_for_tma(q, k, v)
    assert fa.pad_copies == n0 + 1
    Dp = -(-D // 8) * 8
    for t, p in ((q, pq), (k, pk), (v, pv)):
        assert p.shape == (*t.shape[:-1], Dp)
        assert torch.equal(p[..., :D], t) and not p[..., D:].any()
    got = fa.flash_attention_torch(pq, pk, pv, scale=D ** -0.5, **POS)
    want = fa.flash_attention_torch(q, k, v, **POS)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got[..., :D], want, atol=tol, rtol=tol)
    assert not got[..., D:].any()


def test_aligned_attention_operands_come_back_without_a_copy():
    q, k, v = _qkv(64)
    n0 = fa.pad_copies
    out = fa._pad_for_tma(q, k, v)
    assert all(o is t for o, t in zip(out, (q, k, v)))
    assert fa.pad_copies == n0


def test_a_misaligned_attention_base_is_copied():
    """An aligned head dim at a base 2 bytes past a 16-byte boundary: k is
    copied to an aligned tensor with the same values, nothing else; the
    call counts one copy."""
    q, k, v = _qkv(64)
    buf = torch.zeros(k.numel() + 1, dtype=k.dtype)
    ks = buf[1:].view(k.shape)
    ks.copy_(k)
    assert ks.data_ptr() % 16 != 0
    n0 = fa.pad_copies
    pq, pk, pv = fa._pad_for_tma(q, ks, v)
    assert fa.pad_copies == n0 + 1 and pk is not ks
    assert pk.data_ptr() % 16 == 0 and torch.equal(pk, k)
    assert pq is q and pv is v
