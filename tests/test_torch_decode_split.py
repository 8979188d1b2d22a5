"""The bf16 split-KV decode tile (``csrc/decode_split.cuh``) on the CPU:
its split rule and its arithmetic emulated in torch.

A CUDA kernel has no CPU mode, so :func:`emulate` repeats what the kernel
computes: a row's keys in 64-key tiles (the lead, a prefix bank or a
dense cache's leading slots at negative positions, in tiles of its own),
runs of ``split_plan`` tiles a block, four warps of 16 keys a tile each
with their own (m, l, O), the tiles without a visible key skipped (every
tile folded for a row that sees nothing), the warps merged in order, an
empty split's partial (-inf, 0), and the splits combined in split order;
scores from bf16 operands summed in f32, scaled into base 2, -1e30 for a
masked key and -inf past a tile's last key, p rounded to bf16 for the P V
product while l sums the f32 p, O / max(l, 1e-30), one cast to bf16 (the
kernel's fused multiply-adds and orders of summation aside). It is held
against the JAX package's ``flash_decode`` and ``flash_decode_paged`` (XLA
backend, and the Pallas kernels in interpret mode) and their oracles
within the bf16 tolerance 2e-2 of tests/test_kernels.py, at small widths:
prefix banks of 0, 3, 16 and 70 slots, windows, sentinel tails, rows that
see nothing, groups 1 to 16, more tiles than one split takes. Skipping
tiles must change no bit, and paged, dense with the bank in place and
dense on the concatenated cache must give the same bits. A multi-tenant
bank read by the rows' ids must give the bits of its slots gathered per
row; prefix layouts are checked; a TMA map handed to a launch must outlive
the clearing of the map cache. Inputs are made from a seed with numpy and
fed to both packages.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

LOG2E = 1.4426950408889634
NEG_INF = -1e30
SENT = 10 ** 9
WARP_KEYS = 16                     # keys of a tile each of the 4 warps takes


def _row_keys(k, v, kv_pos, prefix_k, prefix_v, b):
    """Row b's keys, values and positions in the kernel's order, and the
    lead's length."""
    if prefix_k is not None:
        pk = prefix_k[b] if prefix_k.dim() == 4 else prefix_k
        pv = prefix_v[b] if prefix_v.dim() == 4 else prefix_v
        pos = torch.cat([torch.full((pk.shape[0],), -1, dtype=torch.long),
                         kv_pos[b].long()])
        return (torch.cat([pk, k[b]]), torch.cat([pv, v[b]]), pos,
                pk.shape[0])
    pos = kv_pos[b].long()
    nonneg = (pos >= 0).nonzero()
    lead = int(nonneg[0]) if len(nonneg) else len(pos)
    return k[b], v[b], pos, lead


def _fold(q, kt, vt, vis, scale_log2, m, l, o):
    """One warp's keys of one tile into (m, l, o): q (g, D) f32; kt, vt
    (n, D) bf16 (n <= 16, the rest of the warp's keys past the tile's
    end); vis (n,) bool."""
    s = q @ kt.float().T
    x = torch.where(vis, s * scale_log2, torch.full_like(s, NEG_INF))
    x = torch.cat([x, torch.full((q.shape[0], WARP_KEYS - x.shape[1]),
                                 float("-inf"))], 1)
    mn = torch.maximum(m, x.amax(-1))
    alpha = torch.exp2(m - mn)
    p = torch.exp2(x - mn[:, None])
    l = l * alpha + p.sum(-1)
    o = o * alpha[:, None] + p[:, :kt.shape[0]].to(torch.bfloat16).float() \
        @ vt.float()
    return mn, l, o


def emulate(q, k, v, q_pos, kv_pos, prefix_k=None, prefix_v=None, window=0,
            causal=True, skip=True):
    """The kernel's arithmetic; q (B, Hq, D), k / v (B, T, Hkv, D) bf16,
    kv_pos (B, T); a prefix bank (n_p, Hkv, D) or (B, n_p, Hkv, D). With
    ``skip=False`` every tile is folded. Returns the output and the number
    of tiles folded."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    n_p = 0 if prefix_k is None else prefix_k.shape[-3]
    scale_log2 = D ** -0.5 * LOG2E
    tps, n_splits = fd.split_plan(D, n_p + T)
    out = torch.empty(B, Hq, D, dtype=torch.bfloat16)
    folded = 0
    for b in range(B):
        keys, vals, pos, lead = _row_keys(k, v, kv_pos, prefix_k, prefix_v,
                                          b)
        tiles = fd.key_tiles(lead, n_p + T)
        vis = fa.visible(q_pos[b].long(), pos, window, causal)
        blind = not bool(vis.any())
        for hk in range(Hkv):
            qg = q[b, hk * g:(hk + 1) * g].float()
            parts = []
            for sp in range(n_splits):
                run = tiles[sp * tps:(sp + 1) * tps]
                fold = [t for t in run if blind or not skip
                        or vis[t[0]:t[1]].any()]
                if not fold:
                    parts.append((torch.full((g,), float("-inf")),
                                  torch.zeros(g), None))
                    continue
                warps = [(torch.full((g,), NEG_INF), torch.zeros(g),
                          torch.zeros(g, D)) for _ in range(4)]
                for t0, t1 in fold:
                    folded += 1
                    for w in range(4):
                        a = min(t0 + WARP_KEYS * w, t1)
                        z = min(a + WARP_KEYS, t1)
                        warps[w] = _fold(qg, keys[a:z, hk], vals[a:z, hk],
                                         vis[a:z], scale_log2, *warps[w])
                mx = torch.stack([w[0] for w in warps]).amax(0)
                wts = [torch.exp2(w[0] - mx) for w in warps]
                parts.append((mx, sum(wt * w[1] for wt, w in zip(wts, warps)),
                              sum(wt[:, None] * w[2]
                                  for wt, w in zip(wts, warps))))
            m = torch.stack([p[0] for p in parts]).amax(0)
            lsum, acc = torch.zeros(g), torch.zeros(g, D)
            for ms, ls, os_ in parts:
                wt = torch.where(ms == float("-inf"), torch.zeros(g),
                                 torch.exp2(ms - m))
                lsum = lsum + wt * ls
                if os_ is not None:
                    acc = acc + wt[:, None] * os_
            out[b, hk * g:(hk + 1) * g] = (
                acc / lsum.clamp_min(1e-30)[:, None]).to(torch.bfloat16)
    return out, folded


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [8, 64, 128, 256])
@pytest.mark.parametrize("n_keys", [1, 64, 65, 1040, 2064, 40000])
def test_split_plan_covers_every_tiling_within_the_cap(D, n_keys):
    """The splits cover every cut of n_keys keys (the lead's last tile
    partial, or none), at most MAX_SPLITS of them, runs of 2 tiles (4 at
    D <= 64) until the cap makes them longer; the rule reads the head dim
    and the key count only."""
    tps, n = fd.split_plan(D, n_keys)
    assert 1 <= n <= fd.MAX_SPLITS
    assert tps == max(4 if D <= 64 else 2,
                      -(-(-(-n_keys // 64) + 1) // fd.MAX_SPLITS))
    for lead in (0, 1, 3, 16, 70, n_keys):
        lead = min(lead, n_keys)
        assert len(fd.key_tiles(lead, n_keys)) <= tps * n
    assert fd.split_plan(D, n_keys) == (tps, n)


def test_split_plan_at_the_main_path_shapes():
    """qwen2-7b's row 3 (1024 + 16 keys, D 128): 9 runs of 2 tiles;
    recurrentgemma-2b's row 3b (2048 + 16, D 256): 17; the paged drain's
    row 4 (16 + 64 x 16) as row 3."""
    assert fd.split_plan(128, 16 + 1024) == (2, 9)
    assert fd.split_plan(256, 16 + 2048) == (2, 17)
    assert fd.split_plan(128, 16 + 64 * 16) == fd.split_plan(128, 1040)


@pytest.mark.parametrize("n_p,T", [(0, 100), (3, 61), (16, 1024), (70, 1),
                                   (64, 64), (130, 200)])
def test_key_tiles_put_the_prefix_in_tiles_of_its_own(n_p, T):
    """The lead in 64-key tiles of its own, the last partial; the rest
    from its first key; every key once, in order."""
    tiles = fd.key_tiles(n_p, n_p + T)
    n0 = -(-n_p // 64)
    assert [t for t in tiles[:n0]] == [(a, min(a + 64, n_p))
                                       for a in range(0, n_p, 64)]
    assert tiles[n0][0] == n_p
    flat = [i for a, b in tiles for i in range(a, b)]
    assert flat == list(range(n_p + T))
    assert all(0 < b - a <= 64 for a, b in tiles)


def test_split_plan_is_the_same_for_dense_and_paged_and_any_batch():
    """A paged row of maxb * bs slots behind n_p prefix slots, the same
    row dense with the bank in place, and dense on the concatenated cache
    (whose lead is its run of -1 slots) count n_p + T keys and cut the
    same tiles; B and Hkv do not enter the rule."""
    for D, n_p, bs, maxb in ((128, 16, 16, 64), (64, 3, 4, 40),
                             (128, 70, 128, 3), (256, 0, 16, 5)):
        T = maxb * bs
        kv_pos = torch.cat([torch.full((1, n_p), -1), torch.arange(T)[None]],
                           1)
        _, _, pos, lead = _row_keys(torch.zeros(1, n_p + T, 1, 1),
                                    torch.zeros(1, n_p + T, 1, 1), kv_pos,
                                    None, None, 0)
        assert lead == n_p and pos.tolist() == kv_pos[0].tolist()
        assert fd.key_tiles(lead, n_p + T) == fd.key_tiles(n_p, n_p + T)
        assert fd.split_plan(D, n_p + T) == fd.split_plan(D, T + n_p)


# ---------------------------------------------------------------------------
# the arithmetic against the JAX package
# ---------------------------------------------------------------------------

# (B, T, n_prefix, Hq, Hkv, D): groups 1 to 16, T past one split (D 16
# takes 4 tiles a split, so T 300 + 70 is 2 splits and more)
SHAPES = {"g7": (3, 130, 7, 1, 16), "g2": (2, 65, 4, 2, 16),
          "g16": (2, 300, 16, 1, 8), "g1": (2, 63, 2, 2, 32)}
# (shape, prefix, per_row, window, q_pos shift: rows that see nothing)
CASES = [("g7", 0, False, 0, 0), ("g7", 3, False, 0, 0),
         ("g7", 16, True, 6, 0), ("g2", 70, False, 0, 0),
         ("g2", 0, False, 6, 0), ("g16", 3, True, 0, 0),
         ("g16", 70, False, 40, 0), ("g1", 16, False, 0, 0),
         ("g7", 0, False, 0, -200), ("g16", 0, False, 6, -500),
         ("g2", 3, False, 0, -100)]


def _inputs(shape, n_p, per_row, shift, seed):
    B, T, Hq, Hkv, D = SHAPES[shape]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D))
    k, v = (rng.standard_normal((B, T, Hkv, D)) for _ in range(2))
    q_pos = rng.integers(1, T, B).astype(np.int32)
    kv_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kv_pos[kv_pos > q_pos[:, None]] = SENT               # sentinel tails
    q_pos[0] += shift                                    # may see nothing
    pshape = (B, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
    pk = rng.standard_normal(pshape) if n_p else None
    pv = rng.standard_normal(pshape) if n_p else None
    return q, k, v, q_pos, kv_pos, pk, pv


def _bf16(x):
    if x is None:
        return None, None
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(np.asarray(x)).to(torch.bfloat16))


@pytest.mark.parametrize("case", CASES)
def test_emulated_decode_matches_jax(case):
    shape, n_p, per_row, window, shift = case
    q, k, v, q_pos, kv_pos, pk, pv = _inputs(shape, n_p, per_row, shift,
                                             len(str(case)))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    (jpk, tpk), (jpv, tpv) = _bf16(pk), _bf16(pv)
    got, _ = emulate(tq, tk, tv, torch.from_numpy(q_pos),
                     torch.from_numpy(kv_pos), tpk, tpv, window)
    kw = dict(q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
              prefix_k=jpk, prefix_v=jpv, window=window)
    wants = [jops.flash_decode(jq, jk, jv, backend="xla", **kw)]
    if shape == "g7" and shift == 0:
        # the Pallas kernel (interpret mode); a row that sees nothing it
        # averages over its block-padded length, so only rows that see
        wants.append(jops.flash_decode(jq, jk, jv, block_kv=16,
                                       backend="interpret", **kw))
    # the oracle on the bank concatenated in front
    B, n_p_ = q.shape[0], 0 if pk is None else pk.shape[-3]
    if pk is not None:
        bk = jpk if per_row else jnp.broadcast_to(jpk, (B, *pk.shape))
        bv = jpv if per_row else jnp.broadcast_to(jpv, (B, *pv.shape))
        jk, jv = jnp.concatenate([bk, jk], 1), jnp.concatenate([bv, jv], 1)
    wants.append(jref.decode_attention(
        jq, jk, jv, q_pos=jnp.asarray(q_pos), window=window,
        kv_pos=jnp.asarray(np.concatenate(
            [np.full((B, n_p_), -1, np.int32), kv_pos], 1))))
    for want in wants:
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
            atol=2e-2, rtol=2e-2)
    # and the port's plain version, which the kernel is held to on the card
    plain = fd.flash_decode_torch(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                                  kv_pos=torch.from_numpy(kv_pos),
                                  window=window, prefix_k=tpk, prefix_v=tpv)
    torch.testing.assert_close(got.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


def test_emulated_row_that_sees_nothing_averages_uniformly():
    """No prefix, every slot masked: each split folds every tile with
    -1e30 scores, and the combine gives the mean of the row's values."""
    q, k, v, q_pos, kv_pos, _, _ = _inputs("g16", 0, False, -500, 3)
    _, tq = _bf16(q)
    _, tk = _bf16(k)
    _, tv = _bf16(v)
    got, _ = emulate(tq, tk, tv, torch.from_numpy(q_pos),
                     torch.from_numpy(kv_pos), window=6)
    want = tv[0].float().mean(0).repeat_interleave(16, 0)
    torch.testing.assert_close(got[0].float(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", CASES)
def test_skipping_tiles_changes_no_bit(case):
    """Folding only the tiles with a visible key gives the bits of folding
    every tile: a skipped tile adds exp2(-1e30 - m) == 0 to a warp that has
    seen a visible key, and is wiped by alpha == 0 before it; a warp that
    never sees one weighs exp2(-1e30 - m) == 0 in the merge."""
    shape, n_p, per_row, window, shift = case
    q, k, v, q_pos, kv_pos, pk, pv = _inputs(shape, n_p, per_row, shift, 7)
    args = [_bf16(x)[1] for x in (q, k, v)] + \
        [torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
         _bf16(pk)[1], _bf16(pv)[1], window]
    got, folded = emulate(*args)
    every, all_tiles = emulate(*args, skip=False)
    assert torch.equal(got, every)
    assert folded <= all_tiles
    if shift == 0 and window == 0 and shape == "g16":
        assert folded < all_tiles          # the sentinel tails are skipped


@pytest.mark.parametrize("bs,maxb,n_p", [(4, 30, 3), (16, 8, 16), (8, 9, 70),
                                         (128, 2, 0)])
def test_paged_in_place_and_concatenated_give_the_same_bits(bs, maxb, n_p):
    """The paged layout (pool[table] behind the bank), dense with the bank
    in place, and dense on with_prefix's concatenation (its leading -1
    slots found as the lead) cut the same tiles and splits: the same bits;
    and the paged result is the JAX package's within 2e-2."""
    B, Hq, Hkv, D = 3, 7, 1, 16
    rng = np.random.default_rng(bs + maxb + n_p)
    nb = B * maxb + 2
    q = rng.standard_normal((B, Hq, D))
    kpool, vpool = (rng.standard_normal((nb, bs, Hkv, D)) for _ in range(2))
    table = rng.permutation(nb)[:B * maxb].reshape(B, maxb).astype(np.int32)
    q_pos = rng.integers(0, maxb * bs, B).astype(np.int32)
    cols = np.arange(maxb)[None]
    table = np.where(cols <= q_pos[:, None] // bs, table, nb)  # sentinels
    pk = rng.standard_normal((B, n_p, Hkv, D)) if n_p else None
    pv = rng.standard_normal((B, n_p, Hkv, D)) if n_p else None
    (jq, tq), (jkp, tkp), (jvp, tvp) = _bf16(q), _bf16(kpool), _bf16(vpool)
    (jpk, tpk), (jpv, tpv) = _bf16(pk), _bf16(pv)
    tt, tqp = torch.from_numpy(table), torch.from_numpy(q_pos)
    kg, vg = fd.gather_pool(tkp, tvp, tt)
    slots = torch.arange(maxb * bs, dtype=torch.int32)[None].expand(B, -1)
    in_place, _ = emulate(tq, kg, vg, tqp, slots, tpk, tpv)
    kc, vc, kpc = fd.with_prefix(kg, vg, slots, tpk, tpv)
    concat, _ = emulate(tq, kc, vc, tqp, kpc)
    assert torch.equal(in_place, concat)
    want = jops.flash_decode_paged(jq, jkp, jvp, jnp.asarray(table),
                                   q_pos=jnp.asarray(q_pos), prefix_k=jpk,
                                   prefix_v=jpv, backend="xla")
    np.testing.assert_allclose(in_place.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    if n_p == 0:
        oracle = jref.paged_decode_attention(jq, jkp, jvp,
                                             jnp.asarray(table),
                                             q_pos=jnp.asarray(q_pos))
        np.testing.assert_allclose(
            in_place.float().numpy(),
            np.asarray(jnp.asarray(oracle, jnp.float32)), atol=2e-2,
            rtol=2e-2)


def test_a_row_gives_its_bits_in_any_batch():
    """A row alone and the same row in a batch of 3: the same splits, the
    same bits (the rule reads no batch size)."""
    q, k, v, q_pos, kv_pos, pk, pv = _inputs("g7", 16, True, 0, 11)
    args = [_bf16(x)[1] for x in (q, k, v)] + \
        [torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
         _bf16(pk)[1], _bf16(pv)[1]]
    batch, _ = emulate(*args)
    for i in range(3):
        one, _ = emulate(*[a[i:i + 1] for a in args])
        assert torch.equal(one[0], batch[i])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bank_read_by_id_is_the_bank_gathered_per_row(paged, dtype):
    """A multi-tenant bank's stacked prefix slots read by the rows' ids
    (``prefix_ids``, as bank drains pass them) give, through ``ops``, the
    bits of the same slots gathered per row, and the JAX package's
    ``flash_decode`` on the gathered slots within 2e-2."""
    from repro_torch.kernels import ops
    B, n_slots, n_p, Hq, Hkv, D, bs, maxb = 4, 3, 5, 7, 1, 16, 8, 6
    rng = np.random.default_rng(7 + paged)
    q = rng.standard_normal((B, Hq, D))
    bk, bv = (rng.standard_normal((n_slots, n_p, Hkv, D)) for _ in range(2))
    ids = np.array([2, 0, 2, 1], np.int32)
    q_pos = rng.integers(0, maxb * bs, B).astype(np.int32)
    kc, vc = (rng.standard_normal((B, maxb * bs, Hkv, D)) for _ in range(2))
    kv_pos = np.arange(maxb * bs, dtype=np.int32)
    tq, tbk, tbv, tk, tv = (torch.from_numpy(x).to(dtype)
                            for x in (q, bk, bv, kc, vc))
    tid = torch.from_numpy(ids)
    if paged:
        table = torch.arange(B * maxb, dtype=torch.int32).reshape(B, maxb)
        pool = (tk.reshape(B * maxb, bs, Hkv, D), tv.reshape(B * maxb, bs,
                                                             Hkv, D))

        def call(**kw):
            return ops.flash_decode_paged(tq, *pool, table,
                                          q_pos=torch.from_numpy(q_pos), **kw)
    else:
        def call(**kw):
            return ops.flash_decode(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                                    kv_pos=torch.from_numpy(kv_pos), **kw)
    got = call(prefix_k=tbk, prefix_v=tbv, prefix_ids=tid)
    rows = call(prefix_k=tbk[tid.long()], prefix_v=tbv[tid.long()])
    assert torch.equal(got, rows)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jops.flash_decode(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        prefix_k=jnp.asarray(bk[ids], jd), prefix_v=jnp.asarray(bv[ids], jd),
        backend="xla")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_prefix_banks_are_checked_by_their_layout():
    """``_check_prefix``: shared (n_p, Hkv, D), per row (B, n_p, Hkv, D),
    stacked (n_slots, n_p, Hkv, D) with ids (B,); ids need a stacked
    bank."""
    B, Hkv, D = 3, 2, 8
    t = torch.zeros
    assert fd._check_prefix("f", None, None, None, B, Hkv, D) == \
        (0, False, 0)
    assert fd._check_prefix("f", t(4, Hkv, D), t(4, Hkv, D), None, B, Hkv,
                            D) == (4, False, B)
    assert fd._check_prefix("f", t(B, 4, Hkv, D), t(B, 4, Hkv, D), None, B,
                            Hkv, D) == (4, True, B)
    ids = torch.zeros(B, dtype=torch.int32)
    assert fd._check_prefix("f", t(7, 4, Hkv, D), t(7, 4, Hkv, D), ids, B,
                            Hkv, D) == (4, True, 7)
    for pk, pid in ((t(4, Hkv, D), ids), (t(7, 4, Hkv, D), ids[:2]),
                    (None, ids), (t(7, 4, Hkv, D), None)):
        with pytest.raises(ValueError):
            fd._check_prefix("f", pk, pk, pid, B, Hkv, D)


class _FakeEncoder:
    """Stands in for a library's ``<name>_encode_map``: writes the base
    address and the box rows into the map's first bytes."""
    argtypes = restype = None

    def __call__(self, buf, base, D, H, rows, nbatch, box_rows):
        ctypes.memmove(buf, ctypes.c_uint64(base).value.to_bytes(8, "little")
                       + box_rows.to_bytes(4, "little"), 12)
        return 0


def test_a_map_outlives_the_cache_clearing_it():
    """``_map`` hands out the map's buffer itself: when a later lookup of
    the same launch clears the full cache, the buffers already looked up
    keep their encoded bytes, and a cleared map is encoded again."""
    lib = type("Lib", (), {"fake_encode_map": _FakeEncoder()})()
    saved = dict(fd._MAPS)
    fd._MAPS.clear()
    try:
        for i in range(1023):
            fd._MAPS[("filler", i)] = ctypes.create_string_buffer(128)
        a, b = torch.zeros(4, 2, 8), torch.zeros(4, 2, 8)
        e0 = fd.map_encodes
        ma = fd._map(lib, "fake", a, 2, 4, 1, 64)
        mb = fd._map(lib, "fake", b, 2, 4, 1, 64)      # clears the cache
        assert len(fd._MAPS) == 1 and fd.map_encodes - e0 == 2
        assert ma.raw[:8] == a.data_ptr().to_bytes(8, "little")
        assert mb.raw[:8] == b.data_ptr().to_bytes(8, "little")
        assert fd._map(lib, "fake", b, 2, 4, 1, 64) is mb
        assert fd._map(lib, "fake", a, 2, 4, 1, 64) is not ma
        assert fd.map_encodes - e0 == 3
    finally:
        fd._MAPS.clear()
        fd._MAPS.update(saved)
