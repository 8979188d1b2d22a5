"""The port's kernel ops (plain versions, on the CPU) against the JAX
package: ``repro.kernels.ref`` oracles and the Pallas kernels in interpret
mode. Inputs are made from a seed with numpy and fed to both packages.
Gradients: the autograd ``lora_matmul`` against ``jax.grad`` through the
reference's custom VJP in interpret mode, and the flash-attention backward
against ``jax.grad`` of the reference oracle.

Tolerances are those of tests/test_kernels.py: f32 2e-5, bf16 2e-2, and
for the bf16 LoRA gradients atol 1e-1 / rtol 5e-2 (sums over M rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lora_matmul as jlm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref

SENT = 10 ** 9
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def pair(a, name):
    """The same numpy values as a jax array and a torch tensor."""
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------

# (B, S, n_prefix, Hq, Hkv, D, n_sentinel)
ATTN_CASES = [
    (1, 16, 0, 2, 2, 8, 0),          # g = 1, no prefix
    (2, 37, 5, 4, 2, 16, 3),         # g = 2, prefix, sentinels, ragged S
    (2, 40, 4, 7, 1, 32, 0),         # g = 7
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("window,causal", [(0, True), (8, True),
                                           (0, False)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_jax(case, window, causal, dt):
    B, S, n_p, Hq, Hkv, D, n_s = case
    rng = np.random.default_rng(sum(case) + window)
    T = n_p + S
    q, tq = pair(rng.standard_normal((B, S, Hq, D)), dt)
    k, tk = pair(rng.standard_normal((B, T, Hkv, D)), dt)
    v, tv = pair(rng.standard_normal((B, T, Hkv, D)), dt)
    kv_pos = np.concatenate([np.full(n_p, -1), np.arange(S)]).astype(np.int32)
    if n_s:
        kv_pos[-n_s:] = SENT                       # never-visible padding
    q_pos = np.arange(S, dtype=np.int32)
    got = ops.flash_attention(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                              kv_pos=torch.from_numpy(kv_pos),
                              window=window, causal=causal)
    want = jref.attention(q, k, v, q_pos=jnp.asarray(q_pos),
                          kv_pos=jnp.asarray(kv_pos), window=window,
                          causal=causal)
    pallas = jops.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos),
                                  kv_pos=jnp.asarray(kv_pos), window=window,
                                  causal=causal, block_q=16, block_kv=16,
                                  backend="interpret")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dt))
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dt))


def test_flash_attention_torch_oracle_matches_jax_oracle():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 9, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    q_pos = np.arange(9, dtype=np.int32)
    kv_pos = np.concatenate([[-1, -1, -1], np.arange(9)]).astype(np.int32)
    got = ref.attention(*map(torch.from_numpy, (q, k, v)),
                        q_pos=torch.from_numpy(q_pos),
                        kv_pos=torch.from_numpy(kv_pos), window=4)
    want = jref.attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f32"))


# ---------------------------------------------------------------------------
# Flash decode
# ---------------------------------------------------------------------------

# (B, T, n_prefix, Hq, Hkv, D)
DECODE_CASES = [
    (3, 20, 0, 2, 2, 16),            # g = 1
    (2, 33, 4, 4, 2, 8),             # g = 2, prefix bank
    (3, 40, 3, 7, 1, 32),            # g = 7, prefix bank
]


def _decode_inputs(case, rng):
    B, T, n_p, Hq, Hkv, D = case
    q = rng.standard_normal((B, Hq, D))
    k = rng.standard_normal((B, T, Hkv, D))
    v = rng.standard_normal((B, T, Hkv, D))
    q_pos = rng.integers(1, T, B).astype(np.int32)       # per-row positions
    kv_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kv_pos[kv_pos > q_pos[:, None]] = SENT               # unwritten slots
    pk = rng.standard_normal((n_p, Hkv, D)) if n_p else None
    pv = rng.standard_normal((n_p, Hkv, D)) if n_p else None
    return q, k, v, q_pos, kv_pos, pk, pv


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_matches_jax(case, window, dt):
    rng = np.random.default_rng(sum(case) + window)
    q, k, v, q_pos, kv_pos, pk, pv = _decode_inputs(case, rng)
    (jq, tq), (jk, tk), (jv, tv) = pair(q, dt), pair(k, dt), pair(v, dt)
    jpk = tpk = jpv = tpv = None
    if pk is not None:
        (jpk, tpk), (jpv, tpv) = pair(pk, dt), pair(pv, dt)
    got = ops.flash_decode(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                           kv_pos=torch.from_numpy(kv_pos), prefix_k=tpk,
                           prefix_v=tpv, window=window)
    pallas = jops.flash_decode(jq, jk, jv, q_pos=jnp.asarray(q_pos),
                               kv_pos=jnp.asarray(kv_pos), prefix_k=jpk,
                               prefix_v=jpv, window=window, block_kv=16,
                               backend="interpret")
    if pk is not None:                       # oracle on the concatenated bank
        B, n_p = q.shape[0], pk.shape[0]
        jk = jnp.concatenate([jnp.broadcast_to(jpk, (B, *pk.shape)), jk], 1)
        jv = jnp.concatenate([jnp.broadcast_to(jpv, (B, *pv.shape)), jv], 1)
        kv_pos = np.concatenate([np.full((B, n_p), -1, np.int32), kv_pos], 1)
    want = jref.decode_attention(jq, jk, jv, q_pos=jnp.asarray(q_pos),
                                 kv_pos=jnp.asarray(kv_pos), window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dt))
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dt))


def test_decode_torch_oracle_matches_jax_oracle():
    rng = np.random.default_rng(1)
    q, k, v, q_pos, kv_pos, _, _ = _decode_inputs((3, 11, 0, 4, 2, 8), rng)
    args = [a.astype(np.float32) for a in (q, k, v)]
    got = ref.decode_attention(*map(torch.from_numpy, args),
                               q_pos=torch.from_numpy(q_pos),
                               kv_pos=torch.from_numpy(kv_pos))
    want = jref.decode_attention(*args, q_pos=q_pos, kv_pos=kv_pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f32"))


# ---------------------------------------------------------------------------
# LoRA-fused matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,r", [(5, 19, 37, 3), (70, 65, 130, 8),
                                     (8, 96, 20, 1)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_matmul_matches_jax(M, K, N, r, with_bias, dt):
    rng = np.random.default_rng(M * K + N + r)
    x, tx = pair(rng.standard_normal((M, K)), dt)
    w, tw = pair(rng.standard_normal((K, N)) / np.sqrt(K), dt)
    a, ta = pair(rng.standard_normal((K, r)) / np.sqrt(K), dt)
    b, tb = pair(rng.standard_normal((r, N)), dt)
    bias, tbias = pair(rng.standard_normal(N), dt) if with_bias \
        else (None, None)
    got = ops.lora_matmul(tx, tw, ta, tb, 2.0, tbias)
    want = jref.lora_matmul(x, w, a, b, 2.0, bias)
    pallas = jops.lora_matmul(x, w, a, b, 2.0, bias, backend="interpret")
    assert got.dtype == tx.dtype and got.shape == (M, N)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dt))
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dt))
    plain = ops.lora_matmul(tx, tw, bias=tbias)          # no adapter
    np.testing.assert_allclose(
        f32(plain), f32(jops.lora_matmul(x, w, bias=bias)), **tol(dt))


def vjp_tol(name):
    return dict(atol=1e-1, rtol=5e-2) if name == "bf16" else tol("f32")


def _lora_operands(M, K, N, r, dt, seed=0):
    """x, w, a, b, bias, dy as (jax, torch) pairs; b is nonzero so dA is
    not trivially zero."""
    rng = np.random.default_rng(seed + M * K + N + r)
    shapes = [(M, K), (K, N), (K, r), (r, N), (N,), (M, N)]
    scales = [1.0, 0.05, 0.05, 0.05, 1.0, 1.0]
    return [pair(s * rng.standard_normal(shp), dt)
            for s, shp in zip(scales, shapes)]


@pytest.mark.parametrize("M,K,N,r", [(32, 64, 48, 4), (100, 200, 144, 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_matmul_bwd_matches_jax(M, K, N, r, dt):
    """The plain adapter-grad version against ``ref.lora_matmul_bwd`` (JAX)
    and ``lora_matmul_bwd_pallas`` in interpret mode; the port's oracle
    against the JAX oracle, dx included."""
    (x, tx), (w, tw), (a, ta), (b, tb), _, (dy, tdy) = _lora_operands(
        M, K, N, r, dt)
    da, db = lm.lora_matmul_bwd(tx, tdy, ta, tb, 2.0)
    assert da.dtype == db.dtype == torch.float32
    assert da.shape == (K, r) and db.shape == (r, N)
    rdx, rda, rdb = jref.lora_matmul_bwd(x, w, a, b, 2.0, dy)
    pda, pdb = jlm.lora_matmul_bwd_pallas(x, dy, a, b, 2.0, interpret=True)
    for got, want in ((da, rda), (db, rdb), (da, pda), (db, pdb)):
        np.testing.assert_allclose(f32(got), f32(want), **vjp_tol(dt))
    odx, oda, odb = ref.lora_matmul_bwd(tx, tw, ta, tb, 2.0, tdy)
    assert odx.dtype == tx.dtype
    for got, want in ((odx, rdx), (oda, rda), (odb, rdb)):
        np.testing.assert_allclose(f32(got), f32(want), **vjp_tol(dt))


@pytest.mark.parametrize("M,K,N,r", [(32, 64, 48, 4), (100, 200, 144, 8)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_matmul_autograd_matches_jax_custom_vjp(M, K, N, r, dt):
    """dx, dA, dB, dbias of the autograd ``lora_matmul`` against
    ``jax.grad`` through the reference's custom VJP (Pallas interpret)."""
    (x, tx), (w, tw), (a, ta), (b, tb), (bias, tbias), (dy, tdy) = \
        _lora_operands(M, K, N, r, dt, seed=1)

    def f(x_, a_, b_, bias_):
        y = jops.lora_matmul(x_, w, a_, b_, 2.0, bias_, backend="interpret")
        return jnp.sum(y.astype(jnp.float32) * dy.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(x, a, b, bias)
    leaves = [t.clone().requires_grad_(True) for t in (tx, ta, tb, tbias)]
    y = ops.lora_matmul(leaves[0], tw, leaves[1], leaves[2], 2.0, leaves[3])
    (y.float() * tdy.float()).sum().backward()
    for t, wg in zip(leaves, want):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        np.testing.assert_allclose(f32(t.grad), f32(wg), **vjp_tol(dt))
    assert tw.grad is None                       # PEFT: dW never formed


def test_lora_matmul_autograd_full_ft_dw_matches_jax():
    """Full fine-tuning (``w`` requires grad) gets the exact dW = xᵀ dy."""
    (x, tx), (w, tw), (a, ta), (b, tb), _, (dy, tdy) = _lora_operands(
        24, 32, 40, 4, "f32", seed=2)
    dw = jax.grad(lambda w_: jnp.vdot(
        jops.lora_matmul(x, w_, a, b, 2.0, backend="interpret"), dy))(w)
    tw = tw.clone().requires_grad_(True)
    (ops.lora_matmul(tx, tw, ta, tb, 2.0) * tdy).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), **tol("f32"))
    np.testing.assert_allclose(tw.grad.numpy(), (tx.T @ tdy).numpy(),
                               **tol("f32"))


# (B, S, n_prefix, Hq, Hkv, D, window)
ATTN_GRAD_CASES = [
    (2, 21, 4, 4, 2, 16, 0),         # GQA g = 2, prefix slots
    (1, 40, 3, 6, 1, 8, 7),          # g = 6, prefix, sliding window
    (2, 9, 0, 2, 2, 8, 0),           # g = 1, no prefix
]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
@pytest.mark.parametrize("chunk", [None, 5])
def test_flash_attention_grad_matches_jax(case, chunk, monkeypatch):
    """dq, dk, dv of the flash-attention Function against ``jax.grad`` of
    ``ref.attention`` (the gradient the reference's training takes from
    XLA), prefix slots at position -1 included; ``chunk`` forces the
    backward to recompute several query chunks."""
    B, S, n_p, Hq, Hkv, D, window = case
    if chunk:
        monkeypatch.setattr(fa, "SCORE_BUDGET", chunk * B * Hq * (n_p + S))
    rng = np.random.default_rng(sum(case))
    T = n_p + S
    q, tq = pair(rng.standard_normal((B, S, Hq, D)), "f32")
    k, tk = pair(rng.standard_normal((B, T, Hkv, D)), "f32")
    v, tv = pair(rng.standard_normal((B, T, Hkv, D)), "f32")
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kv_pos = np.concatenate([np.full(n_p, -1), np.arange(S)]).astype(np.int32)
    q_pos = np.arange(S, dtype=np.int32)

    def f(q_, k_, v_):
        o = jref.attention(q_, k_, v_, q_pos=jnp.asarray(q_pos),
                           kv_pos=jnp.asarray(kv_pos), window=window)
        return jnp.sum(o * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, q_pos=torch.from_numpy(q_pos),
                              kv_pos=torch.from_numpy(kv_pos), window=window)
    (out * torch.from_numpy(do)).sum().backward()
    for t, wg in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wg),
                                   **tol("f32"))


# ---------------------------------------------------------------------------
# Multi-tenant LoRA (bgmv rows and seq)
# ---------------------------------------------------------------------------

def _bgmv_operands(M, K, N, r, n_slots, dt, with_bias, seq=None, seed=0):
    """The same numpy values for both packages (cf. tests/test_kernels.py
    ``_bgmv_operands``)."""
    rng = np.random.default_rng(seed + M * K + N + r + n_slots)
    shape = (M, K) if seq is None else (M, seq, K)
    x, tx = pair(rng.standard_normal(shape), dt)
    w, tw = pair(0.05 * rng.standard_normal((K, N)), dt)
    a, ta = pair(0.05 * rng.standard_normal((n_slots, K, r)), dt)
    b, tb = pair(0.05 * rng.standard_normal((n_slots, r, N)), dt)
    bias, tbias = pair(rng.standard_normal(N), dt) if with_bias \
        else (None, None)
    ids = rng.integers(0, n_slots, M).astype(np.int32)
    return (x, w, a, b, bias, jnp.asarray(ids)), \
        (tx, tw, ta, tb, tbias, torch.from_numpy(ids))


@pytest.mark.parametrize("M,K,N,r,n_slots", [
    (16, 32, 24, 4, 3),
    (100, 200, 144, 8, 5),           # padding path
    (8, 64, 48, 4, 1),               # degenerate single tenant
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_lora_bgmv_rows_matches_jax(M, K, N, r, n_slots, dt, with_bias):
    """Decode shape: one adapter id per row, against the JAX gather oracle
    and the Pallas rows kernel in interpret mode."""
    (x, w, a, b, bias, ids), targs = _bgmv_operands(M, K, N, r, n_slots, dt,
                                                    with_bias)
    got = ops.lora_bgmv(*targs[:4], targs[5], 2.0, targs[4])
    want = jref.lora_bgmv(x, w, a, b, ids, 2.0, bias)
    pallas = jops.lora_bgmv(x, w, a, b, ids, 2.0, bias, backend="interpret")
    assert got.dtype == targs[0].dtype and got.shape == (M, N)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dt))
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dt))


@pytest.mark.parametrize("B,S,K,N,r,n_slots", [
    (4, 12, 32, 24, 4, 3),
    (3, 9, 96, 80, 8, 4),            # padding path
    (2, 5, 16, 8, 2, 1),             # degenerate single tenant
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_lora_bgmv_seq_matches_jax(B, S, K, N, r, n_slots, dt, with_bias):
    """Prefill shape: one adapter id per sequence (the seq kernel)."""
    (x, w, a, b, bias, ids), targs = _bgmv_operands(B, K, N, r, n_slots, dt,
                                                    with_bias, seq=S)
    got = ops.lora_bgmv(*targs[:4], targs[5], 2.0, targs[4])
    want = jref.lora_bgmv(x, w, a, b, ids, 2.0, bias)
    pallas = jops.lora_bgmv(x, w, a, b, ids, 2.0, bias, backend="interpret")
    assert got.dtype == targs[0].dtype and got.shape == (B, S, N)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dt))
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dt))


@pytest.mark.parametrize("seq", [None, 7])
def test_lora_bgmv_torch_oracle_matches_jax_oracle(seq):
    (x, w, a, b, bias, ids), targs = _bgmv_operands(6, 20, 12, 3, 4, "f32",
                                                    True, seq=seq)
    got = ref.lora_bgmv(*targs[:4], targs[5], 2.0, targs[4])
    want = jref.lora_bgmv(x, w, a, b, ids, 2.0, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol("f32"))


@pytest.mark.parametrize("seq", [None, 5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lora_bgmv_equals_lora_matmul_per_row(seq, dt):
    """The multi-tenant == single-tenant contract within the port's plain
    versions: each row (sequence) equals ``lora_matmul`` with its own
    adapter, bit for bit. CPU BLAS may block a product differently for
    another row count, so both run on the whole batch here; the kernels
    meet the claim for any batch (tests/test_torch_cuda.py)."""
    _, (x, w, a, b, bias, ids) = _bgmv_operands(12, 40, 24, 4, 3, dt, True,
                                                seq=seq)
    got = ops.lora_bgmv(x, w, a, b, ids, 2.0, bias).reshape(-1, 24)
    rid = ids.repeat_interleave(seq) if seq else ids
    for s in range(3):
        want = ops.lora_matmul(x.reshape(-1, 40), w, a[s], b[s], 2.0, bias)
        rows = rid == s
        assert rows.any() and torch.equal(got[rows], want[rows]), s


def test_lora_bgmv_rejects_ids_of_the_wrong_shape():
    """As the reference: one id per row of 2-D x, per sequence of 3-D x."""
    _, (x, w, a, b, _, ids) = _bgmv_operands(6, 8, 5, 2, 2, "f32", False,
                                             seq=3)
    with pytest.raises(ValueError, match="one id per sequence"):
        ops.lora_bgmv(x, w, a, b, ids.repeat(3), 1.0)
    with pytest.raises(ValueError, match="one id per row"):
        ops.lora_bgmv(x[:, 0], w, a, b, ids[:2], 1.0)
    (jx, jw, ja, jb, _, jids), _ = _bgmv_operands(6, 8, 5, 2, 2, "f32",
                                                  False, seq=3)
    with pytest.raises(ValueError, match="one id per sequence"):
        jops.lora_bgmv(jx, jw, ja, jb, jnp.repeat(jids, 3), 1.0)


# ---------------------------------------------------------------------------
# Dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(4, 8)
    ops.lora_matmul(x, torch.randn(8, 6), torch.randn(8, 2),
                    torch.randn(2, 6), 1.0)
    q = torch.randn(1, 3, 2, 8)
    ops.flash_attention(q, q, q, q_pos=torch.arange(3),
                        kv_pos=torch.arange(3))
    a, b = torch.randn(3, 8, 2), torch.randn(3, 2, 6)
    ops.lora_bgmv(x, torch.randn(8, 6), a, b, torch.tensor([0, 2, 1, 1]),
                  1.0)
    ops.lora_bgmv(x[None].expand(2, 4, 8), torch.randn(8, 6), a, b,
                  torch.tensor([2, 0]), 1.0)
    x.requires_grad_(True)
    ops.lora_matmul(x, torch.randn(8, 6), torch.randn(8, 2),
                    torch.randn(2, 6), 1.0).sum().backward()
    assert ops.launch_counts() == {"lora_matmul": 0, "lora_matmul_bwd": 0,
                                   "flash_attention": 0, "flash_decode": 0,
                                   "lora_bgmv_rows": 0, "lora_bgmv_seq": 0}


@pytest.mark.parametrize("op", ["lora_matmul", "flash_attention",
                                "lora_bgmv_rows", "lora_bgmv_seq",
                                "lora_matmul_bwd"])
def test_asking_for_the_kernel_on_cpu_tensors_raises(op):
    """backend='cuda' never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "lora_matmul_bwd":
            lm.lora_matmul_bwd(torch.randn(4, 8), torch.randn(4, 6),
                               torch.randn(8, 2), torch.randn(2, 6), 1.0,
                               backend="cuda")
        elif op == "lora_matmul":
            ops.lora_matmul(torch.randn(4, 8), torch.randn(8, 6),
                            torch.randn(8, 2), torch.randn(2, 6), 1.0,
                            backend="cuda")
        elif op.startswith("lora_bgmv"):
            x = torch.randn(4, 8) if op.endswith("rows") \
                else torch.randn(4, 3, 8)
            ops.lora_bgmv(x, torch.randn(8, 6), torch.randn(2, 8, 2),
                          torch.randn(2, 2, 6), torch.zeros(4, dtype=torch.int32),
                          1.0, backend="cuda")
        else:
            q = torch.randn(1, 3, 2, 8)
            ops.flash_attention(q, q, q, q_pos=torch.arange(3),
                                kv_pos=torch.arange(3), backend="cuda")


def test_backend_context_and_unknown_backend():
    with ops.backend("torch"):
        assert ops.get_backend() == "torch"
    assert ops.get_backend() is None
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.set_backend("pallas")


def test_online_softmax_tiles_equal_one_pass_softmax():
    """The kernels' 32-key tile loop (plain version) over a T that spans
    several tiles equals the untiled oracle."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 70, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 75, 1, 16)).astype(
        np.float32))
    q_pos, kv_pos = torch.arange(70), torch.arange(75) - 5
    got = fa.flash_attention_torch(q, k, k, q_pos=q_pos, kv_pos=kv_pos)
    want = ref.attention(q, k, k, q_pos=q_pos, kv_pos=kv_pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol("f32"))
