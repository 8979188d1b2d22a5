"""The port's CUDA kernels against their plain PyTorch versions, on the
card: odd shapes (M, N, K not multiples of any tile, g = 7, D = 64),
windows, non-causal masks, sentinels and prefix slots; the multi-LoRA
kernels with 1 to 8 slots, ranks 1 to 32, and ids all the same, all
different and repeating, and bit for bit against ``lora_matmul`` per row;
the adapter-gradient kernel, the autograd ``lora_matmul`` and the
flash-attention backward on the card against autograd through the plain
versions, and a reduced HFSL round through the kernels against the same
round through the plain versions. A CUDA kernel has
no CPU mode, so without a GPU every test here skips; run them on the GPU
machine with ``pytest -m gpu tests/test_torch_cuda.py``. This file imports
no JAX (that machine has none).

Tolerances: bf16 2e-2 as in tests/test_kernels.py; f32 1e-4, because the
kernels sum up to a few thousand terms in another order than cuBLAS.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lora_bgmv as bg
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype, s=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)


def close(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
        (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("M,K,N,r", [(1, 7, 5, 1), (65, 130, 97, 8),
                                     (8, 3584, 512, 8), (130, 67, 200, 32)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_matmul_kernel(gen, M, K, N, r, with_bias, dtype):
    x = randn(gen, M, K, dtype=dtype)
    w = randn(gen, K, N, dtype=dtype, s=K ** -0.5)
    a = randn(gen, K, r, dtype=dtype, s=K ** -0.5)
    b = randn(gen, r, N, dtype=dtype, s=0.1)
    bias = randn(gen, N, dtype=dtype) if with_bias else None
    n0 = lm.launches
    got = lm.lora_matmul(x, w, a, b, 2.0, bias)
    assert lm.launches == n0 + 1
    close(got, lm.lora_matmul_torch(x, w, a, b, 2.0, bias), dtype)


def _ids(gen, n, n_slots, pattern):
    if pattern == "same":
        return torch.full((n,), n_slots - 1, dtype=torch.int32,
                          device="cuda")
    if pattern == "distinct":                 # all different where possible
        return (torch.arange(n, device="cuda") % n_slots).to(torch.int32)
    return torch.randint(0, n_slots, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)  # repeating, in no order


def _bgmv_operands(gen, lead, K, N, r, n_slots, dtype, with_bias):
    x = randn(gen, *lead, K, dtype=dtype)
    w = randn(gen, K, N, dtype=dtype, s=K ** -0.5)
    a = randn(gen, n_slots, K, r, dtype=dtype, s=K ** -0.5)
    b = randn(gen, n_slots, r, N, dtype=dtype, s=0.1)
    bias = randn(gen, N, dtype=dtype) if with_bias else None
    return x, w, a, b, bias


BGMV_SHAPES = [(1, 7, 5, 1, 1), (8, 130, 97, 8, 4), (65, 67, 200, 32, 8),
               (8, 3584, 512, 8, 4)]          # (M or B, K, N, r, n_slots)


@pytest.mark.parametrize("M,K,N,r,n_slots", BGMV_SHAPES)
@pytest.mark.parametrize("pattern", ["same", "distinct", "repeat"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_bgmv_rows_kernel(gen, M, K, N, r, n_slots, pattern, with_bias,
                               dtype):
    x, w, a, b, bias = _bgmv_operands(gen, (M,), K, N, r, n_slots, dtype,
                                      with_bias)
    ids = _ids(gen, M, n_slots, pattern)
    n0 = bg.rows_launches
    got = bg.lora_bgmv_rows(x, w, a, b, ids, 2.0, bias)
    assert bg.rows_launches == n0 + 1
    close(got, bg.lora_bgmv_torch(x, w, a, b, ids, 2.0, bias), dtype)


@pytest.mark.parametrize("B,K,N,r,n_slots", BGMV_SHAPES)
@pytest.mark.parametrize("S", [2, 70])
@pytest.mark.parametrize("pattern", ["same", "distinct", "repeat"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_bgmv_seq_kernel(gen, B, K, N, r, n_slots, S, pattern, dtype):
    x, w, a, b, bias = _bgmv_operands(gen, (B, S), K, N, r, n_slots, dtype,
                                      True)
    ids = _ids(gen, B, n_slots, pattern)
    n0 = bg.seq_launches
    got = bg.lora_bgmv_seq(x, w, a, b, ids, 2.0, bias)
    assert bg.seq_launches == n0 + 1
    close(got, bg.lora_bgmv_torch(x, w, a, b, ids, 2.0, bias), dtype)


@pytest.mark.parametrize("seq", [None, 37])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_bgmv_rows_equal_lora_matmul_bit_for_bit(gen, seq, dtype):
    """Each row (sequence) equals ``lora_matmul`` run alone with its own
    adapter: the same bits, whatever batch it came in."""
    n, K, N, r, n_slots = 9, 200, 131, 8, 4
    lead = (n,) if seq is None else (n, seq)
    x, w, a, b, bias = _bgmv_operands(gen, lead, K, N, r, n_slots, dtype,
                                      True)
    ids = _ids(gen, n, n_slots, "repeat")
    if seq is None:
        got = bg.lora_bgmv_rows(x, w, a, b, ids, 2.0, bias)
    else:
        got = bg.lora_bgmv_seq(x, w, a, b, ids, 2.0, bias)
    for i, s in enumerate(ids.tolist()):
        xi = x[i:i + 1] if seq is None else x[i]
        want = lm.lora_matmul(xi, w, a[s].contiguous(), b[s].contiguous(),
                              2.0, bias)
        gi = got[i:i + 1] if seq is None else got[i]
        assert torch.equal(gi, want), (i, (gi.float() - want.float()).abs()
                                       .max().item())


def test_ops_lora_bgmv_routes_by_shape(gen):
    """3-D x with S > 1 takes the seq kernel; (M, K) and (B, 1, K) the rows
    kernel; ids of another shape raise before any launch."""
    x, w, a, b, _ = _bgmv_operands(gen, (4, 3), 16, 8, 2, 2, torch.float32,
                                   False)
    ids = _ids(gen, 4, 2, "repeat")
    ops.reset_launch_counts()
    ops.lora_bgmv(x, w, a, b, ids, 1.0)
    ops.lora_bgmv(x[:, :1].contiguous(), w, a, b, ids, 1.0)
    ops.lora_bgmv(x[:, 0].contiguous(), w, a, b, ids, 1.0)
    with pytest.raises(ValueError, match="one id per sequence"):
        ops.lora_bgmv(x, w, a, b, ids.repeat(3), 1.0)
    counts = ops.launch_counts()
    assert (counts["lora_bgmv_seq"], counts["lora_bgmv_rows"]) == (1, 2)


# (B, S, n_prefix, Hq, Hkv, D)
@pytest.mark.parametrize("case", [(1, 1, 0, 1, 1, 8), (2, 37, 5, 14, 2, 64),
                                  (3, 70, 16, 28, 4, 128)])
@pytest.mark.parametrize("window,causal", [(0, True), (16, True),
                                           (0, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(gen, case, window, causal, dtype):
    B, S, n_p, Hq, Hkv, D = case
    q = randn(gen, B, S, Hq, D, dtype=dtype)
    k = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
    v = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"), q_pos])
    if S >= 4:
        kv_pos[-(S // 4):] = 10 ** 9                # never-visible padding
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, causal=causal)
    n0 = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n0 + 1
    close(got, fa.flash_attention_torch(q, k, v, **kw), dtype)


# (B, T, n_prefix, Hq, Hkv, D)
@pytest.mark.parametrize("case", [(1, 1, 0, 2, 2, 16), (3, 45, 4, 7, 1, 64),
                                  (8, 300, 16, 28, 4, 128),
                                  (2, 33, 0, 32, 2, 128)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_kernel(gen, case, window, dtype):
    B, T, n_p, Hq, Hkv, D = case
    q = randn(gen, B, Hq, D, dtype=dtype)
    k = randn(gen, B, T, Hkv, D, dtype=dtype)
    v = randn(gen, B, T, Hkv, D, dtype=dtype)
    qp = torch.randint(0, T, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    kp = torch.where(slots <= qp[:, None], slots,
                     torch.full_like(slots, 10 ** 9))
    pk = randn(gen, n_p, Hkv, D, dtype=dtype) if n_p else None
    pv = randn(gen, n_p, Hkv, D, dtype=dtype) if n_p else None
    n0 = fd.launches
    got = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                           prefix_v=pv, window=window)
    assert fd.launches == n0 + 1
    with ops.backend("torch"):
        want = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                                prefix_v=pv, window=window)
    assert fd.launches == n0 + 1
    close(got, want, dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = randn(gen, 4, 8, dtype=torch.float32)
    w = randn(gen, 8, 6, dtype=torch.float32)
    a, b = randn(gen, 8, 2, dtype=torch.float32), \
        randn(gen, 2, 6, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lora_matmul(x, w.t().contiguous().t(), a, b, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lm.lora_matmul(x.half(), w.half(), a.half(), b.half(), 1.0)
    with pytest.raises(ValueError, match="rank"):
        lm.lora_matmul(x, w, randn(gen, 8, 33, dtype=torch.float32),
                       randn(gen, 33, 6, dtype=torch.float32), 1.0)
    q = randn(gen, 1, 2, 1, 256, dtype=torch.float32)
    with pytest.raises(ValueError, match="int32"):
        bg.lora_bgmv_rows(x, w, a[None], b[None],
                          torch.zeros(4, dtype=torch.int64, device="cuda"),
                          1.0)
    with pytest.raises(ValueError, match="chain"):
        bg.lora_bgmv_seq(x[None], w, a[None], b[None],
                         torch.zeros(2, dtype=torch.int32, device="cuda"), 1.0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, q_pos=torch.arange(2, device="cuda"),
                           kv_pos=torch.arange(2, device="cuda"))


@pytest.mark.parametrize("M,K,N,r", [(1, 7, 5, 1), (65, 130, 97, 8),
                                     (1024, 3584, 512, 8), (130, 67, 200, 32),
                                     (0, 16, 8, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_matmul_bwd_kernel(gen, M, K, N, r, dtype):
    x = randn(gen, M, K, dtype=dtype)
    dy = randn(gen, M, N, dtype=dtype)
    a = randn(gen, K, r, dtype=dtype, s=K ** -0.5)
    b = randn(gen, r, N, dtype=dtype, s=0.1)
    n0 = lm.bwd_launches
    da, db = lm.lora_matmul_bwd(x, dy, a, b, 2.0)
    assert lm.bwd_launches == n0 + 1
    wa, wb = lm.lora_matmul_bwd_torch(x, dy, a, b, 2.0)
    # f32 outputs summed over M rows: the f32 tolerance, scaled by the
    # magnitude of the sums
    for got, want in ((da, wa), (db, wb)):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        t = 1e-4 * max(1.0, want.abs().max().item())
        assert torch.allclose(got, want, atol=t, rtol=1e-4), \
            (got - want).abs().max().item()
    again = lm.lora_matmul_bwd(x, dy, a, b, 2.0)       # no atomics
    assert torch.equal(again[0], da) and torch.equal(again[1], db)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("train_w", [False, True])
def test_lora_matmul_autograd_on_the_card(gen, dtype, train_w):
    """dx (the forward kernel on (Wᵀ, Bᵀ, Aᵀ)), dA/dB (the bwd kernel),
    dbias and, under full fine-tuning only, dW, against autograd through
    ``ref.lora_matmul``."""
    M, K, N, r = 96, 200, 136, 8
    x = randn(gen, M, K, dtype=dtype)
    w = randn(gen, K, N, dtype=dtype, s=K ** -0.5)
    a = randn(gen, K, r, dtype=dtype, s=K ** -0.5)
    b = randn(gen, r, N, dtype=dtype, s=0.1)             # B != 0
    bias = randn(gen, N, dtype=dtype, s=0.1)
    dy = randn(gen, M, N, dtype=dtype)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (x, a, b, bias)]
        wt = w.clone().requires_grad_(train_w)
        y = fn(ts[0], wt, ts[1], ts[2], 2.0, ts[3])
        (y.float() * dy.float()).sum().backward()
        return [t.grad for t in ts] + [wt.grad]

    ops.reset_launch_counts()
    got = grads(lambda *t: ops.lora_matmul(*t))
    n = ops.launch_counts()
    assert (n["lora_matmul"], n["lora_matmul_bwd"]) == (2, 1)
    want = grads(lm.lora_matmul_torch)
    tol = dict(atol=1e-1, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    for g, w_ in zip(got[:4], want[:4]):
        assert g.dtype == w_.dtype
        assert torch.allclose(g.float(), w_.float(), **tol), \
            (g.float() - w_.float()).abs().max().item()
    if train_w:
        assert torch.allclose(got[4].float(), (x.float().T @ dy.float()),
                              **tol)
    else:
        assert got[4] is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_backward_on_the_card(gen, dtype, monkeypatch):
    """Gradients through the kernel forward and the recompute backward
    against autograd through the plain tile loop; the backward never runs
    the tile loop."""
    B, S, n_p, Hq, Hkv, D = 2, 45, 5, 14, 2, 64
    q = randn(gen, B, S, Hq, D, dtype=dtype)
    k = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
    v = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
    do = randn(gen, B, S, Hq, D, dtype=dtype)
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"), q_pos])

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts, q_pos=q_pos, kv_pos=kv_pos)
        return out, ts

    want_out, want = grads(fa.flash_attention_torch)
    (want_out.float() * do.float()).sum().backward()
    n0 = fa.launches
    out, got = grads(fa.flash_attention)
    assert fa.launches == n0 + 1

    def no_tile_loop(*a, **k):
        raise AssertionError("the backward ran the plain tile loop")

    monkeypatch.setattr(fa, "online_softmax", no_tile_loop)
    (out.float() * do.float()).sum().backward()
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert g.grad.dtype == dtype
        assert torch.allclose(g.grad.float(), w_.grad.float(), atol=tol,
                              rtol=tol), \
            (g.grad.float() - w_.grad.float()).abs().max().item()


def test_hfsl_round_kernels_match_plain(gen):
    """A reduced f32 vit-edge round (2 clusters, 3 steps, nonzero LoRA b)
    through the kernels and through ``backend="torch"``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.optimizers import adamw

    cfg = get_config("vit-edge").reduced().with_(dtype="float32")
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    state = hfsl.init_hfsl_state(0, cfg, 2, adamw(5e-3), M.init,
                                 device="cuda")
    for layer in state["adapters_c"]["stack"]["g0"]:
        for t in layer["s0"]["lora"].values():
            t["b"] = randn(gen, *t["b"].shape, dtype=t["b"].dtype, s=0.1)
    bank = {"tokens": torch.randint(0, cfg.vocab_size, (3, 2, 4, 24),
                                    generator=gen, device="cuda"),
            "label": torch.randint(0, 5, (3, 2, 4), generator=gen,
                                   device="cuda")}
    rnd = hfsl.make_hfsl_round(cfg, adamw(5e-3), M.classify_loss, steps=3,
                               sync_every=2)
    ops.reset_launch_counts()
    ks, km = rnd(state, bank)
    n = ops.launch_counts()
    # 2 LoRA projections x 2 layers x 2 clusters x 3 steps
    assert n["lora_matmul_bwd"] == 2 * cfg.n_layers * 2 * 3
    assert n["flash_attention"] == cfg.n_layers * 2 * 3
    with ops.backend("torch"):
        ps, pm = rnd(state, bank)
    torch.cuda.synchronize()
    assert torch.allclose(km["loss"], pm["loss"], atol=1e-4, rtol=1e-4)
    for a, b in zip(tree_leaves(ks["adapters_c"]),
                    tree_leaves(ps["adapters_c"])):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4), \
            (a - b).abs().max().item()
