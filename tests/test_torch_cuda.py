"""The port's CUDA kernels against their plain PyTorch versions, on the
card: odd shapes (M, N, K not multiples of any tile, g = 7, D = 64),
windows, non-causal masks, sentinels and prefix slots; the multi-LoRA
kernels with 1 to 8 slots, ranks 1 to 32, and ids all the same, all
different and repeating, and bit for bit against ``lora_matmul`` per row. A CUDA kernel has
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
