"""The port's CUDA kernels against their plain PyTorch versions, on the
card: odd shapes (M, N, K not multiples of any tile, g = 7, D = 64),
windows, non-causal masks, sentinels and prefix slots; one 128 x 128 x 64
tile of the bf16 LoRA path's tensor-core layout (TMA boxes, swizzle,
wgmma descriptors) against ``x.float() @ w.float()``; the LoRA kernels at
prefill size with ragged tails, their padding for TMA (``pad_copies``),
and no fallback when their library is missing; the multi-LoRA
kernels with 1 to 8 slots, ranks 1 to 32, and ids all the same, all
different and repeating, and bit for bit against ``lora_matmul`` per row
(a prefill case at K 3584 included);
the adapter-gradient kernel (both rank-pass routes, M split or not,
bits that repeat across calls and across shapes sharing the tile
counters), the autograd ``lora_matmul`` and the
flash-attention backward on the card against autograd through the plain
versions, and a reduced HFSL round through the kernels against the same
round through the plain versions; the bf16 decode tile's S = Q Kᵀ and P V
fragments (TMA, 128-byte swizzle, ldmatrix, mma.sync) against f32 torch
products, the dense decode kernel at T 1 to 300 (partial last tiles),
prefix banks of 0 to 70 slots, groups 1 to 16, head dims 8 to 256,
windows, rows that see nothing, bits that repeat across launches and
batch sizes, back-to-back shapes on one set of split counters, and its
padding for TMA; a multi-tenant bank's prefix slots read by id (dense and
paged) bit for bit against the slots gathered per row, and launches
through a full TMA map cache; the paged decode kernel against its
plain version (block sizes 4 to 128, sentinel table entries, shared and
per-row prefix slots) and bit for bit against the dense kernel with the
prefix read in place and on the concatenated gathered layout, and a 2-layer paged drain through the kernels against
the plain versions and the dense drain; the selective scan against its
plain version (odd S and Di, state widths 1 to 16, B and C as strided
views, no, per-row and shared initial states), a padded row's state bit
for bit the solo row's, and 2-layer falcon-mamba and speculative drains
through the kernels against the plain versions; the RG-LRU kernel against
its plain version (odd S and W, no, per-row and shared initial states, a
one-row refill, S across the tile and the ring, h_final after a partial
tile, an unaligned row pitch), its two copy routes bit for bit, bits that
repeat across launches and shapes, a padded row's state bit for bit the
solo row's, and a 3-layer
recurrentgemma drain through the kernels (the attention kernels at head
dim 256 included) against the plain versions; the two backward kernels
of the scans against the plain backwards (odd shapes, no, per-row and
shared initial states), their bits across calls, their rerun of the
forward ending in the forward kernel's h_final bit for bit, a padded
row's gradients bit for bit the solo row's, the RG-LRU's saturated gate,
and the autograd Functions on the card against autograd through the
plain versions; a 2-layer falcon-mamba and a 3-layer recurrentgemma HFSL
round through the kernels against the plain versions; the relay's
returned trees, which an in-place step may edit without reaching the
relay or its bank; the moe family's ``moe_apply`` on CUDA against the
CPU, its forward and backward repeating their bits, and a 2-layer f32
granite drain through the kernels against the plain versions, the paged
drain and solo generation; non-causal attention and cross attention (S
queries against T != S keys, whisper's 1500 frames behind 16 prefix
slots) and the non-causal decode against whisper's cross cache, and
2-layer f32 llava and whisper drains, each request with its own modality
row, through the kernels against the plain versions and solo
generation. A CUDA kernel has
no CPU mode, so without a GPU every test here skips; run them on the GPU
machine with ``pytest -m gpu tests/test_torch_cuda.py``. This file imports
no JAX (that machine has none).

Tolerances: bf16 2e-2 as in tests/test_kernels.py; f32 1e-4, because the
kernels sum up to a few thousand terms in another order than cuBLAS.
"""
import ctypes

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lora_bgmv as bg
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import selective_scan as ss

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


# the backward kernels against the plain backwards: each output within
# the dtype's tolerance of its largest value (sums over up to a few
# thousand terms in other orders; bf16 outputs rounded once)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def close_grads(got, want, dtype, names):
    torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = GRAD_TOL[dtype] * max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_wgmma_probe_one_tile(gen):
    """One 128 x 128 x 64 bf16 tile through the tensor-core path's TMA
    boxes, 128-byte swizzle and wgmma descriptors (x K-major, W N-major),
    f32 out, against ``x.float() @ w.float()``: bf16 products are exact in
    f32, so only the order of each 64-term sum differs."""
    lib = _build.load("lora_matmul")
    fn = lib.lora_wgmma_probe_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 4, ctypes.c_int
    x = randn(gen, 128, 64, dtype=torch.bfloat16)
    w = randn(gen, 64, 128, dtype=torch.bfloat16)
    y = torch.full((128, 128), float("nan"), device="cuda")
    _build.check(lib, "lora_matmul", fn(x.data_ptr(), w.data_ptr(),
                                        y.data_ptr(), _build.stream(x)))
    torch.cuda.synchronize()
    want = x.float() @ w.float()
    assert torch.allclose(y, want, atol=1e-4, rtol=1e-4), \
        (y - want).abs().max().item()


@pytest.mark.parametrize("M,K,N,r", [(1, 7, 5, 1), (65, 130, 97, 8),
                                     (8, 3584, 512, 8), (130, 67, 200, 32),
                                     (300, 3584, 1000, 8)])
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


@pytest.mark.parametrize("pattern", ["same", "distinct", "repeat"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_bgmv_seq_kernel_at_prefill_size(gen, pattern, dtype):
    """Three sequences of 300 tokens (a ragged last row tile) at K 3584:
    56 K steps through the ring, so every stage is refilled many times."""
    B, S, K, N, r, n_slots = 3, 300, 3584, 512, 8, 4
    x, w, a, b, bias = _bgmv_operands(gen, (B, S), K, N, r, n_slots, dtype,
                                      True)
    ids = _ids(gen, B, n_slots, pattern)
    n0 = bg.seq_launches
    got = bg.lora_bgmv_seq(x, w, a, b, ids, 2.0, bias)
    assert bg.seq_launches == n0 + 1
    close(got, bg.lora_bgmv_torch(x, w, a, b, ids, 2.0, bias), dtype)


@pytest.mark.parametrize("seq,K", [(None, 200), (37, 200), (300, 3584)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lora_bgmv_rows_equal_lora_matmul_bit_for_bit(gen, seq, K, dtype):
    """Each row (sequence) equals ``lora_matmul`` run alone with its own
    adapter: the same bits, whatever batch it came in."""
    n, N, r, n_slots = 9, 131, 8, 4
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_copies_only_at_unaligned_bf16_shapes(gen, dtype):
    """TMA takes bf16 K and N in multiples of 8: aligned shapes (every
    model's) launch with no copy, unaligned ones pad; f32 never pads."""
    for K, N, copies in ((256, 136, False), (130, 131, True)):
        x, w, a, b, bias = _bgmv_operands(gen, (2, 20), K, N, 8, 3, dtype,
                                          True)
        ids = _ids(gen, 2, 3, "distinct")
        n0 = lm.pad_copies
        lm.lora_matmul(x[0], w, a[0], b[0], 2.0, bias)
        bg.lora_bgmv_rows(x[0], w, a, b, _ids(gen, 20, 3, "repeat"), 2.0,
                          bias)
        bg.lora_bgmv_seq(x, w, a, b, ids, 2.0, bias)
        padded = lm.pad_copies - n0
        assert (padded > 0) == (copies and dtype == torch.bfloat16), padded


def test_bf16_lora_raises_without_its_kernel(gen, monkeypatch):
    """No fallback: a library that is not there, or a launch the C entry
    point refuses, raises; nothing takes the CUDA-core tile or the plain
    version instead."""
    x, w, a, b, bias = _bgmv_operands(gen, (2, 16), 64, 32, 4, 2,
                                      torch.bfloat16, True)
    ids = _ids(gen, 2, 2, "distinct")
    lib = _build.bind("lora_matmul", lm._ARGS)
    u = torch.empty((16, 4), device="cuda")
    y = torch.empty((16, 32), dtype=torch.bfloat16, device="cuda")
    err = lib.lora_matmul_launch(                   # K 63: not for TMA
        x[0].data_ptr(), w.data_ptr(), a[0].data_ptr(), b[0].data_ptr(),
        None, u.data_ptr(), y.data_ptr(), 16, 32, 63, 4, 1.0, 1,
        _build.stream(x))
    with pytest.raises(RuntimeError, match="lora_matmul kernel launch"):
        _build.check(lib, "lora_matmul", err)

    def missing(name, argtypes):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "bind", missing)
    n = ops.launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed for lora_matmul"):
        lm.lora_matmul(x[0], w, a[0], b[0], 2.0, bias)
    with pytest.raises(RuntimeError, match="nvcc failed for lora_bgmv_rows"):
        bg.lora_bgmv_rows(x[0], w, a, b, _ids(gen, 16, 2, "repeat"), 2.0)
    with pytest.raises(RuntimeError, match="nvcc failed for lora_bgmv_seq"):
        bg.lora_bgmv_seq(x, w, a, b, ids, 2.0, bias)
    assert ops.launch_counts() == n


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


def _tile(D):
    """(query rows a block, keys a tile) of the bf16 attention instance
    for head dim D."""
    fn = _build.bind("flash_attention", fa._ARGS).attn_wgmma_block_rows
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(D), 64


def _attn_probe(q, k, v, pm, D, out):
    lib = _build.bind("flash_attention", fa._ARGS)
    fn = lib.attn_wgmma_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    _build.check(lib, "flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if pm is None else pm.data_ptr(), D, out.data_ptr(),
        _build.stream(q)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [8, 64, 128, 200, 256])
def test_attn_wgmma_probe_qk_tile(gen, D):
    """S = Q Kᵀ for one tile (a block's query rows and a tile's keys)
    through the attention tile's TMA boxes, 128-byte swizzle and wgmma
    descriptors (Q K-major as A, the K tile K-major as B with no
    transpose), f32 out, against ``q.float() @ k.float().T``: bf16
    products are exact in f32, so only the order of each D-term sum
    differs."""
    rows, n = _tile(D)
    q = randn(gen, rows, D, dtype=torch.bfloat16)
    k = randn(gen, n, D, dtype=torch.bfloat16)
    s = torch.full((rows, n), float("nan"), device="cuda")
    _attn_probe(q, k, k, None, D, s)
    want = q.float() @ k.float().T
    assert torch.allclose(s, want, atol=1e-4, rtol=1e-4), \
        (s - want).abs().max().item()


@pytest.mark.parametrize("D", [8, 64, 128, 200, 256])
def test_attn_wgmma_probe_pv_tile(gen, D):
    """O = P V for one tile: P (a block's query rows x a tile's keys,
    bf16) loaded into the register A fragment exactly as the kernel packs
    it from S's accumulator, V (keys x D) read where it lies as the N-major
    B operand (the transpose flag), f32 out, against
    ``p.float() @ v.float()``."""
    rows, n = _tile(D)
    q = randn(gen, rows, D, dtype=torch.bfloat16)
    v = randn(gen, n, D, dtype=torch.bfloat16)
    pm = torch.rand((rows, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    o = torch.full((rows, D), float("nan"), device="cuda")
    _attn_probe(q, v, v, pm, D, o)
    want = pm.float() @ v.float()
    assert torch.allclose(o, want, atol=1e-4, rtol=1e-4), \
        (o - want).abs().max().item()


# (B, S, n_prefix, Hq, Hkv, D): S 129 and 200 leave partial q tiles, T =
# n_prefix + S is rarely a multiple of the 64-key tile, groups 1 to 10; T
# 515 and 528 fold more 64-key tiles than the head-dim-64 instance's ring
# has stages (4), so its stages are refilled
@pytest.mark.parametrize("case", [(1, 1, 0, 1, 1, 8), (2, 37, 5, 14, 2, 64),
                                  (3, 70, 16, 28, 4, 128),
                                  (2, 70, 16, 10, 1, 256),
                                  (1, 37, 3, 4, 2, 200),
                                  (2, 129, 0, 7, 1, 64),
                                  (1, 200, 3, 10, 1, 256),
                                  (2, 129, 16, 28, 4, 128),
                                  (1, 200, 0, 8, 8, 8),
                                  (2, 512, 16, 12, 12, 64),
                                  (1, 512, 3, 8, 8, 8)])
@pytest.mark.parametrize("window,causal", [(0, True), (16, True),
                                           (100, True), (0, False)])
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


@pytest.mark.parametrize("shift", [40, 300])
@pytest.mark.parametrize("window,causal", [(0, True), (16, True),
                                           (8, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_rows_that_see_nothing(gen, shift, window, causal,
                                               dtype):
    """Rows whose q_pos sees no key average every key uniformly, as the
    plain version's -1e30 masking does. Causal, shift 40: the first 40 rows
    sit at negative positions before every key (no prefix), beside rows
    that see keys in the same q tile; shift 300: every row does, so no
    tile is visible to any row of the call. Non-causal with window 8: the
    rows 8 or more positions past every key."""
    B, S, Hq, Hkv, D = 2, 200, 7, 1, 128
    q = randn(gen, B, S, Hq, D, dtype=dtype)
    k = randn(gen, B, S, Hkv, D, dtype=dtype)
    v = randn(gen, B, S, Hkv, D, dtype=dtype)
    kv_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    if causal:
        q_pos = kv_pos - shift
    else:
        q_pos = kv_pos + (S if shift == 300 else shift)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, causal=causal)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_torch(q, k, v, **kw)
    close(got, want, dtype)
    blind = ~ref.visibility_mask(q_pos, kv_pos, window=window,
                                 causal=causal).any(-1)
    assert blind.any()
    uniform = v.float().mean(1, keepdim=True).expand(B, S, Hkv, D)
    uniform = uniform.repeat_interleave(Hq // Hkv, 2)
    close(got[:, blind].float(), uniform[:, blind], torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bits_repeat_and_rows_stand_alone(gen, D):
    """Two launches give the same bits, and each sequence of a batch of 8
    gives the bits of the same sequence run alone (blocks share nothing,
    and the tiles a block visits depend on positions only)."""
    B, S, n_p, Hq, Hkv = 8, 200, 16, 14, 2
    q = randn(gen, B, S, Hq, D, dtype=torch.bfloat16)
    k = randn(gen, B, n_p + S, Hkv, D, dtype=torch.bfloat16)
    v = randn(gen, B, n_p + S, Hkv, D, dtype=torch.bfloat16)
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"), q_pos])
    kv_pos[-30:] = 10 ** 9
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=100)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for i in range(B):
        one = fa.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
        torch.cuda.synchronize()
        assert torch.equal(one[0], got[i]), i


@pytest.mark.parametrize("D,copies", [(36, True), (100, True), (200, False),
                                      (64, False)])
def test_flash_attention_pads_only_what_tma_refuses(gen, D, copies):
    """A bf16 head dim that is not a multiple of 8 takes one counted
    zero-padding copy and agrees with the plain version; aligned head dims
    launch with none; a misaligned base is copied too. f32 never pads."""
    B, S, n_p, Hq, Hkv = 2, 70, 3, 4, 2
    kw = dict(q_pos=torch.arange(S, dtype=torch.int32, device="cuda"),
              kv_pos=torch.arange(-n_p, S, dtype=torch.int32,
                                  device="cuda"))
    for dtype in DTYPES:
        q = randn(gen, B, S, Hq, D, dtype=dtype)
        k = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
        v = randn(gen, B, n_p + S, Hkv, D, dtype=dtype)
        n0 = fa.pad_copies
        got = fa.flash_attention(q, k, v, **kw)
        assert fa.pad_copies - n0 == int(copies and dtype == torch.bfloat16)
        close(got, fa.flash_attention_torch(q, k, v, **kw), dtype)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    qs = buf[1:].view(q.shape)
    qs.copy_(q)
    n0 = fa.pad_copies
    got = fa.flash_attention(qs, k, v, **kw)
    assert fa.pad_copies == n0 + 1
    close(got, fa.flash_attention_torch(q, k, v, **kw), torch.bfloat16)


def _decode_probe(q, k, v, pm, D, out):
    lib = _build.bind("flash_decode", fd._ARGS)
    fn = lib.decode_split_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    mk = fd._map(lib, "flash_decode", k, 1, 64, 1, 64)
    mv = fd._map(lib, "flash_decode", v, 1, 64, 1, 64)
    _build.check(lib, "flash_decode", fn(
        mk, mv, q.data_ptr(), None if pm is None else pm.data_ptr(), D,
        out.data_ptr(), _build.stream(q)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [8, 64, 128, 160, 256])
def test_decode_split_probe_qk_tile(gen, D):
    """S = Q Kᵀ for one decode tile (16 query heads, 64 keys) through the
    bf16 decode tile's TMA boxes, 128-byte swizzle and ldmatrix addresses
    (Q and K row-major, each warp 16 keys, mma.sync m16n8k16), f32 out,
    against ``q.float() @ k.float().T``: bf16 products are exact in f32,
    so only the order of each D-term sum differs."""
    q = randn(gen, 16, D, dtype=torch.bfloat16)
    k = randn(gen, 64, D, dtype=torch.bfloat16)
    s = torch.full((16, 64), float("nan"), device="cuda")
    _decode_probe(q, k, k, None, D, s)
    want = q.float() @ k.float().T
    assert torch.allclose(s, want, atol=1e-4, rtol=1e-4), \
        (s - want).abs().max().item()


@pytest.mark.parametrize("D", [8, 64, 128, 160, 256])
def test_decode_split_probe_pv_tile(gen, D):
    """O = P V for one decode tile: P (16 x 64, bf16) loaded into the A
    fragment exactly as the kernel packs it from S's accumulator, V (64 x
    D) through ldmatrix.trans of the swizzled tile, the four warps' keys
    summed in order, f32 out, against ``p.float() @ v.float()``."""
    q = randn(gen, 16, D, dtype=torch.bfloat16)
    v = randn(gen, 64, D, dtype=torch.bfloat16)
    pm = torch.rand((16, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    o = torch.full((16, D), float("nan"), device="cuda")
    _decode_probe(q, v, v, pm, D, o)
    want = pm.float() @ v.float()
    assert torch.allclose(o, want, atol=1e-4, rtol=1e-4), \
        (o - want).abs().max().item()


def _decode_operands(gen, B, T, n_p, Hq, Hkv, D, dtype, per_row=False):
    """q, k, v; ragged q_pos; kv_pos with the +1e9 sentinel past each
    row's position; a prefix bank (shared or per row) or None."""
    q = randn(gen, B, Hq, D, dtype=dtype)
    k = randn(gen, B, T, Hkv, D, dtype=dtype)
    v = randn(gen, B, T, Hkv, D, dtype=dtype)
    qp = torch.randint(0, T, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    kp = torch.where(slots <= qp[:, None], slots,
                     torch.full_like(slots, 10 ** 9))
    pshape = (B, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
    pk = randn(gen, *pshape, dtype=dtype) if n_p else None
    pv = randn(gen, *pshape, dtype=dtype) if n_p else None
    return q, k, v, qp, kp, pk, pv


# (B, T, n_prefix, Hq, Hkv, D): T 1, 63, 64, 65 and 300 (a partial last
# tile, exactly one tile, one key past it); prefix 0, 3, 16 and 70 (in
# tiles of their own, 70 in two); groups 1, 7, 10 and 16; head dims 8,
# 64, 128, 160 and 256 (all three bf16 instances, D not a multiple of 64)
@pytest.mark.parametrize("case", [(1, 1, 0, 2, 2, 16), (3, 45, 4, 7, 1, 64),
                                  (8, 300, 16, 28, 4, 128),
                                  (2, 33, 0, 32, 2, 128),
                                  (8, 300, 16, 10, 1, 256),
                                  (2, 45, 0, 6, 2, 160),
                                  (2, 1, 0, 1, 1, 64),
                                  (3, 63, 3, 7, 1, 128),
                                  (2, 64, 70, 16, 1, 64),
                                  (2, 65, 16, 10, 1, 256),
                                  (2, 300, 70, 16, 2, 8),
                                  (1, 300, 3, 7, 1, 160),
                                  (4, 65, 0, 28, 4, 128),
                                  (2, 63, 16, 16, 1, 256)])
@pytest.mark.parametrize("window", [0, 8, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_kernel(gen, case, window, dtype):
    B, T, n_p, Hq, Hkv, D = case
    q, k, v, qp, kp, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                               dtype)
    n0 = fd.launches
    got = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                           prefix_v=pv, window=window)
    assert fd.launches == n0 + 1
    with ops.backend("torch"):
        want = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                                prefix_v=pv, window=window)
    assert fd.launches == n0 + 1
    close(got, want, dtype)


@pytest.mark.parametrize("n_p", [0, 3])
@pytest.mark.parametrize("window,causal", [(0, True), (8, True),
                                           (8, False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_rows_that_see_nothing(gen, n_p, window, causal,
                                            dtype):
    """Rows whose q_pos sees no slot average every key uniformly (the
    prefix slots and the cache's slots), as the plain version's -1e30
    masking does, beside rows that see keys in the same call. Causal: rows
    0-2 sit at negative positions before every slot; non-causal with
    window 8: rows 0-2 sit 8 or more positions past every slot. Without a
    prefix those rows see nothing at all, and every split of theirs folds
    every tile; with one, they see the prefix only."""
    B, T, Hq, Hkv, D = 6, 300, 7, 1, 128
    q, k, v, _, _, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                             dtype)
    kp = torch.arange(T, dtype=torch.int32, device="cuda")[None] \
        .expand(B, T).contiguous()
    qp = torch.tensor([-5, -1, -300, 10, 150, 299], dtype=torch.int32,
                      device="cuda")
    if not causal:
        qp = torch.where(qp < 0, T + 7 - qp, qp)
    kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv, window=window,
              causal=causal)
    got = ops.flash_decode(q, k, v, **kw)
    with ops.backend("torch"):
        want = ops.flash_decode(q, k, v, **kw)
    close(got, want, dtype)
    if n_p == 0:
        uniform = v[:3].float().mean(1).repeat_interleave(Hq // Hkv, 1)
        close(got[:3].float(), uniform, torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_decode_bits_repeat_and_rows_stand_alone(gen, D):
    """Two launches give the same bits, and each row of a batch of 8 gives
    the bits of the same row run alone (the splits depend on the head dim
    and the key count only; the combine sums the splits in order)."""
    B, T, n_p, Hq, Hkv = 8, 700, 16, 14, 2
    q, k, v, qp, kp, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                               torch.bfloat16, per_row=True)
    kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv, window=500)
    got = ops.flash_decode(q, k, v, **kw)
    again = ops.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for i in range(B):
        one = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                               q_pos=qp[i:i + 1], kv_pos=kp[i:i + 1],
                               prefix_k=pk[i:i + 1], prefix_v=pv[i:i + 1],
                               window=500)
        torch.cuda.synchronize()
        assert torch.equal(one[0], got[i]), i


def test_flash_decode_back_to_back_shapes(gen):
    """Calls of different shapes in a row share the split counters (each
    combine resets its own): each is right, and the first shape called
    again gives its first bits."""
    shapes = [(8, 1000, 16, 28, 4, 128), (3, 130, 0, 10, 1, 256),
              (16, 64, 3, 7, 1, 64), (8, 1000, 16, 28, 4, 128)]
    outs = []
    for B, T, n_p, Hq, Hkv, D in shapes:
        g2 = torch.Generator(device="cuda").manual_seed(T)
        q, k, v, qp, kp, pk, pv = _decode_operands(
            g2, B, T, n_p, Hq, Hkv, D, torch.bfloat16)
        kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv)
        got = ops.flash_decode(q, k, v, **kw)
        with ops.backend("torch"):
            close(got, ops.flash_decode(q, k, v, **kw), torch.bfloat16)
        outs.append(got)
    assert torch.equal(outs[0], outs[-1])


@pytest.mark.parametrize("D,copies", [(36, True), (100, True), (200, False),
                                      (64, False)])
def test_flash_decode_pads_only_what_tma_refuses(gen, D, copies):
    """A bf16 head dim that is not a multiple of 8 takes one counted
    zero-padding copy, dense and paged, and agrees with the plain version;
    aligned head dims launch with none. f32 never pads."""
    for dtype in DTYPES:
        q, k, v, qp, kp, pk, pv = _decode_operands(gen, 2, 70, 3, 4, 2, D,
                                                   dtype)
        kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv)
        n0 = fd.pad_copies
        got = ops.flash_decode(q, k, v, **kw)
        assert fd.pad_copies - n0 == int(copies and dtype == torch.bfloat16)
        with ops.backend("torch"):
            close(got, ops.flash_decode(q, k, v, **kw), dtype)
        if D > fd.PAGED_DMAX:
            continue
        q, kpool, vpool, table, qp, pk, pv = _paged_operands(
            gen, 2, 5, 16, 3, 4, 2, D, dtype, False)
        kw = dict(q_pos=qp, prefix_k=pk, prefix_v=pv)
        n0 = fd.pad_copies
        got = ops.flash_decode_paged(q, kpool, vpool, table, **kw)
        assert fd.pad_copies - n0 == int(copies and dtype == torch.bfloat16)
        with ops.backend("torch"):
            close(got, ops.flash_decode_paged(q, kpool, vpool, table, **kw),
                  dtype)


@pytest.mark.parametrize("case", [(1, 1, 0, 2, 2, 16), (3, 45, 4, 7, 1, 64),
                                  (8, 300, 16, 28, 4, 128),
                                  (8, 300, 16, 10, 1, 256),
                                  (2, 45, 0, 6, 2, 160),
                                  (2, 64, 70, 16, 1, 64)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_lse_matches_plain(gen, case, window, dtype):
    """The partial mode (``return_lse``): the output and the (B, Hq) f32
    log-sum-exp against the plain version's; the output is the bits of
    the call without it (every row here sees a key)."""
    B, T, n_p, Hq, Hkv, D = case
    q, k, v, qp, kp, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                               dtype)
    kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv, window=window)
    n0 = fd.launches
    out, lse = ops.flash_decode(q, k, v, return_lse=True, **kw)
    assert fd.launches == n0 + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq)
    with ops.backend("torch"):
        w_out, w_lse = ops.flash_decode(q, k, v, return_lse=True, **kw)
    close(out, w_out, dtype)
    close(lse, w_lse, torch.float32 if dtype == torch.float32 else dtype)
    plain = ops.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_two_shards_combine_to_the_whole(gen, D, dtype):
    """A cache cut in two halves (the prefix bank with the first, as the
    `data` rank at coordinate 0 takes it): the halves' partials merged by
    ``flash_decode.combine`` give the whole call; rows whose q_pos lies
    in the first half see nothing of the second, whose partial is then
    exactly ``-inf`` and 0."""
    B, T, n_p, Hq, Hkv = 4, 1000, 16, 28, 4
    q, k, v, qp, kp, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                               dtype)
    qp = torch.tensor([3, 400, 700, 999], dtype=torch.int32, device="cuda")
    slots = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    kp = torch.where(slots <= qp[:, None], slots,
                     torch.full_like(slots, 10 ** 9)).contiguous()
    whole = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                             prefix_v=pv)
    h = T // 2
    a = ops.flash_decode(q, k[:, :h].contiguous(), v[:, :h].contiguous(),
                         q_pos=qp, kv_pos=kp[:, :h].contiguous(),
                         prefix_k=pk, prefix_v=pv, return_lse=True)
    b = ops.flash_decode(q, k[:, h:].contiguous(), v[:, h:].contiguous(),
                         q_pos=qp, kv_pos=kp[:, h:].contiguous(),
                         return_lse=True)
    torch.cuda.synchronize()
    assert torch.isneginf(b[1][:2]).all() and (b[0][:2] == 0).all()
    o, _ = fd.combine([a[0], b[0]], [a[1], b[1]])
    close(o, whole, dtype)
    with ops.backend("torch"):
        pa = ops.flash_decode(q, k[:, :h], v[:, :h], q_pos=qp,
                              kv_pos=kp[:, :h], prefix_k=pk, prefix_v=pv,
                              return_lse=True)
    close(a[1], pa[1], torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.parametrize("n_p", [0, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_lse_rows_that_see_nothing(gen, n_p, dtype):
    """In the partial mode a row that sees no key gives lse = -inf and a
    zero output (not the uniform average), beside rows that see keys; a
    row that sees only the prefix bank is not blind."""
    B, T, Hq, Hkv, D = 6, 300, 7, 1, 128
    q, k, v, _, _, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                             dtype)
    kp = torch.arange(T, dtype=torch.int32, device="cuda")[None] \
        .expand(B, T).contiguous()
    qp = torch.tensor([-5, -1, -300, 10, 150, 299], dtype=torch.int32,
                      device="cuda")
    kw = dict(q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv)
    out, lse = ops.flash_decode(q, k, v, return_lse=True, **kw)
    with ops.backend("torch"):
        w_out, w_lse = ops.flash_decode(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    close(out, w_out, dtype)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
    assert torch.isneginf(lse[:3]).all() == (n_p == 0)
    if n_p == 0:
        assert (out[:3] == 0).all()
    fin = torch.isfinite(w_lse)
    close(lse[fin], w_lse[fin], torch.float32 if dtype == torch.float32
          else dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_bank_by_id_gives_the_bits_of_gathered_slots(gen,
                                                                  dtype):
    """A multi-tenant bank's stacked prefix slots (n_slots, n_p, Hkv, D)
    read by the rows' ids (repeating, some slots unread) give the bits of
    the same slots gathered per row, dense and paged, one launch a call;
    agree with the plain version; and in bf16 a second call with other
    ids encodes no TMA map (the bank's maps do not depend on the ids)."""
    B, T, n_p, Hq, Hkv, D, n_slots = 6, 200, 16, 14, 2, 128, 5
    q, k, v, qp, kp, _, _ = _decode_operands(gen, B, T, 0, Hq, Hkv, D, dtype)
    bk = randn(gen, n_slots, n_p, Hkv, D, dtype=dtype)
    bv = randn(gen, n_slots, n_p, Hkv, D, dtype=dtype)
    ids = torch.tensor([4, 0, 4, 2, 0, 4], dtype=torch.int32, device="cuda")
    n0 = fd.launches
    got = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=bk,
                           prefix_v=bv, prefix_ids=ids)
    assert fd.launches == n0 + 1
    rows = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp,
                            prefix_k=bk[ids.long()], prefix_v=bv[ids.long()])
    torch.cuda.synchronize()
    assert torch.equal(got, rows), (got.float() - rows.float()).abs().max()
    with ops.backend("torch"):
        close(got, ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp,
                                    prefix_k=bk, prefix_v=bv,
                                    prefix_ids=ids), dtype)
    other = ids.flip(0).contiguous()
    e0 = fd.map_encodes
    ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=bk, prefix_v=bv,
                     prefix_ids=other)
    assert fd.map_encodes == e0

    q, kpool, vpool, table, qp, _, _ = _paged_operands(
        gen, B, 12, 16, 0, Hq, Hkv, D, dtype, False)
    n0 = fd.paged_launches
    got = ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                 prefix_k=bk, prefix_v=bv, prefix_ids=ids)
    assert fd.paged_launches == n0 + 1
    rows = ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                  prefix_k=bk[ids.long()],
                                  prefix_v=bv[ids.long()])
    torch.cuda.synchronize()
    assert torch.equal(got, rows), (got.float() - rows.float()).abs().max()
    with ops.backend("torch"):
        close(got, ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                          prefix_k=bk, prefix_v=bv,
                                          prefix_ids=ids), dtype)


def test_a_full_map_cache_frees_no_map_of_a_launch(gen):
    """The TMA map cache is cleared when it holds 1,024 maps. Filled to
    1,023, a dense call with a prefix bank (4 maps) and then a paged call
    with one (4 maps) clear it in the middle of their lookups: the maps
    already looked up must stay intact through the launch, and both calls
    agree with their plain versions."""
    B, T, n_p, Hq, Hkv, D = 4, 300, 16, 14, 2, 128
    q, k, v, qp, kp, pk, pv = _decode_operands(gen, B, T, n_p, Hq, Hkv, D,
                                               torch.bfloat16)
    fd._MAPS.clear()
    for i in range(1023):
        fd._MAPS[("filler", i)] = ctypes.create_string_buffer(128)
    e0 = fd.map_encodes
    got = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk,
                           prefix_v=pv)
    assert fd.map_encodes - e0 == 4 and len(fd._MAPS) < 1023
    with ops.backend("torch"):
        close(got, ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp,
                                    prefix_k=pk, prefix_v=pv),
              torch.bfloat16)
    q, kpool, vpool, table, qp, pk, pv = _paged_operands(
        gen, B, 20, 16, n_p, Hq, Hkv, D, torch.bfloat16, True)
    for i in range(1023 - len(fd._MAPS)):
        fd._MAPS[("filler", -i)] = ctypes.create_string_buffer(128)
    got = ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                 prefix_k=pk, prefix_v=pv)
    assert len(fd._MAPS) < 1023
    with ops.backend("torch"):
        close(got, ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                          prefix_k=pk, prefix_v=pv),
              torch.bfloat16)
    fd._MAPS.clear()


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
    q = randn(gen, 1, 2, 1, 320, dtype=torch.float32)
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


@pytest.mark.parametrize("M,K,N,r", [
    (1, 7, 5, 1), (65, 130, 97, 8), (1024, 3584, 512, 8), (130, 67, 200, 32),
    (0, 16, 8, 4),
    # the HFSL round's q shape (2 splits of 512 rows), M not a multiple of
    # a split, M below one split, no rows at the round's widths, ranks 1
    # and 32 and a rank between the buckets at the v shape (bf16 r 32 and
    # the odd widths above take the CUDA-core rank pass, the rest bf16 the
    # tensor-core one)
    (1024, 3584, 3584, 8), (1000, 3584, 512, 8), (20, 3584, 3584, 8),
    (0, 3584, 512, 8), (1024, 3584, 512, 1), (1024, 3584, 512, 32),
    (777, 3584, 512, 12)])
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
    again = lm.lora_matmul_bwd(x, dy, a, b, 2.0)       # no float atomics
    assert torch.equal(again[0], da) and torch.equal(again[1], db)


def test_lora_matmul_bwd_back_to_back_shapes(gen):
    """Calls of three shapes, each with its own split count, alternate on
    one stream and so on one set of tile counters: each call gives the
    bits of its shape's first call (the last block of a tile resets its
    counter)."""
    cases = []
    for M, K, N, r in ((1024, 3584, 3584, 8), (1024, 3584, 512, 8),
                       (300, 130, 97, 32)):
        x, dy = randn(gen, M, K, dtype=torch.bfloat16), \
            randn(gen, M, N, dtype=torch.bfloat16)
        a = randn(gen, K, r, dtype=torch.bfloat16, s=K ** -0.5)
        b = randn(gen, r, N, dtype=torch.bfloat16, s=0.1)
        cases.append(((x, dy, a, b), lm.lora_matmul_bwd(x, dy, a, b, 2.0)))
    assert len({lm.bwd_plan(*c[0][0].shape, c[0][1].shape[1],
                            c[0][2].shape[1])["splits"]
                for c in cases}) == 3
    for _ in range(3):
        for ins, first in cases:
            got = lm.lora_matmul_bwd(*ins, 2.0)
            assert torch.equal(got[0], first[0])
            assert torch.equal(got[1], first[1])
    cnt = lm._counters(cases[0][0][0], 1)
    torch.cuda.synchronize()
    assert int(cnt.abs().sum()) == 0


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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_scan_family_round_kernels_match_plain(gen, arch):
    """A reduced f32 falcon-mamba (2 layers) and recurrentgemma (3 layers:
    two rglru and one attention sub-layer) round, 2 clusters x 3 steps of
    sgd with momentum, through the kernels (each scan's forward and
    backward once a layer a step, no remat in classify_loss) and through
    ``backend="torch"``."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.optimizers import sgd

    cfg = get_config(arch).reduced().with_(dtype="float32", vocab_size=512)
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    opt = sgd(0.1, momentum=0.9)
    state = hfsl.init_hfsl_state(0, cfg, 2, opt, M.init, device="cuda")
    for leaf in tree_leaves(state["adapters_c"]):
        leaf.copy_(randn(gen, *leaf.shape, dtype=leaf.dtype, s=0.1))
    bank = {"tokens": torch.randint(0, cfg.vocab_size, (3, 2, 4, 24),
                                    generator=gen, device="cuda"),
            "label": torch.randint(0, 5, (3, 2, 4), generator=gen,
                                   device="cuda")}
    rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=3,
                               sync_every=2)
    ops.reset_launch_counts()
    ks, km = rnd(state, bank)
    n = ops.launch_counts()
    scan = "selective_scan" if cfg.family == "ssm" else "rglru_scan"
    n_rec = cfg.n_layers if cfg.family == "ssm" else 2
    assert n[scan] == n[scan + "_bwd"] == n_rec * 2 * 3, n
    with ops.backend("torch"):
        ps, pm = rnd(state, bank)
    torch.cuda.synchronize()
    assert torch.allclose(km["loss"], pm["loss"], atol=1e-4, rtol=1e-4)
    for a, b in zip(tree_leaves(ks["adapters_c"]),
                    tree_leaves(ps["adapters_c"])):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4), \
            (a - b).abs().max().item()


def _paged_operands(gen, B, maxb, bs, n_p, Hq, Hkv, D, dtype, per_row):
    """A random pool with per-row tables of distinct blocks, each row's
    entries past its q_pos set to the n_blocks sentinel, ragged q_pos."""
    nb = B * maxb + 3
    q = randn(gen, B, Hq, D, dtype=dtype)
    kp = randn(gen, nb, bs, Hkv, D, dtype=dtype)
    vp = randn(gen, nb, bs, Hkv, D, dtype=dtype)
    perm = torch.randperm(nb, generator=gen, device="cuda")
    table = perm[:B * maxb].reshape(B, maxb).to(torch.int32)
    qp = torch.randint(0, maxb * bs, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    cols = torch.arange(maxb, device="cuda")[None]
    table = torch.where(cols <= qp[:, None] // bs, table,
                        torch.full_like(table, nb))
    pshape = (B, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
    pk = randn(gen, *pshape, dtype=dtype) if n_p else None
    pv = randn(gen, *pshape, dtype=dtype) if n_p else None
    return q, kp, vp, table, qp, pk, pv


# (B, maxb, bs, n_prefix, Hq, Hkv, D)
@pytest.mark.parametrize("case", [(1, 2, 16, 0, 1, 1, 8),
                                  (2, 4, 8, 4, 4, 2, 32),
                                  (3, 5, 4, 16, 7, 1, 64),
                                  (8, 64, 16, 16, 28, 4, 128),
                                  (2, 3, 128, 3, 7, 1, 128),
                                  (3, 20, 8, 70, 10, 2, 64),
                                  (2, 40, 4, 0, 16, 1, 64)])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_paged_kernel(gen, case, per_row, dtype):
    B, maxb, bs, n_p, Hq, Hkv, D = case
    q, kp, vp, table, qp, pk, pv = _paged_operands(
        gen, B, maxb, bs, n_p, Hq, Hkv, D, dtype, per_row)
    n0 = fd.paged_launches
    got = ops.flash_decode_paged(q, kp, vp, table, q_pos=qp, prefix_k=pk,
                                 prefix_v=pv)
    assert fd.paged_launches == n0 + 1
    with ops.backend("torch"):
        want = ops.flash_decode_paged(q, kp, vp, table, q_pos=qp,
                                      prefix_k=pk, prefix_v=pv)
    assert fd.paged_launches == n0 + 1
    close(got, want, dtype)
    # the same keys through the dense kernel: the same bits
    k, v = fd.gather_pool(kp, vp, table)
    slots = torch.arange(k.shape[1], dtype=torch.int32, device="cuda")
    n1 = fd.launches
    dense = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=slots, prefix_k=pk,
                             prefix_v=pv)
    assert fd.launches == n1 + 1
    torch.cuda.synchronize()
    assert torch.equal(got, dense), (got.float() - dense.float()).abs().max()


# (B, maxb, bs, n_prefix, Hq, Hkv, D): block sizes 4, 16 and 128 (a tile
# of 16 boxes, of 4, half a block); prefix 0, 3, 16 and 70
@pytest.mark.parametrize("case", [(4, 40, 4, 3, 7, 1, 64),
                                  (8, 64, 16, 16, 28, 4, 128),
                                  (3, 4, 128, 70, 10, 2, 128),
                                  (5, 10, 16, 0, 16, 1, 64)])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_decode_three_ways_give_the_same_bits(gen, case, per_row):
    """bf16: the paged kernel, the dense kernel with the prefix bank read
    in place, and the dense kernel on ``with_prefix``'s concatenation of
    the bank and the gathered pool (no bank: its leading slots at -1 are
    cut into tiles as the bank's are) give the same bits; each is one
    launch."""
    B, maxb, bs, n_p, Hq, Hkv, D = case
    q, kp, vp, table, qp, pk, pv = _paged_operands(
        gen, B, maxb, bs, n_p, Hq, Hkv, D, torch.bfloat16, per_row)
    n0, n1 = fd.paged_launches, fd.launches
    paged = fd.flash_decode_paged(q, kp, vp, table, q_pos=qp, prefix_k=pk,
                                  prefix_v=pv)
    k, v = fd.gather_pool(kp, vp, table)
    slots = torch.arange(k.shape[1], dtype=torch.int32,
                         device="cuda")[None].expand(B, -1).contiguous()
    in_place = fd.flash_decode(q, k, v, q_pos=qp, kv_pos=slots, prefix_k=pk,
                               prefix_v=pv)
    kc, vc, kpc = fd.with_prefix(k, v, slots, pk, pv)
    concat = fd.flash_decode(q, kc.contiguous(), vc.contiguous(), q_pos=qp,
                             kv_pos=kpc.contiguous())
    torch.cuda.synchronize()
    assert (fd.paged_launches - n0, fd.launches - n1) == (1, 2)
    assert torch.equal(paged, in_place), \
        (paged.float() - in_place.float()).abs().max()
    assert torch.equal(paged, concat), \
        (paged.float() - concat.float()).abs().max()
    want = fd.flash_decode_paged(q, kp, vp, table, q_pos=qp, prefix_k=pk,
                                 prefix_v=pv, backend="torch")
    close(paged, want, torch.bfloat16)


def test_paged_drain_on_the_card(gen):
    """A 2-layer f32 qwen2-7b paged drain with prefix sharing through the
    kernels equals the same drain through the plain versions and the
    dense drain, and launches the paged kernel, never the dense one."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.paged import PagedSpec
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b").reduced().with_(dtype="float32")
    params = M.init(cfg, 0, device="cuda")
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 32)
    reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]),
             g) for n, g in ((5, 4), (9, 2), (17, 6), (3, 3), (11, 5))]

    def drain(paged):
        eng = DecodeEngine(cfg, slots=2, paged=paged, device="cuda")
        uids = [eng.submit(p, g) for p, g in reqs]
        comps, stats = eng.run(params)
        by = {c.uid: c.tokens for c in comps}
        return [by[u] for u in uids], stats

    spec = PagedSpec(n_blocks=64, block_size=8, share_prefix=True)
    ops.reset_launch_counts()
    kern, st = drain(spec)
    n = ops.launch_counts()
    assert n["flash_decode_paged"] > 0 and n["flash_decode"] == 0
    assert st.prefix_hits > 0
    with ops.backend("torch"):
        plain, _ = drain(spec)
    dense, _ = drain(None)
    for a, b, c in zip(kern, plain, dense):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _scan_operands(gen, B, S, Di, N, dtype, h0_kind):
    """x, dt, A, B, C, D, h0 as the ssm layer makes them: B and C are
    column views of one x_proj-shaped output."""
    x = randn(gen, B, S, Di, dtype=dtype, s=0.5)
    dt = (torch.nn.functional.softplus(randn(gen, B, S, Di,
                                             dtype=torch.float32))
          * 0.1).to(dtype)
    A = -torch.exp(randn(gen, Di, N, dtype=torch.float32, s=0.3))
    xdbc = randn(gen, B, S, 5 + 2 * N, dtype=dtype, s=0.5)
    Bm, C = xdbc[..., 5:5 + N], xdbc[..., 5 + N:]
    D = randn(gen, Di, dtype=torch.float32)
    h0 = {"none": None,
          "row": randn(gen, B, Di, N, dtype=torch.float32, s=0.1),
          "shared": randn(gen, Di, N, dtype=torch.float32, s=0.1)}[h0_kind]
    return x, dt, A, Bm, C, D, h0


@pytest.mark.parametrize("B,S,Di,N", [
    (1, 32, 128, 8), (2, 64, 256, 16), (2, 128, 512, 16), (3, 37, 200, 16),
    (2, 5, 33, 4), (1, 1, 7, 16),
    # more tiles than one (S 512), Di no multiple of a block's 32 channels
    # (nor, at 70, of a 16-byte chunk), state widths 1 and 5, one step
    # across falcon-mamba-7b's width
    (2, 512, 200, 16), (1, 37, 70, 1), (2, 37, 100, 5), (1, 1, 8192, 16)])
@pytest.mark.parametrize("h0_kind", ["none", "row", "shared"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_kernel(gen, B, S, Di, N, h0_kind, dtype):
    ops_in = _scan_operands(gen, B, S, Di, N, dtype, h0_kind)
    n0 = ss.launches
    y, h = ss.selective_scan(*ops_in)
    assert ss.launches == n0 + 1
    yw, hw = ss.selective_scan_torch(*ops_in)
    close(y, yw, dtype)
    assert h.dtype == torch.float32 and h.shape == (B, Di, N)
    assert torch.allclose(h, hw, atol=1e-3, rtol=1e-3), \
        (h - hw).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_padded_row_state_is_bitwise(gen, dtype):
    """dt = 0 over a right-padded row's tail: the kernel's final state is
    the solo row's, through the kernel, bit for bit."""
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, 3, 70, 300, 16, dtype,
                                            "row")
    lens = [70, 9, 41]
    dtp = dt.clone()
    for b, n in enumerate(lens):
        dtp[b, n:] = 0
    _, h = ss.selective_scan(x, dtp, A, Bm, C, D, h0)
    for b, n in enumerate(lens):
        _, hb = ss.selective_scan(x[b:b + 1, :n].contiguous(),
                                  dt[b:b + 1, :n].contiguous(), A,
                                  Bm[b:b + 1, :n], C[b:b + 1, :n], D,
                                  h0[b:b + 1])
        assert torch.equal(h[b], hb[0]), b


SCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


@pytest.mark.parametrize("B,S,Di,N", [
    (1, 32, 128, 8), (2, 64, 256, 16), (3, 37, 200, 16), (2, 5, 33, 4),
    (1, 1, 7, 16), (2, 40, 70, 1), (2, 37, 100, 5), (4, 256, 512, 16)])
@pytest.mark.parametrize("h0_kind", ["none", "row", "shared"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_bwd_kernel(gen, B, S, Di, N, h0_kind, dtype):
    """The backward kernel against the plain backward (odd S and Di, state
    widths 1 to 16, B and C strided views, no / per-row / shared h0, S not
    a multiple of the 16-step checkpoint interval); a second call repeats
    the bits; the kernel's rerun of the forward ends in the forward
    kernel's h_final, bit for bit."""
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, B, S, Di, N, dtype,
                                            h0_kind)
    if h0 is not None and h0.dim() == 2:
        h0 = h0.expand(B, Di, N)
    dy = randn(gen, B, S, Di, dtype=dtype)
    dh = randn(gen, B, Di, N, dtype=torch.float32)
    hT = torch.empty((B, Di, N), dtype=torch.float32, device="cuda")
    n0 = ss.bwd_launches
    got = ss._launch_bwd(x, dt, A, Bm, C, D, h0, dy, dh, h_final_out=hT)
    assert ss.bwd_launches == n0 + 1
    want = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dh)
    close_grads(got, want, dtype, SCAN_GRADS)
    again = ss._launch_bwd(x, dt, A, Bm, C, D, h0, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(hT, ss.selective_scan(x, dt, A, Bm, C, D, h0)[1])
    part = ss._launch_bwd(x, dt, A, Bm, C, D, h0, dy, None, need_A=False,
                          need_D=False)
    assert part[2] is None and part[5] is None
    close_grads(part, ss.selective_scan_bwd_torch(
        x, dt, A, Bm, C, D, h0, dy, need_A=False, need_D=False), dtype,
        SCAN_GRADS)


@pytest.mark.parametrize("B,S,Di,N,h0_kind", [
    (2, 64, 256, 16, "row"), (3, 37, 200, 16, "shared"), (2, 5, 33, 4, "none"),
    (1, 1, 7, 16, "row"), (4, 256, 8192, 16, "row")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_checkpoints(gen, B, S, Di, N, h0_kind, dtype):
    """The forward kernel's checkpoint output: y and h_final keep their
    bits with and without it; the checkpoints are h0 first and the plain
    forward's within the state tolerance; the backward kernel fed them
    gives the bits of a call that makes its own (one more forward
    launch), within GRAD_TOL of the plain backward fed the plain
    forward's checkpoints."""
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, B, S, Di, N, dtype,
                                            h0_kind)
    if h0 is not None and h0.dim() == 2:
        h0 = h0.expand(B, Di, N)
    ck = ss.checkpoints(x, A)
    n0 = ss.launches
    y, hT = ss._launch(x, dt, A, Bm, C, D, h0, ck=ck)
    y0, hT0 = ss._launch(x, dt, A, Bm, C, D, h0)
    assert ss.launches == n0 + 2
    assert torch.equal(y, y0) and torch.equal(hT, hT0)
    ckw = ss.checkpoints(x, A)
    ss.selective_scan_torch(x, dt, A, Bm, C, D, h0, ck=ckw)
    torch.cuda.synchronize()
    assert torch.equal(ck[:, 0], torch.zeros_like(ck[:, 0]) if h0 is None
                       else h0.transpose(1, 2))
    assert torch.allclose(ck, ckw, atol=1e-3, rtol=1e-3), \
        (ck - ckw).abs().max().item()
    dy = randn(gen, B, S, Di, dtype=dtype)
    n0 = (ss.launches, ss.bwd_launches)
    hf = torch.empty((B, Di, N), dtype=torch.float32, device="cuda")
    fed = ss._launch_bwd(x, dt, A, Bm, C, D, h0, dy, need_A=False,
                         need_D=False, ck=ck, h_final_out=hf)
    assert (ss.launches, ss.bwd_launches) == (n0[0], n0[1] + 1)
    own = ss._launch_bwd(x, dt, A, Bm, C, D, h0, dy, need_A=False,
                         need_D=False)
    assert (ss.launches, ss.bwd_launches) == (n0[0] + 1, n0[1] + 2)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(fed, own))
    assert torch.equal(hf, hT)
    close_grads(fed, ss.selective_scan_bwd_torch(
        x, dt, A, Bm, C, D, h0, dy, need_A=False, need_D=False, ck=ckw),
        dtype, SCAN_GRADS)


def test_selective_scan_autograd_launches_each_kernel_once(gen):
    """Autograd through the card: one forward launch (storing the
    checkpoints) and one backward launch, which starts from them."""
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, 2, 40, 96, 16,
                                            torch.bfloat16, "row")
    xg = x.clone().requires_grad_(True)
    n0 = (ss.launches, ss.bwd_launches)
    y, hT = ss.selective_scan(xg, dt, A, Bm, C, D, h0)
    (y.float().sum() + hT.sum()).backward()
    assert (ss.launches, ss.bwd_launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_bwd_padded_row_is_bitwise(gen, dtype):
    """dt = 0 and dy = 0 over a right-padded row's tail: the backward
    kernel gives the row's valid part the gradients of the row run alone,
    bit for bit."""
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, 3, 70, 300, 16, dtype,
                                            "row")
    dy = randn(gen, 3, 70, 300, dtype=dtype)
    dh = randn(gen, 3, 300, 16, dtype=torch.float32)
    lens = [70, 9, 41]
    dtp, dyp = dt.clone(), dy.clone()
    for b, n in enumerate(lens):
        dtp[b, n:] = 0
        dyp[b, n:] = 0
    pad = ss._launch_bwd(x, dtp, A, Bm, C, D, h0, dyp, dh)
    for b, n in enumerate(lens):
        solo = ss._launch_bwd(
            x[b:b + 1, :n].contiguous(), dt[b:b + 1, :n].contiguous(), A,
            Bm[b:b + 1, :n], C[b:b + 1, :n], D, h0[b:b + 1],
            dy[b:b + 1, :n].contiguous(), dh[b:b + 1].contiguous())
        for k in (0, 1, 3, 4):
            assert torch.equal(pad[k][b, :n], solo[k][0]), (b, k)
        assert torch.equal(pad[6][b], solo[6][0]), b


@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_autograd_on_the_card(gen, dtype):
    """The ssm layer's call (B and C views of one leaf, a shared state
    prompt expanded over the rows) through the autograd Function on the
    card against autograd through the plain versions."""
    x, dt, A, _, _, D, s0 = _scan_operands(gen, 2, 40, 96, 16, dtype,
                                           "shared")
    xdbc = randn(gen, 2, 40, 5 + 32, dtype=dtype, s=0.5)
    dy = randn(gen, 2, 40, 96, dtype=dtype)

    def grads(backend):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, xdbc, s0)]
        xx, dd, xd, h = leaves
        y, _ = ss.selective_scan(xx, dd, A, xd[..., 5:21], xd[..., 21:], D,
                                 h[None].expand(2, 96, 16), backend=backend)
        (y.float() * dy.float()).sum().backward()
        return [t.grad for t in leaves]

    n0 = ss.bwd_launches
    got = grads(None)
    assert ss.bwd_launches == n0 + 1
    close_grads(got, grads("torch"), dtype, ["dx", "ddt", "dxdbc", "ds0"])


def test_selective_scan_refuses_what_it_does_not_take(gen):
    x, dt, A, Bm, C, D, h0 = _scan_operands(gen, 2, 8, 16, 16,
                                            torch.float32, "row")
    # once refused ("no backward"): a gradient now comes from the backward
    # kernel, as the plain backward gives it
    xg = x.clone().requires_grad_(True)
    n0 = (ss.launches, ss.bwd_launches)
    y, hT = ss.selective_scan(xg, dt, A, Bm, C, D, h0)
    (y.sum() + hT.sum()).backward()
    assert (ss.launches, ss.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    want = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0,
                                       torch.ones_like(x),
                                       torch.ones_like(hT))[0]
    close_grads([xg.grad], [want], torch.float32, ["dx"])
    with pytest.raises(ValueError, match="state width"):
        wide = randn(gen, 16, 17, dtype=torch.float32)
        ss.selective_scan(x, dt, wide, randn(gen, 2, 8, 17,
                                             dtype=torch.float32),
                          randn(gen, 2, 8, 17, dtype=torch.float32), D)
    with pytest.raises(ValueError, match="float32"):
        ss.selective_scan(x, dt, A.bfloat16(), Bm, C, D, h0)


def _ssm_cfg():
    from repro_torch.configs.base import get_config
    return get_config("falcon-mamba-7b").with_(n_layers=2, d_model=256,
                                               vocab_size=512,
                                               dtype="float32")


def _queue(cfg, n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, cfg.vocab_size, (int(L),), generator=g)
             .numpy(), int(G))
            for L, G in zip(torch.randint(3, 40, (n,), generator=g),
                            torch.randint(2, 9, (n,), generator=g))]


def _serve(cfg, params, reqs, **kw):
    from repro_torch.launch.engine import DecodeEngine
    eng = DecodeEngine(cfg, slots=3, device="cuda", **kw)
    uids = [eng.submit(p, g) for p, g in reqs]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


def test_ssm_drain_on_the_card(gen):
    """A 2-layer f32 falcon-mamba drain through the scan kernel gives the
    plain versions' tokens."""
    from repro_torch.models import model as M
    cfg = _ssm_cfg()
    params = M.init(cfg, 0, device="cuda")
    reqs = _queue(cfg)
    ops.reset_launch_counts()
    kern, st = _serve(cfg, params, reqs)
    assert ops.launch_counts()["selective_scan"] == 2 * st.waves
    with ops.backend("torch"):
        plain, _ = _serve(cfg, params, reqs)
    for a, b in zip(kern, plain):
        assert (a == b).all()


def test_spec_drain_on_the_card(gen):
    """A speculative drain (the ssm target as its own drafter) through the
    kernels gives the plain drain's tokens and accepts every draft that
    fits the budgets."""
    from repro_torch.core.spec_decode import SpecDecoder
    from repro_torch.models import model as M
    cfg = _ssm_cfg()
    params = M.init(cfg, 0, device="cuda")
    reqs = _queue(cfg, seed=1)
    spec, _ = _serve(cfg, params, reqs, spec=SpecDecoder(cfg, params, k=3))
    plain, _ = _serve(cfg, params, reqs)
    for a, b in zip(spec, plain):
        assert (a == b).all()


def _lru_operands(gen, B, S, W, dtype, h0_kind):
    x = randn(gen, B, S, W, dtype=dtype, s=0.5)
    r = randn(gen, B, S, W, dtype=dtype)
    i = randn(gen, B, S, W, dtype=dtype)
    a = randn(gen, W, dtype=torch.float32)
    h0 = {"none": None,
          "row": randn(gen, B, W, dtype=torch.float32, s=0.1),
          "shared": randn(gen, W, dtype=torch.float32, s=0.1)}[h0_kind]
    return x, r, i, a, h0


@pytest.mark.parametrize("B,S,W", [(1, 32, 128), (2, 64, 256), (2, 96, 512),
                                   (3, 37, 200), (2, 5, 33), (1, 1, 7),
                                   (8, 512, 2560),
                                   # a one-row refill; S across the tile (32
                                   # steps in bf16, 16 in f32) and the ring;
                                   # a row pitch no multiple of 16 bytes
                                   (1, 512, 2560), (2, 17, 160), (2, 33, 96),
                                   (2, 40, 2561)])
@pytest.mark.parametrize("h0_kind", ["none", "row", "shared"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_kernel(gen, B, S, W, h0_kind, dtype):
    args = _lru_operands(gen, B, S, W, dtype, h0_kind)
    n0 = rg.launches
    hs, hT = rg.rglru(*args)
    assert rg.launches == n0 + 1
    hsw, hTw = rg.rglru_torch(*args)
    close(hs, hsw, dtype)
    assert hT.dtype == torch.float32 and hT.shape == (B, W)
    assert torch.allclose(hT, hTw, atol=1e-3, rtol=1e-3), \
        (hT - hTw).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_padded_row_state_is_bitwise(gen, dtype):
    """r_gate = -1e9 over a right-padded row's tail: the kernel's final
    state is the solo row's, through the kernel, bit for bit."""
    x, r, i, a, h0 = _lru_operands(gen, 3, 70, 300, dtype, "row")
    lens = [70, 9, 41]
    rp = r.clone()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
    _, h = rg.rglru(x, rp, i, a, h0)
    for b, n in enumerate(lens):
        _, hb = rg.rglru(x[b:b + 1, :n].contiguous(),
                         r[b:b + 1, :n].contiguous(),
                         i[b:b + 1, :n].contiguous(), a, h0[b:b + 1])
        assert torch.equal(h[b], hb[0]), b


def test_rglru_bits_repeat_across_launches_and_shapes(gen):
    """The same inputs give the same bits on every launch, with calls of
    other shapes (and so other plans) in between."""
    small = _lru_operands(gen, 3, 70, 300, torch.bfloat16, "row")
    big = _lru_operands(gen, 8, 512, 2560, torch.bfloat16, "shared")
    refill = _lru_operands(gen, 1, 512, 2560, torch.float32, "none")
    assert rg.plan(8, 2560)["warps"] != rg.plan(1, 2560)["warps"]
    want = {id(small): rg.rglru(*small), id(big): rg.rglru(*big)}
    for args in (big, refill, small, big, small):
        hs, hT = rg.rglru(*args)
        if args is not refill:
            assert torch.equal(hs, want[id(args)][0])
            assert torch.equal(hT, want[id(args)][1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_h_final_after_a_partial_tile(gen, dtype):
    """An S that is not a multiple of the tile: the steps past S neither
    decay nor move h, so h_final is the plain version's within 1e-3."""
    ts = rg.plan(2, 256, dtype)["tile"]
    for S in (ts + 1, 2 * ts - 1, 3 * ts + 5):
        args = _lru_operands(gen, 2, S, 256, dtype, "row")
        hs, hT = rg.rglru(*args)
        hsw, hTw = rg.rglru_torch(*args)
        close(hs, hsw, dtype)
        assert torch.allclose(hT, hTw, atol=1e-3, rtol=1e-3), \
            (S, (hT - hTw).abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_routes_give_the_same_bits(gen, dtype):
    """Operands one element off 16-byte alignment take the element route;
    it gives the cp.async route's bits."""
    x, r, i, a, h0 = _lru_operands(gen, 2, 40, 2560, dtype, "row")
    assert rg.plan(2, 2560, dtype)["route"] == "cp.async"
    assert rg.plan(2, 2560, dtype, aligned=False)["route"] == "element"

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    n0 = rg.launches
    want = rg.rglru(x, r, i, a, h0)
    got = rg.rglru(shifted(x), shifted(r), shifted(i), a, h0)
    assert rg.launches == n0 + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


LRU_GRADS = ("dx", "dr", "di", "da_param", "dh0")


@pytest.mark.parametrize("B,S,W", [(1, 32, 128), (2, 64, 256), (3, 37, 200),
                                   (2, 5, 33), (1, 1, 7), (4, 256, 2560),
                                   (2, 40, 2561)])
@pytest.mark.parametrize("h0_kind", ["none", "row", "shared"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_bwd_kernel(gen, B, S, W, h0_kind, dtype):
    """The backward kernel against the plain backward (odd S and W, no /
    per-row / shared h0, S not a multiple of the 32-step checkpoint
    interval); a second call repeats the bits; the kernel's rerun of the
    chain ends in the forward kernel's h_final, bit for bit."""
    x, r, i, a, h0 = _lru_operands(gen, B, S, W, dtype, h0_kind)
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(B, W)
    dhs = randn(gen, B, S, W, dtype=dtype)
    dh = randn(gen, B, W, dtype=torch.float32)
    hT = torch.empty((B, W), dtype=torch.float32, device="cuda")
    n0 = rg.bwd_launches
    got = rg._launch_bwd(x, r, i, a, h0, dhs, dh, h_final_out=hT)
    assert rg.bwd_launches == n0 + 1
    want = rg.rglru_bwd_torch(x, r, i, a, h0, dhs, dh)
    close_grads(got, want, dtype, LRU_GRADS)
    again = rg._launch_bwd(x, r, i, a, h0, dhs, dh)
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert torch.equal(hT, rg.rglru(x, r, i, a, h0)[1])
    part = rg._launch_bwd(x, r, i, a, h0, dhs, None, need_a=False)
    assert part[3] is None
    close_grads(part, rg.rglru_bwd_torch(x, r, i, a, h0, dhs, need_a=False),
                dtype, LRU_GRADS)


@pytest.mark.parametrize("B,S,W,h0_kind", [
    (2, 64, 256, "row"), (3, 37, 200, "shared"), (2, 5, 33, "none"),
    (1, 1, 7, "row"), (4, 256, 2560, "shared"), (2, 40, 2561, "row"),
    (8, 256, 2560, "none")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_checkpoints(gen, B, S, W, h0_kind, dtype):
    """The forward kernel's checkpoint output: h_seq and h_final keep
    their bits with and without it; the checkpoints are h0 first and the
    plain forward's within the state tolerance; the backward kernel fed
    them gives the bits of a call that makes its own (one more forward
    launch), within GRAD_TOL of the plain backward fed the plain
    forward's checkpoints, and records its plan."""
    x, r, i, a, h0 = _lru_operands(gen, B, S, W, dtype, h0_kind)
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(B, W)
    ck = rg.checkpoints(x)
    n0 = rg.launches
    hs, hT = rg._launch(x, r, i, a, h0, 8.0, ck=ck)
    hs0, hT0 = rg._launch(x, r, i, a, h0, 8.0)
    assert rg.launches == n0 + 2
    assert torch.equal(hs, hs0) and torch.equal(hT, hT0)
    ckw = rg.checkpoints(x)
    rg.rglru_torch(x, r, i, a, h0, ck=ckw)
    torch.cuda.synchronize()
    assert torch.equal(ck[:, 0], torch.zeros_like(ck[:, 0]) if h0 is None
                       else h0)
    assert torch.allclose(ck, ckw, atol=1e-3, rtol=1e-3), \
        (ck - ckw).abs().max().item()
    dhs = randn(gen, B, S, W, dtype=dtype)
    n0 = (rg.launches, rg.bwd_launches)
    hf = torch.empty((B, W), dtype=torch.float32, device="cuda")
    fed = rg._launch_bwd(x, r, i, a, h0, dhs, need_a=False, ck=ck,
                         h_final_out=hf)
    assert (rg.launches, rg.bwd_launches) == (n0[0], n0[1] + 1)
    assert rg.last_bwd_plan == rg.bwd_plan(B, W, dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (x, r, i, dhs)))
    own = rg._launch_bwd(x, r, i, a, h0, dhs, need_a=False)
    assert (rg.launches, rg.bwd_launches) == (n0[0] + 1, n0[1] + 2)
    assert all(p is None and q is None or torch.equal(p, q)
               for p, q in zip(fed, own))
    assert torch.equal(hf, hT)
    close_grads(fed, rg.rglru_bwd_torch(x, r, i, a, h0, dhs, need_a=False,
                                        ck=ckw), dtype, LRU_GRADS)


def test_rglru_autograd_launches_each_kernel_once(gen):
    """Autograd through the card: one forward launch (storing the
    checkpoints) and one backward launch, which starts from them."""
    x, r, i, a, h0 = _lru_operands(gen, 2, 40, 256, torch.bfloat16, "row")
    xg = x.clone().requires_grad_(True)
    n0 = (rg.launches, rg.bwd_launches)
    hs, hT = rg.rglru(xg, r, i, a, h0)
    (hs.float().sum() + hT.sum()).backward()
    assert (rg.launches, rg.bwd_launches) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_bwd_padded_row_is_bitwise(gen, dtype):
    """r_gate = -1e9 and dhs = 0 over a right-padded row's tail: the
    backward kernel gives the row's valid part the gradients of the row
    run alone, bit for bit (dr_gate and da_param are not finite over the
    padding, as in the reference)."""
    x, r, i, a, h0 = _lru_operands(gen, 3, 70, 300, dtype, "row")
    dhs = randn(gen, 3, 70, 300, dtype=dtype)
    dh = randn(gen, 3, 300, dtype=torch.float32)
    lens = [70, 9, 41]
    rp, dhp = r.clone(), dhs.clone()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
        dhp[b, n:] = 0
    pad = rg._launch_bwd(x, rp, i, a, h0, dhp, dh, need_a=False)
    for b, n in enumerate(lens):
        solo = rg._launch_bwd(
            x[b:b + 1, :n].contiguous(), r[b:b + 1, :n].contiguous(),
            i[b:b + 1, :n].contiguous(), a, h0[b:b + 1],
            dhs[b:b + 1, :n].contiguous(), dh[b:b + 1].contiguous(),
            need_a=False)
        for k in range(3):
            assert torch.equal(pad[k][b, :n], solo[k][0]), (b, k)
        assert torch.equal(pad[4][b], solo[4][0]), b


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_bwd_saturated_gate(gen, dtype):
    """r_gate = -1e9 on 10 steps of one row: dr_gate is not finite on
    exactly those entries and da_param on every channel, in the kernel as
    in the plain backward; every other entry agrees, and dx, di and dh0
    stay finite."""
    x, r, i, a, h0 = _lru_operands(gen, 2, 40, 256, dtype, "row")
    r = r.clone()
    r[1, 30:] = -1e9
    dhs = randn(gen, 2, 40, 256, dtype=dtype)
    got = rg._launch_bwd(x, r, i, a, h0, dhs)
    want = rg.rglru_bwd_torch(x, r, i, a, h0, dhs)
    torch.cuda.synchronize()
    masked_g, masked_w = [], []
    for name, g, w in zip(LRU_GRADS, got, want):
        bad = ~torch.isfinite(w)
        assert torch.equal(~torch.isfinite(g), bad), name
        if name == "dr":
            assert int(bad.sum()) == 10 * 256 and bool(bad[1, 30:].all())
        elif name == "da_param":
            assert bool(bad.all())
        else:
            assert not bool(bad.any()), name
        masked_g.append(torch.where(bad, 0, g.float()))
        masked_w.append(torch.where(bad, 0, w.float()))
    close_grads(masked_g, masked_w, dtype, LRU_GRADS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_autograd_on_the_card(gen, dtype):
    """The rglru layer's call (a shared (W,) state prompt) through the
    autograd Function on the card against autograd through the plain
    versions."""
    x, r, i, a, s0 = _lru_operands(gen, 2, 40, 256, dtype, "shared")
    dhs = randn(gen, 2, 40, 256, dtype=dtype)

    def grads(backend):
        leaves = [t.clone().requires_grad_(True) for t in (x, r, i, s0)]
        hs, _ = rg.rglru(*leaves[:3], a, leaves[3], backend=backend)
        (hs.float() * dhs.float()).sum().backward()
        return [t.grad for t in leaves]

    n0 = rg.bwd_launches
    got = grads(None)
    assert rg.bwd_launches == n0 + 1
    close_grads(got, grads("torch"), dtype, ["dx", "dr", "di", "ds0"])


def test_rglru_refuses_what_it_does_not_take(gen):
    x, r, i, a, h0 = _lru_operands(gen, 2, 8, 16, torch.float32, "row")
    # once refused ("no backward"): a gradient now comes from the backward
    # kernel, as the plain backward gives it
    xg = x.clone().requires_grad_(True)
    n0 = (rg.launches, rg.bwd_launches)
    hs, hT = rg.rglru(xg, r, i, a, h0)
    (hs.sum() + hT.sum()).backward()
    assert (rg.launches, rg.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    want = rg.rglru_bwd_torch(x, r, i, a, h0, torch.ones_like(x),
                              torch.ones_like(hT))[0]
    close_grads([xg.grad], [want], torch.float32, ["dx"])
    with pytest.raises(ValueError, match="float32"):
        rg.rglru(x, r, i, a.bfloat16(), h0)
    with pytest.raises(ValueError, match="do not match"):
        rg.rglru(x, r, i, a[:8], h0)


def test_hybrid_drain_on_the_card(gen):
    """A 3-layer f32 recurrentgemma (head dim 256) drain through the
    kernels gives the plain versions' tokens; rglru_scan launches twice
    per prefill or refill (two rglru sub-layers)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("recurrentgemma-2b").reduced().with_(
        head_dim=256, vocab_size=512, dtype="float32")
    params = M.init(cfg, 0, device="cuda")
    reqs = _queue(cfg, seed=2)
    ops.reset_launch_counts()
    kern, st = _serve(cfg, params, reqs)
    n = ops.launch_counts()
    assert n["rglru_scan"] == 2 * st.waves and n["flash_decode"] > 0
    with ops.backend("torch"):
        plain, _ = _serve(cfg, params, reqs)
    for a, b in zip(kern, plain):
        assert (a == b).all()


# ---------------------------------------------------------------------------
# the knowledge flow on the card: relay, int8 transport, split learning
# ---------------------------------------------------------------------------

def _flow_cfg(arch="vit-edge", dtype="float32", n_layers=4):
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced().with_(dtype=dtype, vocab_size=64,
                                           n_layers=n_layers)
    return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))


def _noisy_adapters(gen, cfg, seed):
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    ad = M.init(cfg, seed, device="cuda")["adapters"]
    return tree_map(lambda x: x + randn(gen, *x.shape, dtype=x.dtype,
                                        s=0.05), ad)


@pytest.mark.parametrize("dtype", DTYPES)
def test_faulted_relay_equals_clean_relay_on_the_card(gen, dtype):
    """The relay's deliver / edge_deliver / absorb / aggregate over lossy
    links, on CUDA tensors, bit for bit the clean relay's, with its
    retransmits booked."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.relay import KnowledgeRelay
    from repro_torch.models.params import tree_leaves

    cfg = _flow_cfg(dtype="bfloat16" if dtype == torch.bfloat16
                    else "float32")
    cloud = _noisy_adapters(gen, cfg, 0)
    ups = [_noisy_adapters(gen, cfg, i + 1) for i in range(4)]
    doms = ["a", "b"]
    relays = []
    for plan in (None, FaultPlan(seed=5, link_loss=0.5,
                                 payload_corrupt=0.6)):
        bank = AdapterBank.create({d: cloud for d in doms})
        r = KnowledgeRelay(cloud, doms, bank=bank, faults=plan,
                           max_retries=50, backoff_s=0.0)
        for d in doms:
            r.cloud_deliver(d)
        r.edge_deliver("a", 4)
        r.edge_absorb("a", ups)
        r.cloud_aggregate()
        relays.append((r, bank))
    (clean, cbank), (lossy, lbank) = relays
    assert lossy.ledger.retries > 0
    assert lossy.ledger.total() == clean.ledger.total() + \
        lossy.ledger.retransmit_bytes
    for a, b in zip(tree_leaves([lossy.cloud, lossy.edges]),
                    tree_leaves([clean.cloud, clean.edges])):
        assert a.is_cuda and torch.equal(a, b)
    for d in doms:
        for a, b in zip(tree_leaves(lbank.snapshot(d)),
                        tree_leaves(cbank.snapshot(d))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_round_trip_on_the_card(gen, dtype, tmp_path):
    """int8 adapters written from and read back into CUDA tensors: the
    file is the one written from the same values on the CPU, and each
    element comes back within one int8 step."""
    import numpy as np

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = _flow_cfg(dtype="bfloat16" if dtype == torch.bfloat16
                    else "float32")
    ad = _noisy_adapters(gen, cfg, 0)
    ckpt_io.save_adapters_quantized(str(tmp_path / "g"), {"adapters": ad})
    ckpt_io.save_adapters_quantized(
        str(tmp_path / "c"), {"adapters": tree_map(lambda x: x.cpu(), ad)})
    with np.load(tmp_path / "g.npz") as g, np.load(tmp_path / "c.npz") as c:
        assert sorted(g.files) == sorted(c.files)
        assert all(np.array_equal(g[k], c[k]) for k in g.files)
    back = ckpt_io.load_adapters_quantized(str(tmp_path / "g"),
                                           {"adapters": ad})["adapters"]
    for a, b in zip(tree_leaves(ad), tree_leaves(back)):
        assert b.is_cuda and b.dtype == a.dtype and b.shape == a.shape
        # tests/test_quantized_transport.py's bound: one int8 step of the
        # leaf's largest value (a bf16 leaf's rounding stays inside it)
        step = a.float().abs().max().item() / 127.0
        assert (a.float() - b.float()).abs().max().item() <= step + 1e-6


def _sl_model(gen, arch, n_layers=4):
    from repro_torch.models import model as M
    cfg = _flow_cfg(arch, n_layers=n_layers)
    params = M.init(cfg, 0, device="cuda")
    params["adapters"] = _noisy_adapters(gen, cfg, 1)
    toks = torch.randint(0, cfg.vocab_size, (8, 24), generator=gen,
                         device="cuda")
    return cfg, params, toks


@pytest.mark.parametrize("arch", ["vit-edge", "falcon-mamba-7b"])
def test_sl_chain_matches_classify_on_the_card(gen, arch):
    """The 4-stage chain through the kernels against monolithic
    ``classify``, with each layer's kernels launched once a microbatch."""
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.models import model as M

    cfg, params, toks = _sl_model(gen, arch)
    st = sl.split_for_stages(params, cfg, 4)
    with torch.no_grad():
        ops.reset_launch_counts()
        got = sl.pipeline_classify(params, st, toks, cfg, n_microbatches=4)
        n = ops.launch_counts()
        want = M.classify(params, {"tokens": toks}, cfg)
    close(got, want, torch.float32)
    if cfg.family == "ssm":
        assert n["selective_scan"] == 4 * cfg.n_layers
    else:
        assert n["flash_attention"] == 4 * cfg.n_layers
        assert n["lora_matmul"] == 4 * cfg.n_layers * \
            len(cfg.peft.lora_targets)


def test_sl_step_matches_monolithic_grads_on_the_card(gen):
    """One sgd(1.0) step of the 4-stage chain moves every adapter and the
    head by minus its gradient of monolithic ``classify``'s loss."""
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.core.peft import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.models.layers import cross_entropy
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.optimizers import sgd

    cfg, params, toks = _sl_model(gen, "vit-edge")
    labels = torch.randint(0, 5, (8,), generator=gen, device="cuda")
    batch = {"tokens": toks, "label": labels}

    def mono(ad):
        p = {"backbone": params["backbone"], "adapters": ad}
        return cross_entropy(M.classify(p, batch, cfg), labels)

    mloss, g = value_and_grad(mono, params["adapters"], has_aux=False)
    opt = sgd(1.0)
    st = sl.split_for_stages(params, cfg, 4)
    head = params["adapters"]["head"]
    step = sl.make_sl_finetune_step(params, cfg, opt, n_microbatches=2)
    ops.reset_launch_counts()
    new_st, new_h, _, loss = step(st, head,
                                  opt.init({"a": st["adapters"], "h": head}),
                                  batch)
    assert ops.launch_counts()["lora_matmul_bwd"] == \
        2 * cfg.n_layers * len(cfg.peft.lora_targets)
    assert abs(loss.item() - mloss.item()) <= 1e-5
    got = [x for s in new_st["adapters"] for x in tree_leaves(s)] + \
        tree_leaves(new_h)
    old = tree_leaves(params["adapters"]["stack"]) + tree_leaves(head)
    grads = tree_leaves(g["stack"]) + tree_leaves(g["head"])
    for n_, o, gr in zip(got, old, grads):
        tol = GRAD_TOL[torch.float32] * max(1.0, gr.abs().max().item())
        assert (n_ - (o - gr)).abs().max().item() <= tol


@pytest.mark.parametrize("method", ["cloud_deliver", "edge_deliver",
                                    "edge_absorb", "cloud_aggregate"])
def test_relay_returns_no_alias_on_the_card(gen, method):
    """An in-place step on the CUDA tree a relay method returns leaves the
    relay's edges, cloud, versions and the bank's slots as they were."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.relay import KnowledgeRelay
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = _flow_cfg()
    cloud = _noisy_adapters(gen, cfg, 0)
    ups = [_noisy_adapters(gen, cfg, i + 1) for i in range(2)]
    doms = ["a", "b"]
    bank = AdapterBank.create({d: cloud for d in doms})
    r = KnowledgeRelay(cloud, doms, bank=bank)
    got = {"cloud_deliver": lambda: r.cloud_deliver("a"),
           "edge_deliver": lambda: r.edge_deliver("a", 4),
           "edge_absorb": lambda: r.edge_absorb("a", ups),
           "cloud_aggregate": r.cloud_aggregate}[method]()
    before = [tree_map(torch.clone, t) for t in
              (r.edges, r.cloud, bank.snapshot("a"), bank.snapshot("b"))]
    versions = (dict(r.edge_versions), r.cloud_version, bank.version("a"))
    for x in tree_leaves(got):
        assert x.is_cuda
        x.add_(1.0)
    after = (r.edges, r.cloud, bank.snapshot("a"), bank.snapshot("b"))
    for b, a in zip(before, after):
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(b),
                                                     tree_leaves(a)))
    assert versions == (dict(r.edge_versions), r.cloud_version,
                        bank.version("a"))


# ---------------------------------------------------------------------------
# the moe family on the card
# ---------------------------------------------------------------------------

def _moe_cfg(dtype="float32", factor=None, **kw):
    """granite-moe-1b-a400m's moe FFN at its published width (d 1024, 32
    experts top-8, d_ff_expert 512) in a 2-layer config."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config("granite-moe-1b-a400m").with_(n_layers=2, dtype=dtype,
                                                   **kw)
    if factor is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=factor))
    return cfg


def _moe_layer(cfg, seed=0):
    from repro_torch.models import moe
    from repro_torch.models.params import init_from_spec
    g = torch.Generator(device="cuda").manual_seed(seed)
    return init_from_spec(g, moe.moe_spec(cfg), torch.device("cuda"))


@pytest.mark.parametrize("shape", [(8,), (4, 64), (2, 300)])
@pytest.mark.parametrize("factor", [None, -1])
def test_moe_apply_on_the_card_matches_the_cpu(gen, shape, factor):
    """f32 ``moe_apply`` on CUDA against the same call on the CPU (TF32
    off): y and aux within 1e-4, the same routing."""
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    cfg = _moe_cfg(factor=factor)
    p = _moe_layer(cfg)
    x = randn(gen, *shape, cfg.d_model, dtype=torch.float32)
    y, aux = moe.moe_apply(p, x, cfg)
    yc, auxc = moe.moe_apply(tree_map(lambda t: t.cpu(), p), x.cpu(), cfg)
    close(y.cpu(), yc, torch.float32)
    assert abs(aux.item() - auxc.item()) <= 1e-6


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dispatch_and_backward_repeat_their_bits(gen, dtype):
    """Two runs of the forward and its backward on CUDA give equal bits
    (no atomic accumulation in the dispatch, the combine or their
    gradients), at a prefill's size with drops."""
    from repro_torch.models import moe
    cfg = _moe_cfg("bfloat16" if dtype == torch.bfloat16 else "float32")
    p = _moe_layer(cfg)
    x = randn(gen, 4, 256, cfg.d_model, dtype=dtype)
    g = randn(gen, 4, 256, cfg.d_model, dtype=dtype)
    runs = []
    for _ in range(2):
        xg = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(p, xg, cfg)
        ((y.float() * g.float()).sum() + aux).backward()
        runs.append((y.detach(), aux.detach(), xg.grad))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_moe_drain_on_the_card(gen):
    """A 2-layer f32 granite drain (full width, no dropping) through the
    kernels gives the plain versions' tokens and each request's solo
    tokens; the paged drain with prefix sharing gives the same."""
    import numpy as np

    from repro_torch.core.paged import PagedSpec
    from repro_torch.models import model as M
    cfg = _moe_cfg(factor=-1)
    params = M.init(cfg, 0, device="cuda")
    reqs = _queue(cfg, seed=3)
    ops.reset_launch_counts()
    kern, st = _serve(cfg, params, reqs)
    n = ops.launch_counts()
    assert n["flash_attention"] > 0 and n["flash_decode"] > 0 \
        and n["lora_matmul"] > 0
    with ops.backend("torch"):
        plain, _ = _serve(cfg, params, reqs)
    paged, pst = _serve(cfg, params, reqs,
                        paged=PagedSpec(64, 16, share_prefix=True))
    for (p, g), a, b, c in zip(reqs, kern, plain, paged):
        solo = M.generate(params, cfg, torch.as_tensor(p[None],
                                                       device="cuda"),
                          gen=g)[0].cpu().numpy()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, solo)


# ---------------------------------------------------------------------------
# the vlm and audio families: non-causal attention, cross attention (S !=
# T) and both families' drains
# ---------------------------------------------------------------------------

# (B, S, n_prefix, T, Hq, Hkv, D): the encoder (S = T frames behind 16
# prefix slots, 1516 keys: no multiple of the 64-key tile) and cross
# attention (S decoder rows against T encoder keys, S < T and S > T),
# groups 1 and 4, head dims 64 and 128
@pytest.mark.parametrize("case", [(2, 1500, 16, 1500, 12, 12, 64),
                                  (3, 64, 0, 1500, 12, 12, 64),
                                  (2, 5, 0, 70, 8, 2, 128),
                                  (2, 130, 0, 33, 4, 1, 64),
                                  (1, 1, 0, 1, 4, 4, 64),
                                  (2, 200, 3, 515, 8, 2, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_non_causal_cross_kernel(gen, case, dtype):
    B, S, n_p, T, Hq, Hkv, D = case
    q = randn(gen, B, S, Hq, D, dtype=dtype)
    k = randn(gen, B, n_p + T, Hkv, D, dtype=dtype)
    v = randn(gen, B, n_p + T, Hkv, D, dtype=dtype)
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"),
                        torch.arange(T, dtype=torch.int32, device="cuda")])
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=0, causal=False)
    n0 = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n0 + 1
    close(got, fa.flash_attention_torch(q, k, v, **kw), dtype)
    # every row sees every key: the rows' outputs are one softmax each,
    # whatever the rows' positions
    perm = torch.randperm(S, generator=gen, device="cuda")
    moved = fa.flash_attention(q[:, perm], k, v, **kw)
    assert torch.equal(moved, got[:, perm])


# (B, T, Hq, Hkv, D): whisper's cross cache (T 1500 frames at D 64, 12 /
# 12 heads), a partial last tile, one key, and a GQA group at D 128
@pytest.mark.parametrize("case", [(8, 1500, 12, 12, 64), (3, 70, 8, 2, 128),
                                  (2, 1, 4, 4, 64), (4, 65, 12, 12, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_non_causal_cross_kernel(gen, case, dtype):
    """The cross-attention decode: every row's q_pos is its decoder
    position, below most encoder keys, and every key is visible."""
    B, T, Hq, Hkv, D = case
    q = randn(gen, B, Hq, D, dtype=dtype)
    k = randn(gen, B, T, Hkv, D, dtype=dtype)
    v = randn(gen, B, T, Hkv, D, dtype=dtype)
    qp = torch.randint(0, 64, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    kp = torch.arange(T, dtype=torch.int32, device="cuda")[None] \
        .expand(B, T).contiguous()
    kw = dict(q_pos=qp, kv_pos=kp, window=0, causal=False)
    n0 = fd.launches
    got = ops.flash_decode(q, k, v, **kw)
    assert fd.launches == n0 + 1
    with ops.backend("torch"):
        want = ops.flash_decode(q, k, v, **kw)
    close(got, want, dtype)
    with ops.backend("torch"):
        causal = ops.flash_decode(q, k, v, q_pos=qp, kv_pos=kp)
    if T > 64:
        assert not torch.allclose(got.float(), causal.float(), atol=1e-3)


def _family_drain(arch, extras_of):
    """A 2-layer f32 drain of ``arch`` at its published width, each request
    with its own modality row, through the kernels and the plain versions,
    and each request alone through ``generate``."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import model as M

    cfg = get_config(arch).with_(n_layers=2, dtype="float32")
    if cfg.family == "audio":
        cfg = cfg.with_(audio=cfg.audio.__class__(n_enc_layers=2,
                                                  n_audio_frames=1500))
    params = M.init(cfg, 0, device="cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), g)
            for n, g in ((5, 4), (9, 2), (17, 6), (3, 3), (11, 5))]
    rows = [extras_of(cfg, i) for i in range(len(reqs))]

    def drain():
        eng = DecodeEngine(cfg, slots=2, device="cuda")
        uids = [eng.submit(p, g, extras=rows[i])
                for i, (p, g) in enumerate(reqs)]
        comps, stats = eng.run(params)
        by = {c.uid: c.tokens for c in comps}
        return [by[u] for u in uids], stats

    ops.reset_launch_counts()
    kern, st = drain()
    n = ops.launch_counts()
    assert n["flash_attention"] > 0 and n["flash_decode"] > 0 \
        and n["lora_matmul"] > 0 and st.waves > 1
    with ops.backend("torch"):
        plain, _ = drain()
    for i, ((p, g), a, b) in enumerate(zip(reqs, kern, plain)):
        solo = M.generate(params, cfg, torch.as_tensor(p[None],
                                                       device="cuda"),
                          gen=g, extra_batch={k: r[None] for k, r in
                                              rows[i].items()})
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, solo[0].cpu().numpy())


def _row(cfg, i, n):
    g = torch.Generator(device="cuda").manual_seed(100 + i)
    return torch.randn((n, cfg.d_model), generator=g, device="cuda") * 0.1


def test_vlm_drain_on_the_card(gen):
    _family_drain("llava-next-mistral-7b", lambda cfg, i: {
        "vision_embeds": _row(cfg, i, cfg.vlm.n_vis_tokens)})


def test_audio_drain_on_the_card(gen):
    _family_drain("whisper-small", lambda cfg, i: {
        "frames": _row(cfg, i, cfg.audio.n_audio_frames)})


# ---------------------------------------------------------------------------
# the tools' twins: the kernels at 32k keys, a warm drain that compiles
# nothing
# ---------------------------------------------------------------------------

# queries and keys of the 32k cases at this scale: scores of std 4, so each
# row's softmax rests on a few of its keys and the outputs are O(1) (unit
# draws leave it nearly flat, a late row's output near 1e-2, under the
# tolerance, where a lost key tile would pass unseen)
SHARP = 2.0


def _misses(got, want, dtype):
    """``got`` (the kernel with keys masked out, as a kernel that lost
    their tiles computes) fails the comparison that the real case
    passes."""
    torch.cuda.synchronize()
    tol = TOL[dtype]
    assert not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_at_32k_keys(gen):
    """qwen2-7b's prefill_32k attention (B 2, S 32,768, 28/4 heads, D 128,
    causal) against the plain version: the first run at 32k keys. With
    its last 64-key tile masked out the kernel misses it."""
    B, S, Hq, Hkv, D = 2, 32768, 28, 4, 128
    q = randn(gen, B, S, Hq, D, dtype=torch.bfloat16, s=SHARP)
    k = randn(gen, B, S, Hkv, D, dtype=torch.bfloat16, s=SHARP)
    v = randn(gen, B, S, Hkv, D, dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kw = dict(q_pos=pos, kv_pos=pos, window=0, causal=True)
    want = fa.flash_attention(q, k, v, backend="torch", **kw)
    close(fa.flash_attention(q, k, v, backend="cuda", **kw), want,
          torch.bfloat16)
    lost = pos.clone()
    lost[-64:] = 10 ** 9
    _misses(fa.flash_attention(q, k, v, backend="cuda",
                               **(kw | {"kv_pos": lost})), want,
            torch.bfloat16)


def test_flash_decode_at_32k_keys(gen):
    """qwen2-7b's decode_32k attention (B 8 against a 32,768-slot cache
    behind 16 shared prefix slots, ragged positions) against the plain
    version. With a split's worth of keys masked out at the end of each
    row the kernel misses it."""
    B, T, n_p, Hq, Hkv, D = 8, 32768, 16, 28, 4, 128
    q = randn(gen, B, Hq, D, dtype=torch.bfloat16, s=SHARP)
    k = randn(gen, B, T, Hkv, D, dtype=torch.bfloat16, s=SHARP)
    v = randn(gen, B, T, Hkv, D, dtype=torch.bfloat16)
    pk = randn(gen, n_p, Hkv, D, dtype=torch.bfloat16, s=SHARP)
    pv = randn(gen, n_p, Hkv, D, dtype=torch.bfloat16)
    qp = torch.randint(32, T, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    sentinel = torch.full_like(slots, 10 ** 9)
    kp = torch.where(slots <= qp[:, None], slots, sentinel).contiguous()
    kw = dict(q_pos=qp, prefix_k=pk, prefix_v=pv)
    want = fd.flash_decode(q, k, v, backend="torch", kv_pos=kp, **kw)
    close(fd.flash_decode(q, k, v, backend="cuda", kv_pos=kp, **kw), want,
          torch.bfloat16)
    n_lost = fd.split_plan(D, n_p + T)[0] * fd.TILE
    last = (slots > (qp - n_lost)[:, None]) & (slots <= qp[:, None])
    lost = torch.where(last, sentinel, kp)
    _misses(fd.flash_decode(q, k, v, backend="cuda", kv_pos=lost, **kw),
            want, torch.bfloat16)


def test_a_warm_drain_compiles_nothing(gen):
    """A second drain of the same queue builds and loads no kernel
    library: ``compile_guard(max_compiles=0)`` holds."""
    from repro_torch.analysis.guards import compile_guard
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen2-7b").reduced()
    params = M.init(cfg, 0, device="cuda")
    reqs = _queue(cfg)
    first, _ = _serve(cfg, params, reqs)
    with compile_guard(max_compiles=0) as log:
        again, _ = _serve(cfg, params, reqs)
    assert log.count == 0
    for a, b in zip(first, again):
        assert (a == b).all()


def test_mesh_drain_on_the_card(gen):
    """A 2-layer f32 qwen2-7b bank drain on a 1x1 NCCL mesh
    (``DecodeEngine(mesh=)``, the params and a slot-sharded bank as
    DTensors) gives the mesh-less drain's tokens through the kernels, with
    the same launches, and runs no plain version."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b").reduced().with_(dtype="float32")
    backbone = M.init(cfg, 0, device="cuda")["backbone"]
    adapters = {f"d{i}": M.init(cfg, 10 + i, device="cuda")["adapters"]
                for i in range(4)}
    for i, a in enumerate(adapters.values()):
        for layer in a["stack"]["g0"]:
            for t in layer["s0"]["lora"].values():
                t["b"] = randn(gen, *t["b"].shape, dtype=t["b"].dtype,
                               s=0.1)
    reqs = _queue(cfg, n=8)
    doms = [f"d{i % 4}" for i in range(len(reqs))]

    def drain(bank, bb, mesh):
        eng = DecodeEngine(cfg, slots=3, bank=bank, mesh=mesh,
                           device="cuda")
        uids = [eng.submit(p, g, domain=d) for (p, g), d in zip(reqs, doms)]
        ops.reset_launch_counts()
        comps, _ = eng.run(bank.serving_params(bb))
        by = {c.uid: c.tokens for c in comps}
        return [by[u] for u in uids], ops.launch_counts()

    want, n_want = drain(AdapterBank.create(adapters), backbone, None)
    with single_process_mesh() as mesh:
        bank = AdapterBank.create(adapters, mesh=mesh)
        bb = M.place_params({"backbone": backbone}, cfg, mesh)["backbone"]
        with ops.backend("cuda"):
            got, n_got = drain(bank, bb, mesh)
    assert n_got == n_want and n_got["lora_bgmv_rows"] > 0 \
        and n_got["flash_decode"] > 0
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The paged decode and the two scans through their mesh wrappers
# ---------------------------------------------------------------------------

def _on_mesh(mesh, t, pl):
    """A whole tensor as the DTensor of placements ``pl`` on a one-rank
    mesh (the local tensor is the whole one), a leaf of its own."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, pl, run_check=False)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_through_its_mesh_wrapper(gen, per_row, dtype):
    """``ops.flash_decode_paged`` on DTensors of a 1-rank NCCL mesh (q's
    rows on `data` and heads on `model`, the pool's blocks on `data` and
    kv heads on `model`) launches the paged kernel once on the local
    shards and equals the plain version on the whole tensors."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import single_process_mesh
    q, kp, vp, table, qp, pk, pv = _paged_operands(
        gen, 4, 4, 16, 4, 8, 2, 64, dtype, per_row)
    want = fd.flash_decode_paged_torch(q, kp, vp, table, q_pos=qp,
                                       prefix_k=pk, prefix_v=pv)
    with single_process_mesh() as mesh:
        pool = (Shard(0), Shard(2))
        args = [_on_mesh(mesh, q, (Shard(0), Shard(1))),
                _on_mesh(mesh, kp, pool), _on_mesh(mesh, vp, pool)]
        pre = (Shard(0), Shard(2)) if per_row else (Replicate(), Shard(1))
        n0 = fd.paged_launches
        got = ops.flash_decode_paged(
            *args, table, q_pos=qp,
            prefix_k=_on_mesh(mesh, pk, pre), prefix_v=_on_mesh(mesh, pv,
                                                                pre))
        assert fd.paged_launches == n0 + 1
        close(got.full_tensor(), want, dtype)


def _grads_of(fn, args):
    """fn(*args) -> outputs; the gradients of every floating input under
    one random cotangent per output (local tensors of a DTensor result)."""
    leaves = [a.detach().clone().requires_grad_(True)
              if a is not None and a.is_floating_point() else a
              for a in args]
    outs = fn(leaves)
    g = torch.Generator(device="cuda").manual_seed(1)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                         device="cuda")).sum()
               for o in outs)
    loss.backward()
    return outs, [None if a is None else a.grad for a in leaves]


@pytest.mark.parametrize("split", ["channels", "rows"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_selective_scan_through_its_mesh_wrapper(gen, split, dtype):
    """``ops.selective_scan`` on DTensors of a 1-rank NCCL mesh, with the
    channels on `model` (serving) or the rows on `model` (a recurrent
    family's training round): one forward and one backward launch, the
    outputs and every input's gradient equal to the plain version's on
    the whole tensors."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import single_process_mesh
    x, dt_, A, Bm, C, D, h0 = _scan_operands(gen, 2, 40, 64, 16, dtype,
                                             "row")
    Bm, C = Bm.contiguous(), C.contiguous()
    plain = [x, dt_, A, Bm, C, D, h0]
    want, wgrads = _grads_of(
        lambda a: ss.selective_scan(*a, backend="torch"), plain)
    R, S = Replicate(), Shard
    if split == "channels":
        pls = [(S(0), S(2)), (S(0), S(2)), (R, S(0)), (S(0), R), (S(0), R),
               (R, S(0)), (S(0), S(1))]
    else:
        pls = [(R, S(0)), (R, S(0)), (R, R), (R, S(0)), (R, S(0)), (R, R),
               (R, S(0))]
    with single_process_mesh() as mesh:
        n0, b0 = ss.launches, ss.bwd_launches

        def on_mesh(a):
            ys = ops.selective_scan(*[_on_mesh(mesh, t, p)
                                      for t, p in zip(a, pls)])
            return [y.to_local() for y in ys]
        got, grads = _grads_of(on_mesh, plain)
        assert ss.launches - n0 == 1 and ss.bwd_launches - b0 == 1
    close(got[0], want[0], dtype)
    close(got[1], want[1], torch.float32 if dtype == torch.float32
          else torch.bfloat16)
    close_grads(grads, wgrads, dtype, SCAN_GRADS)


@pytest.mark.parametrize("split", ["channels", "rows"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_through_its_mesh_wrapper(gen, split, dtype):
    """``ops.rglru`` on DTensors of a 1-rank NCCL mesh, channels (``lru``)
    or rows on `model`: one forward and one backward launch, the outputs
    and the gradients equal to the plain version's."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import single_process_mesh
    plain = list(_lru_operands(gen, 2, 40, 64, dtype, "row"))
    want, wgrads = _grads_of(lambda a: rg.rglru(*a, backend="torch"), plain)
    R, S = Replicate(), Shard
    if split == "channels":
        pls = [(S(0), S(2))] * 3 + [(R, S(0)), (S(0), S(1))]
    else:
        pls = [(R, S(0))] * 3 + [(R, R), (R, S(0))]
    with single_process_mesh() as mesh:
        n0, b0 = rg.launches, rg.bwd_launches

        def on_mesh(a):
            ys = ops.rglru(*[_on_mesh(mesh, t, p) for t, p in zip(a, pls)])
            return [y.to_local() for y in ys]
        got, grads = _grads_of(on_mesh, plain)
        assert rg.launches - n0 == 1 and rg.bwd_launches - b0 == 1
    close(got[0], want[0], dtype)
    close_grads(grads, wgrads, dtype, ("dx", "dr", "di", "da", "dh0"))
