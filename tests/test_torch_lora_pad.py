"""The padding of the bf16 LoRA launches (``lora_matmul._pad_for_tma``), on
the CPU through the plain versions. TMA needs 16-byte-aligned bases and
row strides, so a bf16 launch zero-pads K and N to multiples of 8 and
slices y back. The plain version on the padded operands, sliced, must give
its result on the originals bit for bit (zeros add exact zeros), for each
of the three ops, in f32 and bf16, at the unaligned shapes of the GPU
tests; both also agree with the JAX package's oracles. Aligned operands
come back as they are, with no copy. Inputs are made from a seed with
numpy and fed to both packages.

Tolerances against JAX are those of tests/test_kernels.py: f32 2e-5, bf16
2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import lora_bgmv as bg
from repro_torch.kernels import lora_matmul as lm

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (K, N): the GPU tests' unaligned widths, and one side aligned
SHAPES = [(7, 5), (67, 97), (130, 131), (3584, 131), (130, 512)]


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def operands(op, K, N, dt, r=4, n_slots=3, seed=0):
    """(jax, torch) pairs of x, w, a, b, bias and the ids, the same numpy
    values for both packages."""
    rng = np.random.default_rng(seed + K * N)
    lead = {"matmul": (6,), "rows": (6,), "seq": (3, 5)}[op]
    stack = () if op == "matmul" else (n_slots,)
    jd, td = DTYPES[dt]
    vals = [rng.standard_normal((*lead, K)),
            rng.standard_normal((K, N)) / np.sqrt(K),
            rng.standard_normal((*stack, K, r)) / np.sqrt(K),
            0.1 * rng.standard_normal((*stack, r, N)),
            rng.standard_normal(N)]
    ids = rng.integers(0, n_slots, lead[0]).astype(np.int32)
    return ([jnp.asarray(v, jd) for v in vals] + [jnp.asarray(ids)],
            [torch.from_numpy(v).to(td) for v in vals]
            + [torch.from_numpy(ids)])


def plain(op, x, w, a, b, bias, ids):
    if op == "matmul":
        return lm.lora_matmul_torch(x, w, a, b, 2.0, bias)
    return bg.lora_bgmv_torch(x, w, a, b, ids, 2.0, bias)


@pytest.mark.parametrize("K,N", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["matmul", "rows", "seq"])
def test_padding_gives_the_plain_result_bit_for_bit(op, dt, K, N):
    (jx, jw, ja, jb, jbias, jids), (x, w, a, b, bias, ids) = \
        operands(op, K, N, dt)
    n0 = lm.pad_copies
    px, pw, pa, pb, pbias, n = lm._pad_for_tma(x, w, a, b, bias)
    assert n == N and pw.shape == (-(-K // 8) * 8, -(-N // 8) * 8)
    assert px.shape[-1] == pw.shape[0] == pa.shape[-2]
    assert pb.shape[-1] == pbias.shape[0] == pw.shape[1]
    # x and a where K is padded, b and bias where N is, w where either is
    assert lm.pad_copies - n0 == 2 * (K % 8 != 0) + 2 * (N % 8 != 0) + 1
    for t, p in ((x, px), (w, pw), (a, pa), (b, pb), (bias, pbias)):
        inner = tuple(slice(0, s) for s in t.shape)
        assert torch.equal(p[inner], t)
        pad = p.clone()
        pad[inner] = 0
        assert not pad.any()                     # the padding is zeros
    got = plain(op, px, pw, pa, pb, pbias, ids)[..., :N]
    want = plain(op, x, w, a, b, bias, ids)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    if op == "matmul":
        ref = jref.lora_matmul(jx, jw, ja, jb, 2.0, jbias)
    else:
        ref = jref.lora_bgmv(jx, jw, ja, jb, jids, 2.0, jbias)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               **tol(dt))


@pytest.mark.parametrize("op", ["matmul", "rows", "seq"])
def test_aligned_operands_come_back_without_a_copy(op):
    _, ts = operands(op, 64, 24, "bf16")
    x, w, a, b, bias, _ = ts
    n0 = lm.pad_copies
    out = lm._pad_for_tma(x, w, a, b, bias)
    assert all(o is t for o, t in zip(out, (x, w, a, b, bias)))
    assert out[5] == 24 and lm.pad_copies == n0
    assert lm._pad_for_tma(x, w, a, b, None)[4] is None


def test_a_misaligned_base_is_copied():
    """An aligned width at a base 2 bytes past a 16-byte boundary: x is
    copied to an aligned tensor with the same values, nothing else."""
    _, (x, w, a, b, bias, _) = operands("matmul", 64, 24, "bf16")
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 != 0
    n0 = lm.pad_copies
    px, pw, pa, pb, pbias, _ = lm._pad_for_tma(xs, w, a, b, bias)
    assert lm.pad_copies == n0 + 1 and px is not xs
    assert px.data_ptr() % 16 == 0 and torch.equal(px, x)
    assert all(p is t for p, t in zip((pw, pa, pb, pbias), (w, a, b, bias)))
