"""The frozen cost copy equals the port's ``launch/roofline.py`` at the
shapes of PERF.md's kernel table, and the probes read a call's dims as
the port's count does."""
import inspect

import pytest
import torch

from portbench.lib import costs, probes
from repro_torch.launch import roofline as rl

ROWS = {
    "1": ("lora_matmul", dict(M=8, K=3584, N=3584, r=8)),
    "1b": ("lora_matmul", dict(M=4096, K=3584, N=3584, r=8)),
    "2": ("flash_attention", dict(B=8, S=512, T=528, Hq=28, Hkv=4, D=128,
                                  visible=512 * 513 // 2 + 16 * 512)),
    "3": ("flash_decode", dict(B=8, Hq=28, Hkv=4, D=128, Tc=1024,
                               keys=8 * 1024, n_p=16, n_read=1)),
    "3f": ("flash_decode", dict(B=8, Hq=28, Hkv=4, D=128, Tc=32768,
                                keys=159436, n_p=16, n_read=1)),
    "5": ("lora_matmul_bwd", dict(M=1024, K=3584, N=3584, r=8)),
    "7": ("lora_bgmv_seq", dict(M=8 * 512, K=3584, N=3584, r=8, slots=4,
                                ids=8)),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_frozen_costs_equal_the_ports(row):
    name, d = ROWS[row]
    a, b = costs.kernel_costs(name, **d), rl.kernel_costs(name, **d)
    assert (a.bytes, a.flops, a.exps) == (b.bytes, b.flops, b.exps)
    assert a.bound() == b.bound()


def test_peaks_equal_the_ports():
    assert costs.PEAK_FLOPS == rl.PEAK_FLOPS and costs.HBM_BW == rl.HBM_BW


def _bound(fn, name, *args, **kw):
    a = inspect.signature(fn).bind(*args, **kw)
    a.apply_defaults()
    host, dev, dtype = probes.dims(name, dict(a.arguments))
    d = {**host, **{k: int(v) for k, v in dev.items()}}
    mine = costs.kernel_costs(name, dtype, **d)
    theirs = rl._call_cost(name, dict(a.arguments), lambda t: t)
    return mine, theirs


def test_probe_dims_match_the_ports_count():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_bgmv as bg
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)           # noqa: E731
    B, T, Hq, Hkv, D = 3, 20, 4, 2, 8
    q, k, v = r(B, Hq, D), r(B, T, Hkv, D), r(B, T, Hkv, D)
    kv_pos = torch.tensor([list(range(12)) + [10 ** 9] * 8,
                           list(range(20)), list(range(5)) + [10 ** 9] * 15],
                          dtype=torch.int32)
    q_pos = torch.tensor([11, 19, 4], dtype=torch.int32)
    pk, pv = r(5, 4, Hkv, D), r(5, 4, Hkv, D)
    ids = torch.tensor([0, 3, 3], dtype=torch.int32)
    m, t = _bound(fd.flash_decode, "flash_decode", q, k, v, q_pos=q_pos,
                  kv_pos=kv_pos, prefix_k=pk, prefix_v=pv, prefix_ids=ids)
    assert (m.bytes, m.flops) == (t.bytes, t.flops)
    S = 6
    qs, ks = r(B, S, Hq, D), r(B, S + 4, Hkv, D)
    qp = torch.arange(S, dtype=torch.int32)
    kp = torch.cat([torch.full((4,), -1), torch.arange(S)]).int()
    m, t = _bound(fa.flash_attention, "flash_attention", qs, ks, ks,
                  q_pos=qp, kv_pos=kp)
    assert (m.bytes, m.flops) == (t.bytes, t.flops)
    x, w = r(B, S, 16), r(16, 12)
    a_, b_ = r(4, 16, 2), r(4, 2, 12)
    m, t = _bound(bg.lora_bgmv_seq, "lora_bgmv_seq", x, w, a_, b_, ids, 2.0)
    assert (m.bytes, m.flops) == (t.bytes, t.flops)
