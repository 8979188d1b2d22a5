#!/usr/bin/env python3
"""Hold two source trees' decode kernels to the same bits on the GPU.

    PYTHONPATH=<tree>/src python3 scripts/decode_bits.py --out A.pt
    python3 scripts/decode_bits.py --compare A.pt B.pt

``--out`` runs ``flash_decode`` (dense; f32 and bf16; windows 0, 8 and
2048; the shapes of ``tests/test_torch_cuda.py::test_flash_decode_kernel``)
and ``flash_decode_paged`` (bf16 and f32, shared and per-row prefix
banks) of the tree on ``PYTHONPATH`` on inputs drawn from a fixed seed,
with no ``return_lse``, and saves every output with ``torch.save``.
``--compare`` prints one JSON line: the cases, and those whose outputs
differ in any bit; it exits 1 if any does. Run ``--out`` once per tree
(each builds its own kernels), then ``--compare``. Needs a CUDA device
for ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

DENSE = [(1, 1, 0, 2, 2, 16), (3, 45, 4, 7, 1, 64), (8, 300, 16, 28, 4, 128),
         (2, 33, 0, 32, 2, 128), (8, 300, 16, 10, 1, 256),
         (2, 45, 0, 6, 2, 160), (2, 1, 0, 1, 1, 64), (3, 63, 3, 7, 1, 128),
         (2, 64, 70, 16, 1, 64), (2, 65, 16, 10, 1, 256),
         (2, 300, 70, 16, 2, 8), (1, 300, 3, 7, 1, 160),
         (4, 65, 0, 28, 4, 128), (2, 63, 16, 16, 1, 256),
         (8, 1024, 16, 28, 4, 128)]
# (B, maxb, bs, n_p, Hq, Hkv, D)
PAGED = [(8, 64, 16, 16, 28, 4, 128), (3, 7, 8, 3, 7, 1, 64),
         (2, 5, 16, 0, 4, 2, 128)]


def outputs() -> dict:
    from repro_torch.kernels import ops
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in DENSE:
            B, T, n_p, Hq, Hkv, D = case
            g = torch.Generator(device="cuda").manual_seed(sum(case))

            def rn(*s):
                return torch.randn(s, generator=g, device="cuda").to(dtype)
            q, k, v = rn(B, Hq, D), rn(B, T, Hkv, D), rn(B, T, Hkv, D)
            pk = rn(n_p, Hkv, D) if n_p else None
            pv = rn(n_p, Hkv, D) if n_p else None
            qp = torch.randint(0, T, (B,), generator=g, device="cuda",
                               dtype=torch.int32)
            slots = torch.arange(T, dtype=torch.int32, device="cuda")[None]
            kp = torch.where(slots <= qp[:, None], slots,
                             torch.full_like(slots, 10 ** 9)).contiguous()
            for window in (0, 8, 2048):
                out[f"dense {case} w{window} {dtype}"] = ops.flash_decode(
                    q, k, v, q_pos=qp, kv_pos=kp, prefix_k=pk, prefix_v=pv,
                    window=window)
        for case in PAGED:
            B, maxb, bs, n_p, Hq, Hkv, D = case
            g = torch.Generator(device="cuda").manual_seed(sum(case))

            def rn(*s):
                return torch.randn(s, generator=g, device="cuda").to(dtype)
            nb = B * maxb + 3
            q = rn(B, Hq, D)
            kpool, vpool = rn(nb, bs, Hkv, D), rn(nb, bs, Hkv, D)
            table = torch.randperm(nb, generator=g, device="cuda")[
                :B * maxb].reshape(B, maxb).to(torch.int32)
            qp = torch.randint(0, maxb * bs, (B,), generator=g,
                               device="cuda", dtype=torch.int32)
            for per_row in (False, True):
                shape = (B, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
                pk = rn(*shape) if n_p else None
                pv = rn(*shape) if n_p else None
                out[f"paged {case} per_row {per_row} {dtype}"] = \
                    ops.flash_decode_paged(q, kpool, vpool, table, q_pos=qp,
                                           prefix_k=pk, prefix_v=pv)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/decode_bits.py")
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.out:
        if not torch.cuda.is_available():
            print("decode_bits: no CUDA device", file=sys.stderr)
            return 2
        torch.save(outputs(), args.out)
        print(f"decode_bits: {args.out} on "
              f"{torch.cuda.get_device_name(0)}")
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        differ = sorted(k for k in a if k not in b
                        or not torch.equal(a[k], b[k]))
        print(json.dumps({"cases": len(a), "differ": differ}))
        return 1 if differ or set(a) != set(b) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
