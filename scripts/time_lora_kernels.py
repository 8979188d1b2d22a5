#!/usr/bin/env python3
"""Time the port's LoRA kernels of one source tree on the GPU.

    PYTHONPATH=<tree>/src python3 scripts/time_lora_kernels.py \\
        [--label NAME] [--reps 41]

Times, at qwen2-7b's q (N 3584) and v (N 512) projections with K 3584,
r 8 and a bias: ``lora_matmul`` at decode (M 8) and prefill (M 4096), bf16;
``lora_bgmv_rows`` at M 8 and ``lora_bgmv_seq`` at B 8 x S 512 over 4
slots, bf16; the HFSL backward's ``dx`` shape (dy M 1024 against Wᵀ) in
bf16; ``lora_matmul_bwd`` at the round's shapes (M 1024, both N, bf16 and
f32) beside the library call computing the same (``dy Bᵀ``, ``xᵀ g``,
``x A``, ``uᵀ dy``); and f32 ``lora_matmul`` at M 4096, N 3584. Each with
``chip_smoke.Timer`` (median of CUDA-event timings, L2 flushed before each
launch) on inputs drawn from a fixed seed, so that runs of two trees see
the same inputs; then each call's device time per kernel (``torch.profiler``
over 10 calls, L2 flushed before each, the flush left out), which splits a
bf16 call into its u pass and its tile. ``repro_torch`` comes from
``PYTHONPATH``: run it once per tree, alternating trees (parent, change,
change, parent) within one call to the card. Prints the card's name and
power limit, then one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def device_us(fn, flush, calls: int = 10) -> dict:
    """Device time (us) per kernel in one call of ``fn``, from
    ``torch.profiler`` over ``calls`` calls, L2 flushed before each (the
    flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {_kernel_name(e.key): e.device_time_total / calls
            for e in prof.key_averages()
            if e.device_time_total > 0 and "elementwise" not in e.key}


def _kernel_name(key: str) -> str:
    """A demangled kernel signature cut to its qualified name."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", key, maxsplit=1)[0]


def _library_bwd(x, dy, a, b, scale):
    """The adapter gradients in four PyTorch products."""
    g = dy @ b.t()
    return scale * (x.t() @ g), scale * ((x @ a).t() @ dy)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=41)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lora_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer
    from repro_torch.kernels import lora_bgmv as bg
    from repro_torch.kernels import lora_matmul as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(reps=args.reps)

    def randn(*shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * s).to(dtype)

    K, r, scale = 3584, 8, 2.0
    cases = {}
    for N in (3584, 512):
        w, bias = randn(K, N, s=K ** -0.5), randn(N, s=0.1)
        a, b = randn(K, r, s=K ** -0.5), randn(r, N, s=0.1)
        for M in (8, 4096):
            cases[f"lora_matmul_M{M}_N{N}"] = partial(
                lm.lora_matmul, randn(M, K), w, a, b, scale, bias)
        # dx of the backward: dy (1024, N) against Wᵀ (N, K), Bᵀ, Aᵀ
        cases[f"lora_matmul_dx_M1024_N{N}"] = partial(
            lm.lora_matmul, randn(1024, N), w.t().contiguous(),
            b.t().contiguous(), a.t().contiguous(), scale)
        sa, sb = randn(4, K, r, s=K ** -0.5), randn(4, r, N, s=0.1)
        ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0], dtype=torch.int32,
                           device="cuda")
        cases[f"lora_bgmv_rows_M8_N{N}"] = partial(
            bg.lora_bgmv_rows, randn(8, K), w, sa, sb, ids, scale, bias)
        cases[f"lora_bgmv_seq_B8xS512_N{N}"] = partial(
            bg.lora_bgmv_seq, randn(8, 512, K), w, sa, sb, ids, scale, bias)
    f32 = dict(dtype=torch.float32)
    for dtype in (torch.bfloat16, torch.float32):
        for N in (3584, 512):
            x, dy = randn(1024, K, dtype=dtype), randn(1024, N, dtype=dtype)
            a = randn(K, r, dtype=dtype, s=K ** -0.5)
            b = randn(r, N, dtype=dtype, s=0.1)
            tag = f"M1024_N{N}_{str(dtype)[6:]}"
            cases[f"lora_matmul_bwd_{tag}"] = partial(
                lm.lora_matmul_bwd, x, dy, a, b, scale)
            cases[f"library_bwd_{tag}"] = partial(_library_bwd, x, dy, a, b,
                                                  scale)
    cases["lora_matmul_f32_M4096_N3584"] = partial(
        lm.lora_matmul, randn(4096, K, **f32),
        randn(K, 3584, s=K ** -0.5, **f32), randn(K, r, s=K ** -0.5, **f32),
        randn(r, 3584, s=0.1, **f32), scale, randn(3584, s=0.1, **f32))
    out = {"label": args.label, "source": lm.__file__, "device_us": {}}
    for name, fn in cases.items():
        out[f"{name}_ms"] = timer(fn)
    for name, fn in cases.items():
        out["device_us"][name] = device_us(fn, timer.flush)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
