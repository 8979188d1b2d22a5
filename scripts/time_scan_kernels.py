#!/usr/bin/env python3
"""Time the port's scan kernels of one source tree on the GPU.

    PYTHONPATH=<tree>/src python3 scripts/time_scan_kernels.py \\
        [--label NAME] [--reps 41] [--only PIECE[,PIECE...]]

Times ``selective_scan`` at falcon-mamba-7b's prefill shape (B 8, S 512,
d_inner 8192, N 16, an initial state per row, B and C as strided views of
the x_proj output) in bf16 and f32, and at a one-row refill (B 1, S 512,
bf16); and ``rglru_scan`` at recurrentgemma-2b's (B 8, S 512, W 2560, an
initial state per row) in bf16 and f32, and at a one-row refill (B 1, S
512, bf16). The training calls of the HFSL rounds (B 4, S 256, bf16):
each scan's forward without and with its checkpoint output, and its
backward kernel as ``_launch_bwd`` is called (no dh_final, the frozen
parameters' gradients not asked), fed the forward kernel's checkpoints
where the tree's forward stores them (a tree whose backward reruns the
forward takes no checkpoints). ``--only`` keeps the cases whose name
holds one of the pieces. Each with ``chip_smoke.Timer`` (median of CUDA-event
timings, L2 flushed before each launch) on inputs drawn from a fixed
seed, so that runs of two trees see the same inputs; then each call's
device time (``torch.profiler`` over 10 calls, L2 flushed before each,
the flush left out). ``repro_torch`` comes from ``PYTHONPATH``: run it
once per tree, alternating trees (parent, change, change, parent) within
one call to the card. Prints the card's name and power limit, then one
JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_scan_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer
    from scripts.time_lora_kernels import device_us
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import selective_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(reps=args.reps)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    mamba = get_config("falcon-mamba-7b")
    Di, dr, N = mamba.d_inner, mamba.dt_rank, mamba.ssm.d_state

    def scan_args(B, S, dtype):
        xdbc = rn(B, S, dr + 2 * N, s=0.5).to(dtype)    # the x_proj output
        return (rn(B, S, Di, s=0.5).to(dtype),
                (F.softplus(rn(B, S, Di)) * 0.1).to(dtype),
                -torch.exp(rn(Di, N, s=0.3)), xdbc[..., dr:dr + N],
                xdbc[..., dr + N:], rn(Di), rn(B, Di, N, s=0.1))

    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases[f"selective_scan_B8_S512_{str(dtype)[6:]}"] = partial(
            ss.selective_scan, *scan_args(8, 512, dtype))
    cases["selective_scan_B1_S512_bfloat16"] = partial(
        ss.selective_scan, *scan_args(1, 512, torch.bfloat16))
    W = get_config("recurrentgemma-2b").lru_width

    def lru_args(B, S, dtype):
        return (rn(B, S, W, s=0.5).to(dtype), rn(B, S, W).to(dtype),
                rn(B, S, W).to(dtype), rn(W), rn(B, W, s=0.1))

    for dtype in (torch.bfloat16, torch.float32):
        cases[f"rglru_scan_B8_S512_{str(dtype)[6:]}"] = partial(
            rg.rglru, *lru_args(8, 512, dtype))
    cases["rglru_scan_B1_S512_bfloat16"] = partial(
        rg.rglru, *lru_args(1, 512, torch.bfloat16))

    # the training calls; a tree whose forwards store checkpoints feeds
    # them to its backwards, as autograd does
    def train_cases(name, fwd, fargs, bwd, bargs, make_ck, **kw):
        cases[f"{name}_fwd_B4_S256_bfloat16"] = partial(fwd, *fargs)
        if "ck" in inspect.signature(fwd).parameters:
            ck = make_ck()
            fwd(*fargs, ck=ck)
            cases[f"{name}_fwd_ck_B4_S256_bfloat16"] = partial(fwd, *fargs,
                                                               ck=ck)
            kw["ck"] = ck
        cases[f"{name}_bwd_B4_S256_bfloat16"] = partial(bwd, *bargs, **kw)

    sargs = scan_args(4, 256, torch.bfloat16)
    train_cases("selective_scan", ss._launch, sargs, ss._launch_bwd,
                (*sargs, rn(4, 256, Di).to(torch.bfloat16)),
                lambda: ss.checkpoints(sargs[0], sargs[2]), need_A=False,
                need_D=False)
    x, r, i, a, _ = lru_args(4, 256, torch.bfloat16)
    largs = (x, r, i, a, rn(W, s=0.1).expand(4, W))     # a shared state
    train_cases("rglru_scan", rg._launch, (*largs, 8.0), rg._launch_bwd,
                (*largs, rn(4, 256, W).to(torch.bfloat16)),
                lambda: rg.checkpoints(x), need_a=False)
    if args.only:
        keep = args.only.split(",")
        cases = {k: v for k, v in cases.items()
                 if any(piece in k for piece in keep)}
    out = {"label": args.label, "source": ss.__file__, "device_us": {}}
    for name, fn in cases.items():
        out[f"{name}_ms"] = timer(fn)
    for name, fn in cases.items():
        out["device_us"][name] = device_us(fn, timer.flush)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
