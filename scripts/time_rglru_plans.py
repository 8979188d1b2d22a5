#!/usr/bin/env python3
"""Time the RG-LRU scan under each of its two plans across batch sizes.

    PYTHONPATH=src python3 scripts/time_rglru_plans.py [--reps 41]

``rglru_scan.plan`` runs a grid of at least two blocks for each SM with 4
warps a block and a ring 2 tiles ahead, and a smaller grid with 16 warps
and 3 tiles ahead. This times ``rglru_scan`` at recurrentgemma-2b's width
(S 512, W 2560, bf16, an initial state per row) for B 1, 2, 3, 4, 6 and 8
under both plans, so that the switch between them can be read off: each
with ``chip_smoke.Timer`` (median of CUDA-event timings, L2 flushed
before each launch) and its device time (``torch.profiler`` over 10
calls). The plan is forced by wrapping ``plan`` for the duration of a
case; the kernel's launch records the plan it ran, which is checked.
Prints the card's name and power limit, then one JSON line. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PLANS = ((4, 2), (16, 3))                   # (warps, ahead)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=41)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_rglru_plans: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer
    from scripts.time_lora_kernels import device_us
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(reps=args.reps)
    W, S = get_config("recurrentgemma-2b").lru_width, 512
    planned = rg.plan
    out = {"n_sm": None, "cases": []}

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * s

    for B in (1, 2, 3, 4, 6, 8):
        ins = (rn(B, S, W, s=0.5).bfloat16(), rn(B, S, W).bfloat16(),
               rn(B, S, W).bfloat16(), rn(W), rn(B, W, s=0.1))
        n_sm = _build.sm_count(ins[0])
        out["n_sm"] = n_sm
        chosen = planned(B, W, torch.bfloat16, n_sm)
        for warps, ahead in PLANS:
            rg.plan = lambda *a, **k: dict(planned(*a, **k), warps=warps,
                                           ahead=ahead)
            try:
                rg.rglru(*ins)
                ran = rg.last_plan
                assert (ran["warps"], ran["ahead"]) == (warps, ahead), ran
                ms = timer(lambda: rg.rglru(*ins))
                dev = device_us(lambda: rg.rglru(*ins), timer.flush)
            finally:
                rg.plan = planned
            out["cases"].append(dict(
                B=B, blocks=ran["blocks"], warps=warps, ahead=ahead,
                planned=(chosen["warps"], chosen["ahead"]) == (warps, ahead),
                ms=ms, device_us=dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
