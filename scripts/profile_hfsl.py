#!/usr/bin/env python3
"""Where the time of an HFSL training round goes on the GPU.

    python3 scripts/profile_hfsl.py [--arch qwen2-7b] [--batch 4]
        [--seq 256] [--json-out PATH]

Builds the port's kernels, makes an HFSL train state of 2 clusters at the
config's full size (random weights from seed 0; a 5-class head) and a
ClassificationTask bank (Markov vocab 1000), runs one warm-up round of one
step, then traces one more with ``torch.profiler`` (CPU and CUDA
activity). Prints the card's name and power limit, the round's wall time,
the device time by kernel and by group (the port's CUDA kernels, GEMMs,
other device work) and the device's busy share of the wall time. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CLUSTERS, TOP = 2, 20
PORT_KERNELS = ("lora_matmul_kernel", "lora_bwd_rank_kernel",
                "lora_bwd_sweep_kernel", "flash_attention_kernel",
                "flash_decode_kernel", "lora_bgmv_rows_kernel",
                "lora_bgmv_seq_kernel")


def group(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "GEMM (cuBLAS)"
    return "other device work"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_hfsl.py")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_hfsl: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.data.noniid import partition_by_classes
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    cfg = get_config(args.arch)
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    opt = adamw(5e-3)
    state = hfsl.init_hfsl_state(0, cfg, CLUSTERS, opt, M.init,
                                 device="cuda")
    task = ClassificationTask(5, min(cfg.vocab_size, 1000), args.seq)
    data = task.dataset(200 * CLUSTERS, seed=11)
    parts = partition_by_classes(data["label"], CLUSTERS, 5)
    bank = BatchBank.pack(data, parts, args.batch, device="cuda")
    rnd = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=1,
                               sync_every=2)
    rnd(state, bank.arrays, 0)                       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rnd(state, bank.arrays, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels: dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        row = kernels.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += us
        spans.append((e.time_range.start, e.time_range.end))
    if not kernels:
        print("profile_hfsl: the profiler recorded no device activity",
              file=sys.stderr)
        return 1
    device_us = sum(t for _, t in kernels.values())
    groups: dict[str, float] = {}
    for name, (_, t) in kernels.items():
        groups[group(name)] = groups.get(group(name), 0.0) + t
    busy = busy_us(spans)
    print(f"{cfg.name} {cfg.n_layers} layers d {cfg.d_model}: one step x "
          f"{CLUSTERS} clusters x batch {args.batch} x seq {args.seq}: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} % "
          f"of wall), kernel time {device_us / 1e3:.3f} ms in "
          f"{sum(n for n, _ in kernels.values())} launches")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:18s} {t / 1e3:10.3f} ms  {100 * t / device_us:5.1f} %")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    for name, (n, t) in top:
        print(f"  {t / 1e3:9.3f} ms {n:6d}x  {name[:110]}")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            gpu=smi, config=f"{cfg.name} {cfg.n_layers}x{cfg.d_model}",
            clusters=CLUSTERS, batch=args.batch,
            seq=args.seq, wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
            kernel_ms=device_us / 1e3,
            groups_ms={g: t / 1e3 for g, t in groups.items()},
            kernels=[dict(name=n_, launches=c, ms=t / 1e3)
                     for n_, (c, t) in sorted(kernels.items(),
                                              key=lambda kv: -kv[1][1])]),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
