"""Profile of one step on the card (counterpart of
``repro/launch/profile.py``).

    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2-7b \
        --shape decode_32k [--top 15] [--seed 0] [--reps 5] [--json PATH]

The reference breaks a compiled step's HLO down by opcode and by single
op. The port runs the step on the card, at the dry-run's shape for one
data row, with random weights from ``--seed``: a warm-up, ``--reps``
timed steps and ``--reps`` traced ones. It prints:

- ``profile_costs``: the count's bytes by op class (each kernel one
  class) and its top single ops (``roofline.count_costs`` on ``meta``);
- from ``torch.profiler``: device time per kernel name and per group
  (the port's CUDA kernels, GEMMs, the rest), of the traced step of the
  median busy time, and the device's busy share: that busy time over
  the step time (tracing slows the host, not the kernels; a
  device-bound step can read a little over 1, its traced kernels
  running a little longer than the untraced step's median);
- the port's kernel launches (``ops.launch_counts()``);
- ``torch.cuda.max_memory_allocated`` (less what the process held
  before the step's tensors were made) beside the dry-run's estimate;
- the step's MFU, ``model_flops / step_s / PEAK_FLOPS`` with the median
  of the timed steps, beside the roofline's bound;
- the card's name and power limit (``nvidia-smi``).

Before anything is allocated it refuses a shape that the dry-run says
does not fit one H100. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models.attention import param_dtype

# substrings of the port's CUDA kernels' names (kernels/csrc)
PORT_KERNELS = ("lora_", "attn_wgmma", "flash_attention", "flash_decode",
                "decode_split", "selective_scan", "rglru_scan")


def group(name: str) -> str:
    """The group of a device kernel (``scripts/profile_hfsl.py``'s)."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "cublas",
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


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def profile_costs(costs: rl.StepCosts, top: int = 15) -> dict:
    """The reference's ``profile_hlo`` from a count: bytes by op class,
    the top single ops by bytes, the collectives (none on one card)."""
    by_op = dict(sorted(costs.op_bytes.items(), key=lambda kv: -kv[1]))
    return {"bytes": costs.bytes_accessed, "by_op": by_op,
            "top_ops": costs.top_ops[:top],
            "collectives": dict(costs.collectives)}


def _device_times(prof) -> tuple[dict, float]:
    """{kernel name: [launches, device us]} and the busy us of a trace."""
    from torch.autograd import DeviceType
    kernels: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        row = kernels.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    return kernels, busy_us(spans)


def profile_step(arch: str, shape, *, top: int = 15, seed: int = 0,
                 reps: int = 5, device=None, verbose: bool = True) -> dict:
    """``reps`` steps of (arch, shape) on the card after a warm-up, then
    ``reps`` more traced (see the module's docstring); ``shape`` as
    ``dryrun.build_step`` takes it. The step time is the median of the
    untraced steps; the device times are those of the traced step of the
    median busy time, and its busy share is of the step time. ``status``
    ``"refused"`` when the dry-run says it does not fit."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ops

    dry, costs = dryrun.count_one(arch, shape)
    if dry["status"] != "ok" or not dry["fits_one_h100"]:
        return {"arch": arch, "shape": dry["shape"], "status": "refused",
                "reason": dry.get("reason") or "the dry-run's peak "
                f"{dry['memory_analysis']['peak_memory_in_bytes']} B does "
                "not fit one H100", "dryrun": dry}
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile: the step is timed on the card; no "
                           "CUDA device was given")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    # what the process held before (a caller's buffers) is not the step's
    base = torch.cuda.memory_allocated(dev)
    fn, args, meta = dryrun.build_step(arch, shape, device=dev, seed=seed)

    def step():
        out = fn(*args)
        torch.cuda.synchronize()
        return out

    step()                                      # warm-up, result freed
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = step()
    times = [time.perf_counter() - t0]
    peak = torch.cuda.max_memory_allocated(dev) - base
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    del out
    for _ in range(reps - 1):
        t0 = time.perf_counter()
        out = step()
        times.append(time.perf_counter() - t0)
        del out
    step_s = statistics.median(times)
    traced = []                              # (busy us, wall us, kernels)
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step()
            wall_us = (time.perf_counter() - t0) * 1e6
        del out
        kernels, busy = _device_times(prof)
        if not kernels:
            raise RuntimeError("profile: the profiler recorded no device "
                               "activity")
        traced.append((busy, wall_us, kernels))
    # the traced step of the median busy time; its share is of the untraced
    # step's time (tracing slows the host, not the kernels)
    busy, wall_us, kernels = sorted(traced, key=lambda t: t[0])[reps // 2]
    device_us = sum(t for _, t in kernels.values())
    groups: dict = defaultdict(float)
    for name, (_, t) in kernels.items():
        groups[group(name)] += t
    est = dry["memory_analysis"]["peak_memory_in_bytes"]
    dtype = param_dtype(meta["cfg"])
    result = {
        "arch": arch, "shape": meta["shape"], "status": "ok",
        "card": card(),
        "batch": meta["batch"], "global_batch": meta["global_batch"],
        "seq_len": meta["shape_obj"].seq_len, "step_s": step_s,
        "steps_s": times,
        "busy_shares": sorted(t[0] / 1e6 / step_s for t in traced),
        "model_flops": dry["model_flops"],
        "mfu": rl.mfu(dry["model_flops"], step_s, dtype),
        "mfu_bound": dry["mfu_bound"],
        "bottleneck": dry["roofline"]["bottleneck"],
        "peak_bytes": peak, "held_before_bytes": base,
        "peak_estimate_bytes": est,
        "peak_over_estimate": peak / est,
        "launches": launches, "kernel_calls": dict(costs.kernel_calls),
        "profiled_wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
        "busy_share": busy / 1e6 / step_s, "device_ms": device_us / 1e3,
        "device_kernels": sum(n for n, _ in kernels.values()),
        "groups_ms": {g: t / 1e3 for g, t in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "kernels": [dict(name=n, launches=c, ms=t / 1e3) for n, (c, t) in
                    sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]],
        "profile_costs": profile_costs(costs, top),
    }
    if verbose:
        print(report(result))
    return result


def report(r: dict) -> str:
    """The printed form of a profile."""
    lines = [f"== {r['arch']} x {r['shape']} (batch {r['batch']} of "
             f"{r['global_batch']}, seq {r['seq_len']}) on {r['card']} ==",
             f"step {r['step_s'] * 1e3:.3f} ms (median of "
             f"{len(r['steps_s'])}: {min(r['steps_s']) * 1e3:.3f}-"
             f"{max(r['steps_s']) * 1e3:.3f}); MFU {r['mfu']:.4f} (the "
             f"roofline's bound {r['mfu_bound']:.4f}, {r['bottleneck']}-"
             "bound)",
             f"peak memory {r['peak_bytes'] / 1e9:.3f} GB, the dry-run's "
             f"estimate {r['peak_estimate_bytes'] / 1e9:.3f} GB (x "
             f"{r['peak_over_estimate']:.3f})",
             f"launches {r['launches']}",
             f"traced step of the median busy share (of "
             f"{100 * r['busy_shares'][0]:.1f}-"
             f"{100 * r['busy_shares'][-1]:.1f} % of the step): wall "
             f"{r['profiled_wall_ms']:.3f} ms traced, device "
             f"busy {r['busy_ms']:.3f} ms ({100 * r['busy_share']:.1f} %), "
             f"kernel time {r['device_ms']:.3f} ms in "
             f"{r['device_kernels']} kernels"]
    for g, t in r["groups_ms"].items():
        lines.append(f"  {g:18s} {t:10.3f} ms  "
                     f"{100 * t / r['device_ms']:5.1f} %")
    for k in r["kernels"]:
        lines.append(f"  {k['ms']:9.3f} ms {k['launches']:6d}x  "
                     f"{k['name'][:100]}")
    pc = r["profile_costs"]
    lines.append(f"per-op-class bytes (count, {pc['bytes']:.3e} in all):")
    for k, v in list(pc["by_op"].items())[:12]:
        lines.append(f"  {k:22s} {v:11.3e}  ({v / pc['bytes']:6.1%})")
    lines.append("top single ops by bytes:")
    for nb, op, shapes in pc["top_ops"]:
        lines.append(f"  {nb:10.3e} {op:18s} {shapes}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default cuda; the step is timed on the card")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    r = profile_step(args.arch, args.shape, top=args.top, seed=args.seed,
                     reps=args.reps, device=args.device)
    if r["status"] != "ok":
        print(f"[profile] {args.arch} x {args.shape} refused: {r['reason']}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(r, f, indent=1, default=str)
    return 0 if r["status"] == "ok" else 2


if __name__ == "__main__":
    sys.exit(main())
