"""The knee sweep of an open-loop cell (run once, when the cell is
defined; not by the benchmark's runs): the cell at each offered rate,
traced, printing the rate, the end-to-end tails, the output tokens per
second and the device's idle share. The rate that goes into the cell's
file is about four fifths of the highest rate the engine sustains
without a growing backlog.

    python3 portbench/sweep.py --workload qwen2-7b.bank-chat \
        --rates 4,6,8,10,12 --seconds 20 --seed 5

One JSON line per rate on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run  # noqa: F401  (sets the paths and caches as run.py does)
from run import ROOT, run_cell

from portbench.lib import registry


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(prog="portbench/sweep.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    base = registry.Registry.at(ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        reg = registry.Registry.at(ROOT)
        cell = base.cell(args.workload)
        cell["traffic"]["rate"] = rate
        reg.cell = lambda name, c=cell: c
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, True,
                       t_start=t0, reg=reg, every_metric=True)
        m = {k: v["value"] for k, v in out["metrics"].items()}
        print(json.dumps({"rate": rate, "seed": args.seed,
                          "seconds": args.seconds,
                          "correct": out["correct"],
                          "attempted": out["attempted"], "metrics": m,
                          "device": out["device"], "notes": out["notes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
