"""The readings that a cell's limits are set from (not run by the
benchmark's own runs): for each seed, one run of the cell as the
benchmark makes it, printing the numbers a cell may compare
(``lib/check.py``: the program's served-token gaps against the float32
reference) and, for the first ``--control`` seeds, the control's on the
same sample (the reference computed in float8 e4m3 put in the program's
place: the gap of the token it puts first), which then decides that
run's ``correct``: it has to come out false. All seeds run in one
process.

    python3 portbench/controls.py --workload <cell> --seconds 10 \
        --seeds 11,12,13 --control 3

One JSON line per seed on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run  # noqa: F401  (sets the paths and caches as run.py does)
from run import ROOT, run_cell


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(prog="portbench/controls.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       t_start=t0, control=i < args.control)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": out["notes"]["program"],
                          "control": out["notes"].get("control"),
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "notes": out["notes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
