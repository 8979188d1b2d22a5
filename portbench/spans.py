"""Traced runs of a cell with what the program's own profiler ranges say
(not run by the benchmark's own runs): for each seed, one ``--trace 1``
run of the cell as the benchmark makes it, with the profiler's trace
file read by ``lib/program.py::read_trace`` before ``lib/trace.py::read``
deletes it. Beside the run's metrics it prints the notes
``launches_per_step`` and ``syncs_per_step`` (CUDA launch and blocking
calls inside the ``model.decode_step`` ranges), ``idle_gaps_by_span``
(the device's idle gaps by the innermost program range) and
``step_host_ms_by_span`` (each span's self time a step). All seeds run
in one process.

    python3 portbench/spans.py --workload <cell> --seconds 30 --seeds 11,12

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

from portbench.lib import program, registry, trace


class Seen(registry.Registry):
    """The benchmark's registry, keeping the run's observations."""

    seen: dict

    def driver(self, kind: str):
        mod, seen = super().driver(kind), self.seen

        class Driver:
            @staticmethod
            def run(ctx):
                seen["obs"] = mod.run(ctx)
                return seen["obs"]
        return Driver


def traced(root, workload: str, seed: int, seconds: float, t0: float,
           device: str = "cuda", home=registry.HERE) -> dict:
    """One traced run of ``workload`` (found as ``run.py`` finds it, from
    ``root`` and ``home``): its result line, with the program's notes."""
    reg = Seen.at(root, home)
    reg.seen = {}
    read = trace.read

    def read_both(path, window_s):
        reg.seen["trace"] = program.read_trace(path)
        return read(path, window_s)
    trace.read = read_both
    try:
        out = run_cell(root, workload, seed, seconds, True, device=device,
                       t_start=t0, reg=reg)
    finally:
        trace.read = read
    out["notes"].update(program.notes(reg.seen["obs"],
                                      reg.seen.get("trace")))
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(prog="portbench/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out = traced(ROOT, args.workload, seed, args.seconds, t0)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "device": out["device"], "notes": out["notes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
