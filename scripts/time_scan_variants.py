#!/usr/bin/env python3
"""Time variants of the scan backward kernels against the tree's own, on
the GPU.

    python3 scripts/time_scan_variants.py [--reps 41] [--only NAME,...]

Each variant is a copy of ``src`` under ``build/variants/<name>/src``
(git-ignored) with one change to a kernel source; each copy builds its
own libraries. The tree itself runs first and last, and every variant
between, each through ``scripts/time_scan_kernels.py --only`` with the
copy's ``src`` on ``PYTHONPATH``. The variants:

- ``ss_states_in_smem``: ``selective_scan_bwd`` keeps a chunk's
  recomputed states in shared memory (a thread's in a row of its own,
  one 16-byte word a step) instead of registers;
- ``ss_exp_kept``: its reverse walk may reuse the recompute's
  exponentials (the compiler then keeps them in registers) instead of
  taking them again;
- ``ss_no_butterfly``: its dB and dC sums over the 32 lanes left out
  (wrong dB and dC: timing only, what the butterfly costs);
- ``ss_3_blocks``: its launch bounds ask for 3 blocks an SM instead of
  4, so each thread may take 170 registers instead of 128.

Prints each run's JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("repro_torch/kernels/csrc")

VARIANTS = {
    # a thread's states in a row of its own (padded by 4 words, so that
    # a quarter-warp's 16-byte accesses meet no bank twice)
    "ss_states_in_smem": ("selective_scan_bwd", [
        ("  float pd[2][LPC][TS][CB];         // ... of A (g e) h_{t-1}\n};",
         "  float pd[2][LPC][TS][CB];         // ... of A (g e) h_{t-1}\n"
         "  float hs[NT][TS * (NM / LPC) + 4];\n};"),
        ("    float hr[TS][NPL];",
         "    float (*hr)[NPL] = reinterpret_cast<float (*)[NPL]>(sm.hs[tid]);"),
    ]),
    "ss_exp_kept": ("selective_scan_bwd", [
        ("g[j] *= ex2_approx_anew(dv * a2[j]);",
         "g[j] *= ex2_approx(dv * a2[j]);")]),
    "ss_no_butterfly": ("selective_scan_bwd", [
        ("const float s = lane_sums<V>(v, lane);",
         "const float s = v[0] + v[V - 1];")]),
    "ss_3_blocks": ("selective_scan_bwd", [
        ("__launch_bounds__(NT, 4)", "__launch_bounds__(NT, 3)")]),
}


def variant_tree(name: str) -> Path:
    """``src`` copied under build/variants/<name> with the variant's
    change applied; returns the copy's ``src``."""
    kernel, edits = VARIANTS[name]
    dst = ROOT / "build" / "variants" / name / "src"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = dst / CSRC / f"{kernel}.cu"
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not once in {path}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def run(label: str, src: Path, reps: int, only: str) -> int:
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, str(ROOT / "scripts" / "time_scan_kernels.py"),
           "--label", label, "--reps", str(reps), "--only", only]
    return subprocess.run(cmd, env=env, cwd=ROOT).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=41)
    ap.add_argument("--only", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = args.only.split(",")
    only = ",".join(sorted({VARIANTS[n][0] for n in names}))
    rc = run("tree", ROOT / "src", args.reps, only)
    for name in names:
        rc |= run(name, variant_tree(name), args.reps, only)
    rc |= run("tree", ROOT / "src", args.reps, only)
    return rc


if __name__ == "__main__":
    sys.exit(main())
