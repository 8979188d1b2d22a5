#!/usr/bin/env python3
"""Time the full-size drains and training rounds of one source tree on the
GPU, through that tree's own ``chip_smoke.py``.

    PYTHONPATH=<tree>/src python3 scripts/time_drains.py --tree <tree> \\
        [--label NAME] [--seed 0] \\
        [--paths main,mamba,hybrid,train,scantrain,relay,moe]

Runs the tree's ``main_path`` (phases 4, 5, 13 and 19: qwen2-7b at its
published size single-tenant, from a 4-domain bank, paged from the bank,
speculative), ``mamba_path`` (phase 17: falcon-mamba-7b single-tenant and
from a bank), ``hybrid_path`` (phase 23: recurrentgemma-2b single-tenant
and from a bank), ``train_phases`` (phases 9 to 11: the HFSL rounds) and
``scan_train_phases`` (phases 26 and 27: the falcon-mamba-7b and
recurrentgemma-2b HFSL rounds; only with ``--paths scantrain``),
``relay_phase`` (phase 29 on a full-size qwen2-7b backbone: the host ms
of each relay call; only with ``--paths relay``) and ``moe_phases``
(phases 33 to 35: granite-moe-1b-a400m's drains, decode step and HFSL
rounds; only with ``--paths moe``), or those
of them ``--paths`` names, checks included, and prints the card's name
and power limit, then one JSON line with each drain's tok/s, TTFT p50 /
p99 and per-token latency p50, and each round's seconds a step (the
scan families' also examples a second and peak memory). The tree's kernels are built before the first drain, so
that no drain waits for ``nvcc``. These drains are host-bound, and their
numbers spread between calls to the card, so compare two trees only
within one call: run this once per tree, alternating trees (parent,
change, change, parent). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

KEYS = ("tok_per_s", "ttft_p50_s", "ttft_p99_s", "tok_latency_p50_s",
        "step_s", "examples_per_s", "peak_mem_gib", "step_ms")


def numbers(rec: dict) -> dict:
    """The timing fields of a phase's record and of the records in it."""
    out = {k: rec[k] for k in KEYS if k in rec}
    for name, sub in rec.items():
        if isinstance(sub, dict) and any(k in sub for k in KEYS):
            out[name] = {k: sub[k] for k in KEYS if k in sub}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose chip_smoke.py runs")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", default="main,mamba,hybrid,train",
                    help="comma-separated: main, mamba, hybrid, train, "
                         "scantrain, relay, moe")
    args = ap.parse_args(argv)
    paths = set(args.paths.split(","))
    if not torch.cuda.is_available():
        print("time_drains: needs a CUDA device", file=sys.stderr)
        return 2
    path = Path(args.tree).resolve() / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    out = {"label": args.label, "source": str(path)}
    if "main" in paths:
        main, bank, paged, spec_rec, *mesh = smoke.main_path(args.seed)
        out.update(main=numbers(main), bank=numbers(bank),
                   paged=numbers(paged), spec=numbers(spec_rec))
        if mesh:                      # a tree with phase 45's mesh drain
            out["mesh"] = numbers(mesh[0])
    if "mamba" in paths:
        mamba, mamba_bank = smoke.mamba_path(args.seed)
        out.update(mamba=numbers(mamba), mamba_bank=numbers(mamba_bank))
    if "hybrid" in paths:
        hybrid, hybrid_bank = smoke.hybrid_path(args.seed)
        out.update(hybrid=numbers(hybrid), hybrid_bank=numbers(hybrid_bank))
    if "train" in paths:
        train = smoke.train_phases(args.seed)
        out["train"] = {k: numbers(v) for k, v in train.items()
                        if isinstance(v, dict) and "step_s" in v}
    if "scantrain" in paths:
        out["scantrain"] = {k: numbers(v) for k, v in
                            smoke.scan_train_phases(args.seed).items()}
    if "relay" in paths:
        out["relay_host_ms"] = relay_host_ms(smoke, args.seed)
    if "moe" in paths:
        out["moe"] = numbers(smoke.moe_phases(args.seed))
    print(json.dumps(out), flush=True)
    return 0


def relay_host_ms(smoke, seed: int) -> dict:
    """Phase 29 as the tree's ``knowledge_flow`` runs it (qwen2-7b at its
    published size, a 5-class head): the host ms of each relay call."""
    import dataclasses
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen2-7b")
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    backbone = M.init(cfg, seed, device="cuda")["backbone"]
    with tempfile.TemporaryDirectory() as tmp:
        rec, _, _ = smoke.relay_phase(cfg, backbone, seed, tmp)
    del backbone
    torch.cuda.empty_cache()
    return {"clean": rec["host_ms"], "lossy": rec["lossy_host_ms"]}


if __name__ == "__main__":
    sys.exit(main())
