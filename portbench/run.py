"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It makes the cell's weights, adapters and
traffic from ``--seed``, builds (first run in a checkout) or loads the
port's kernels, warms up, measures for ``--seconds``, checks what the
timed path served against the plain reference, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a profiled sub-window), ``device`` and the
numbers compared beside their limits (``checks``, last). It exits
non-zero, printing no result, without a CUDA device, or when the process
holds ``jax``, ``jaxlib``, ``flax`` or ``repro`` after the window.

Everything a cell needs is found by name (``lib/registry.py``):
``BENCHMARK.json`` at the root, ``workloads/<cell>.json``, the cell's
configuration file, ``drivers/<kind>.py``, ``metrics/<metric>.py``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# kernel caches at fixed paths inside the checkout (the port's own CUDA
# libraries build into src/repro_torch/kernels/build/)
_CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
# the caching allocator maps its segments as they grow, as a server that
# serves waves of changing shapes is run: without it, blocks freed by one
# wave's shapes are left unusable by the next wave's (the moe cell's first
# wave ran out of memory with 24 GiB reserved and unallocated)
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

import torch  # noqa: E402

from portbench.lib import registry, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Ctx:
    """One run: its cell, configuration, seed and instruments."""

    def __init__(self, root: Path, reg, name: str, seed: int,
                 seconds: float, traced: bool, device, t_start: float):
        from repro_torch.configs.base import get_config
        self.root, self.reg, self.name = root, reg, name
        self.workload = reg.workload(name)
        self.cell = reg.cell(name)
        self.conf = reg.config(self.workload["config"])
        self.sizes = self.conf["sizes"]
        self.cfg = configure(get_config(self.conf["registry"]),
                             self.conf.get("override", {}))
        agree(self.cfg, self.sizes)
        self.reference = importlib.import_module(
            "portbench.reference." + self.conf["reference"])
        self.seed, self.seconds, self.trace = seed, seconds, traced
        self.device = torch.device(device)
        self.t_start = t_start
        self.tel = self.probes = self.window = None
        self.window_start = self.t_ready = None
        self.memory_peak = 0
        self.check_s = 0.0
        self.checked_tokens = 0
        self.control = False               # controls.py: read the control too
        self.notes: dict = {}              # driver's remarks for the record
        if traced:
            from repro_torch.core.telemetry import Telemetry
            from portbench.lib.probes import Probes
            self.tel = Telemetry(enabled=True)
            self.probes = Probes().install()

    def ready(self) -> None:
        self.t_ready = time.perf_counter()

    def open_window(self, start: float, seconds: float) -> None:
        if self.device.type == "cuda":
            self.window = trace.SubWindow(start, seconds, self.probes)

    def mark_memory(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def configure(cfg, override: dict):
    """The registry's configuration with the file's overrides (a nested
    group, such as ``moe``, by its fields)."""
    import dataclasses
    kw = {}
    for k, v in override.items():
        cur = getattr(cfg, k)
        kw[k] = dataclasses.replace(cur, **v) if isinstance(v, dict) else v
    return dataclasses.replace(cfg, **kw) if kw else cfg


def agree(cfg, sz: dict) -> None:
    """The configuration file's sizes are the ones the program runs."""
    m, p = cfg.moe, cfg.peft
    have = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "qkv_bias": cfg.qkv_bias,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "tie_embeddings": cfg.tie_embeddings, "dtype": cfg.dtype,
            "n_prefix": p.n_prefix, "lora_rank": p.lora_rank,
            "lora_alpha": p.lora_alpha,
            "lora_targets": list(p.lora_targets)}
    if cfg.family == "moe":
        have.update(n_experts=m.n_experts, top_k=m.top_k,
                    d_ff_expert=m.d_ff_expert,
                    capacity_factor=m.capacity_factor)
    bad = {k: (v, sz.get(k)) for k, v in have.items() if sz.get(k) != v}
    if bad:
        raise ValueError(f"configuration file and program disagree: {bad}")


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float = None,
             reg=None, control: bool = False,
             every_metric: bool = False) -> dict:
    """One run of cell ``name``; returns the result line's object. With
    ``control`` (``controls.py``, never the benchmark's runs) the control,
    put in the program's place on the same sample, is what the checks
    judge (the program's own readings stay in ``notes``); ``every_metric``
    (``sweep.py``) reads the end-to-end metrics in a traced run too."""
    reg = reg or registry.Registry.at(root)
    ctx = Ctx(root, reg, name, seed, seconds, traced, device,
              T_START if t_start is None else t_start)
    ctx.control = control
    if ctx.device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    driver = reg.driver(ctx.cell["driver"])
    obs = driver.run(ctx)
    if ctx.probes is not None:
        ctx.probes.uninstall()
    obs["setup_s"] = ctx.window_start - ctx.t_start
    obs["sizes"] = ctx.sizes
    tr = None
    if ctx.window is not None and ctx.window.path:
        tr = trace.read(ctx.window.path, ctx.window.window_s)
        tr["bounds"] = ctx.probes.bounds_ms()
        obs["trace"] = tr
    metrics = {}
    kinds = {traced} | ({False} if every_metric else set())
    for m in [m for t in sorted(kinds) for m in reg.metrics(name, t)]:
        v = reg.reader(m["name"]).read(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = dict(obs["checks"])
    checks["failed_requests"] = {"value": obs["failed"], "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(ctx.workload.get("chips", 1)),
           "memory_peak_bytes": ctx.memory_peak}
    if traced:
        dev["busy_s"] = tr["busy_s"] if tr else 0.0
        dev["window_s"] = tr["window_s"] if tr else 0.0
    out = {"correct": bool(correct), "attempted": int(obs["attempted"]),
           "failed": int(obs["failed"]), "metrics": metrics, "device": dev}
    if tr:
        out["breakdown"] = trace.breakdown(tr)
        ctx.notes["device_groups_s"] = tr["groups_s"]
    out["notes"] = {**ctx.notes, "check_s": ctx.check_s,
                    "checked_tokens": ctx.checked_tokens,
                    "setup_to_ready_s": (ctx.t_ready - ctx.t_start)
                    if ctx.t_ready else None}
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:                     # noqa: BLE001
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        print("portbench: no BENCHMARK.json at the checkout's root",
              file=sys.stderr)
        return 2
    chips = int(registry.Registry.at(ROOT).workload(args.workload)
                .get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    out["notes"]["card"] = card()
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
