"""Serving launcher (counterpart of ``repro/launch/serve.py``).

- ``--impl scan`` (default): :func:`repro_torch.models.model.generate`,
  prefill plus ``--gen`` decode steps per request batch;
- ``--impl engine``: the ragged continuous-batching
  :class:`repro_torch.launch.engine.DecodeEngine`.

Weights are random, made from ``--seed``. Runs on ``cuda`` unless
``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --impl engine [--device cpu --reduced]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="vit-edge")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("scan", "engine"), default="scan")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    engine = DecodeEngine(cfg, slots=args.batch, seed=args.seed,
                          device=dev) if args.impl == "engine" else None
    for r in range(args.requests):
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len), dtype=np.int32)
        if engine is not None:
            toks, stats = engine.serve(params, prompts, gen=args.gen)
            print(f"[serve] round {r}: {stats.requests} requests, "
                  f"{stats.tokens} tokens in {stats.wall_s:.2f}s "
                  f"({stats.tok_per_s:.1f} tok/s, {stats.waves} waves); "
                  f"first row: {toks[0][:8]}")
            h = stats.ttft_hist
            print(f"[serve]   ttft p50={h['p50']:.3f}s p95={h['p95']:.3f}s "
                  f"p99={h['p99']:.3f}s")
            continue
        t0 = time.perf_counter()
        toks = M.generate(params, cfg, torch.as_tensor(prompts, device=dev),
                          gen=args.gen).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"[serve] request {r}: generated {toks.shape} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s); "
              f"first row: {toks[0][:8]}")


if __name__ == "__main__":
    main()
