"""Serving launcher (counterpart of ``repro/launch/serve.py``).

Prefill + decode against a fine-tuned, adapter-loaded model: the
parameter-efficient deployment path (§III-A.2). The backbone is made
locally (presumed synchronized); only the adapters come from a checkpoint
(``--adapters``, written by ``checkpoint/io.py::save_adapters``).

- ``--impl scan`` (default): :func:`repro_torch.models.model.generate`,
  prefill plus ``--gen`` decode steps per request batch;
- ``--impl loop``: :func:`generate_loop`, the reference's per-token
  Python loop of ``prefill`` and ``decode_step`` calls, kept as the decode
  baseline; it gives ``--impl scan``'s tokens;
- ``--impl engine``: the ragged continuous-batching
  :class:`repro_torch.launch.engine.DecodeEngine`;
- ``--impl spec``: the engine serving speculatively with a tiny recurrent
  drafter (``core/spec_decode.py``, seed ``--seed + 1337``) proposing
  ``--draft-k`` tokens per verify pass. Greedy speculative serving gives
  ``--impl engine``'s tokens; a random drafter accepts few drafts.

A vlm (``--arch llava-next-mistral-7b``) serves every prompt with a row
of zero vision embeddings (n_vis, d_model), an audio model
(``--arch whisper-small``) with a row of zero frames (n_frames, d_model),
as the reference's CLI does: the vision tower and the audio front end are
stubs in both packages.

``--trace-out`` / ``--metrics-out`` switch telemetry on and write a Chrome
trace-event JSON / the counter and histogram snapshot as JSON, then print
the telemetry report.

Weights are random, made from ``--seed``. Runs on ``cuda`` unless
``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --impl engine [--device cpu --reduced] [--adapters ckpt.npz]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch falcon-mamba-7b --impl spec --draft-k 4 [--device cpu --reduced]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --impl loop [--device cpu --reduced] \\
      [--trace-out trace.json --metrics-out metrics.json]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-small --impl engine [--device cpu --reduced]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_config
from repro_torch.core import telemetry
from repro_torch.core.device import resolve_device
from repro_torch.core.spec_decode import SpecDecoder
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M


@torch.no_grad()
def generate_loop(params: dict, cfg, prompts: torch.Tensor, *,
                  gen: int, extra_batch: dict | None = None
                  ) -> torch.Tensor:
    """Greedy batched generation as a per-token Python loop: one
    ``prefill``, then one ``decode_step`` call a token (the reference's
    legacy ``generate_loop``, kept as the decode baseline;
    :func:`repro_torch.models.model.generate` gives the same tokens).
    prompts: (B, S) int; ``extra_batch`` the family's modality rows.
    Returns (B, gen) int32."""
    S = prompts.shape[1]
    n_vis = cfg.vlm.n_vis_tokens if cfg.family == "vlm" else 0
    logits, caches = M.prefill(params, {"tokens": prompts,
                                        **(extra_batch or {})}, cfg,
                               max_len=S + n_vis + gen)
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
    for i in range(gen):
        out.append(tok)
        logits, caches = M.decode_step(params, tok, caches, S + n_vis + i,
                                       cfg)
        tok = torch.argmax(logits[:, -1], dim=-1,
                           keepdim=True).to(torch.int32)
    return torch.cat(out, dim=1)


def extra_batch(cfg, batch: int, device) -> dict | None:
    """The CLI's modality rows: zero vision embeddings for a vlm, zero
    frames for an audio model, in the model's dtype (the reference's
    stand-ins); None for the other families."""
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(
            (batch, cfg.vlm.n_vis_tokens, cfg.d_model), dtype=dt,
            device=device)}
    if cfg.family == "audio":
        return {"frames": torch.zeros(
            (batch, cfg.audio.n_audio_frames, cfg.d_model), dtype=dt,
            device=device)}
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="vit-edge")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--adapters", default=None,
                    help="adapter-only checkpoint (npz) to serve")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", choices=("scan", "loop", "engine", "spec"),
                    default="scan")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="--impl spec: drafted tokens per verify chunk")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and write a Chrome trace-event "
                         "JSON here (open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable telemetry and write the counter/histogram "
                         "snapshot as JSON here")
    args = ap.parse_args(argv)

    traced = args.trace_out or args.metrics_out
    if traced:
        telemetry.enable()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init(cfg, args.seed, device=dev)
    if args.adapters:
        params = ckpt_io.load_adapters(args.adapters, params)
        print(f"[serve] loaded adapters from {args.adapters} "
              f"(parameter-efficient deployment)")
    rng = np.random.default_rng(args.seed)
    extra = extra_batch(cfg, args.batch, dev)
    engine = None
    if args.impl in ("engine", "spec"):
        spec = SpecDecoder.init(cfg, args.seed + 1337, device=dev,
                                k=args.draft_k) \
            if args.impl == "spec" else None
        engine = DecodeEngine(cfg, slots=args.batch, seed=args.seed,
                              spec=spec, device=dev)
    for r in range(args.requests):
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len), dtype=np.int32)
        if engine is not None:
            toks, stats = engine.serve(params, prompts, gen=args.gen,
                                       extra_batch=extra)
            acc = (f", acceptance {stats.acceptance_rate:.2f} "
                   f"({stats.accepted}/{stats.drafted})"
                   if engine.spec is not None else "")
            print(f"[serve] round {r}: {stats.requests} requests, "
                  f"{stats.tokens} tokens in {stats.wall_s:.2f}s "
                  f"({stats.tok_per_s:.1f} tok/s, {stats.waves} waves{acc});"
                  f" first row: {toks[0][:8]}")
            h = stats.ttft_hist
            print(f"[serve]   ttft p50={h['p50']:.3f}s p95={h['p95']:.3f}s "
                  f"p99={h['p99']:.3f}s")
            continue
        gen_fn = M.generate if args.impl == "scan" else generate_loop
        t0 = time.perf_counter()
        with telemetry.get().span("serve.request", impl=args.impl,
                                  batch=args.batch, gen=args.gen):
            toks = gen_fn(params, cfg, torch.as_tensor(prompts, device=dev),
                          gen=args.gen, extra_batch=extra).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"[serve] request {r}: generated {toks.shape} in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s); "
              f"first row: {toks[0][:8]}")
    if traced:
        tel = telemetry.get()
        if args.trace_out:
            n = tel.export_trace(args.trace_out)
            print(f"[serve] wrote {n} trace events to {args.trace_out}")
        if args.metrics_out:
            tel.export_metrics(args.metrics_out)
            print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
        print(tel.report())


if __name__ == "__main__":
    main()
