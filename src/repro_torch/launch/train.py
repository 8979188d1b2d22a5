"""Training launcher: HFSL fine-tuning end to end (counterpart of
``repro/launch/train.py``).

``--impl scan`` (default) runs the round engine: ``--log-every`` HFSL steps
per ``make_hfsl_round`` call over a device-resident batch bank; ``--impl
loop`` runs one ``make_hfsl_step`` call per step from the host iterator.
Runs on the GPU unless ``--device cpu`` asks for the plain path on the
CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch vit-edge \\
      --reduced --task classify --clusters 2 --steps 6 --batch 4 --seq 16 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import hfsl, telemetry
from repro_torch.core.device import resolve_device, unported
from repro_torch.core.peft import trainable_fraction, tree_bytes
from repro_torch.data.noniid import partition_by_classes
from repro_torch.data.pipeline import BatchBank, cluster_batches
from repro_torch.data.synthetic import ClassificationTask, LMStream
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import warmup_cosine


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.task == "classify" and not cfg.peft.head_dim_out:
        cfg = cfg.with_(peft=dataclasses.replace(cfg.peft,
                                                 head_dim_out=args.classes))
    return cfg


def _lm_iterator(cfg, args):
    its = [iter(LMStream(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed + i)) for i in range(args.clusters)]
    while True:
        bs = [next(i) for i in its]
        yield {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vit-edge")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--task", choices=("lm", "classify"), default="classify")
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--classes-per-client", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--impl", choices=("scan", "loop"), default="scan",
                    help="scan: round engine (one call per --log-every "
                         "steps); loop: one step per call")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation splits per cluster batch "
                         "(scan impl)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint the per-layer forward (lm task, scan "
                         "impl): long-sequence activation memory relief")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and write a Chrome trace-event "
                         "JSON here (open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable telemetry and write the counter/histogram "
                         "snapshot as JSON here")
    args = ap.parse_args(argv)
    if args.ckpt:
        raise unported("--ckpt (adapter checkpoints, checkpoint/io.py)",
                       "slice 4")
    dev = resolve_device(args.device)

    if args.trace_out or args.metrics_out:
        telemetry.enable()

    cfg = build_cfg(args)
    opt = adamw(warmup_cosine(args.lr, args.steps // 10 + 1, args.steps))
    state = hfsl.init_hfsl_state(args.seed, cfg, args.clusters, opt, M.init,
                                 device=dev)
    one = hfsl.consensus_params(state)
    print(f"[train] {cfg.name}: trainable fraction "
          f"{trainable_fraction(one):.4%}, adapter bytes/cluster "
          f"{tree_bytes(one['adapters'])}")

    if args.task == "classify":
        task = ClassificationTask(args.classes, cfg.vocab_size, args.seq,
                                  seed=args.seed)
        data = task.dataset(200 * args.clusters, seed=args.seed)
        parts = partition_by_classes(data["label"], args.clusters,
                                     args.classes_per_client, seed=args.seed)
        it = cluster_batches(data, parts, args.batch, seed=args.seed,
                             device=dev)
        loss_fn = M.classify_loss
    else:
        it = _lm_iterator(cfg, args)
        loss_fn = M.lm_loss                  # accepts remat= for the scan impl

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    if args.impl == "scan":
        remat = True if (args.remat and args.task == "lm") else None
        # pack the run's whole batch stream (the same iterator and seed as
        # the loop impl, so the two impls are step-for-step identical); very
        # long runs recycle the first 512 rows modulo-epoch
        bank = BatchBank.from_iterator(it, min(args.steps, 512), device=dev)
        rounds: dict[int, object] = {}      # one round function per chunk
        done = 0
        while done < args.steps:
            chunk = min(args.log_every, args.steps - done)
            if chunk not in rounds:
                rounds[chunk] = hfsl.make_hfsl_round(
                    cfg, opt, loss_fn, steps=chunk,
                    sync_every=args.sync_every,
                    microbatches=args.microbatches, remat=remat)
            # the span covers the round and the metric host-read (which
            # waits for the device), so it is the blocked round time; the
            # nested hfsl.round_dispatch span is the host's enqueue share
            with telemetry.get().span("train.round", steps=chunk,
                                      done=done) as rsp:
                state, metrics = rounds[chunk](state, bank.arrays,
                                               bank.advance(chunk))
                done += chunk
                m = {k: float(v[-1]) for k, v in metrics.items()
                     if v.dim() == 1}
                rsp.set(**m)
            print(f"[train] step {done:5d} {m} "
                  f"({(time.perf_counter()-t0)/done:.2f}s/step)")
    else:
        step_fn = hfsl.make_hfsl_step(cfg, opt, loss_fn,
                                      sync_every=args.sync_every)
        for i in range(args.steps):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in next(it).items()}
            state, metrics = step_fn(state, batch)
            if (i + 1) % args.log_every == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                print(f"[train] step {i+1:5d} {m} "
                      f"({(time.perf_counter()-t0)/(i+1):.2f}s/step)")
    sync()
    print(f"[train] done in {time.perf_counter()-t0:.1f}s; "
          f"fedavg bytes/sync: {hfsl.sync_bytes(state['adapters_c'])}")

    if args.trace_out or args.metrics_out:
        tel = telemetry.get()
        if args.trace_out:
            n = tel.export_trace(args.trace_out)
            print(f"[train] wrote {n} trace events to {args.trace_out}")
        if args.metrics_out:
            tel.export_metrics(args.metrics_out)
            print(f"[train] wrote metrics snapshot to {args.metrics_out}")
        print(tel.report())
    return state


if __name__ == "__main__":
    main()
