"""End-to-end run on the PyTorch port: HFSL fine-tuning of a
~100M-parameter model for a few hundred steps (counterpart of
``examples/hfsl_finetune.py``).

The model is the paper's own case-study backbone at FULL size (vit-edge:
12L x 768d x 12H ~= 110M params). The backbone stays frozen (PEFT).

    python examples/torch_hfsl_finetune.py [--steps 200] [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl
from repro_torch.core.device import resolve_device
from repro_torch.core.peft import count_params, trainable_fraction, tree_bytes
from repro_torch.core.relay import KnowledgeRelay
from repro_torch.data.noniid import partition_by_classes
from repro_torch.data.pipeline import cluster_batches
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import warmup_cosine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sync-every", type=int, default=5)
    ap.add_argument("--ckpt", default=str(Path(__file__).resolve().parents[1]
                                         / "build" / "gaisnet_adapters"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # full ~110M-param backbone; vocab 64 so the synthetic task is
    # separable from pooled features
    cfg = get_config("vit-edge").with_(dtype="float32", vocab_size=64)
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    print(f"[hfsl] model: {cfg.name}, {cfg.param_count()/1e6:.0f}M backbone "
          f"params on {dev}")

    params = M.init(cfg, 0, device=dev)
    print(f"[hfsl] trainable fraction: {trainable_fraction(params):.4%} "
          f"({count_params(params['adapters'])/1e6:.2f}M adapter params)")

    task = ClassificationTask(5, cfg.vocab_size, args.seq,
                              class_strength=0.7, seed=0)
    data = task.dataset(200 * args.clusters)
    parts = partition_by_classes(data["label"], args.clusters, 5)
    it = cluster_batches(data, parts, args.batch, device=dev)

    opt = adamw(warmup_cosine(5e-3, 20, args.steps))
    state = hfsl.init_hfsl_state(0, cfg, args.clusters, opt,
                                 lambda c, s, device=None: params,
                                 device=dev)
    step = hfsl.make_hfsl_step(cfg, opt, M.classify_loss,
                               sync_every=args.sync_every)

    # the edge server mediating the knowledge flow (paper Fig 3)
    relay = KnowledgeRelay(params["adapters"], ["case-study-domain"])
    relay.edge_deliver("case-study-domain", args.clusters)

    t0 = time.perf_counter()
    for i in range(args.steps):
        state, metrics = step(state, next(it))
        if (i + 1) % 20 == 0 or i == 0:
            dt = (time.perf_counter() - t0) / (i + 1)
            print(f"[hfsl] step {i+1:4d}/{args.steps} "
                  f"loss={float(metrics['loss']):.4f} ({dt:.2f}s/step)")

    tuned = hfsl.consensus_params(state)
    relay.edge_absorb("case-study-domain",
                      [hfsl._cluster(state["adapters_c"], c)
                       for c in range(args.clusters)])
    relay.cloud_aggregate()
    print(f"[hfsl] relay ledger: {dataclasses.asdict(relay.ledger)}")
    print(f"[hfsl] knowledge-flow cost: latency={relay.cost.latency_s:.2f}s "
          f"energy={relay.cost.energy_j:.1f}J "
          f"comm={relay.cost.comm_bytes/1e6:.1f}MB")

    # eval + parameter-efficient checkpoint
    test = task.dataset(200, seed=7)
    with torch.no_grad():
        logits = M.classify(tuned, {k: torch.as_tensor(v, device=dev)
                                    for k, v in test.items()}, cfg)
    acc = float((logits.argmax(-1).cpu() == torch.as_tensor(test["label"]))
                .float().mean())
    nb = ckpt.save_adapters(args.ckpt, tuned)
    print(f"[hfsl] final accuracy: {acc:.1%}; adapter ckpt {nb/1e6:.2f}MB "
          f"(full model would be {tree_bytes(tuned)/1e6:.0f}MB) -> "
          f"{args.ckpt}")


if __name__ == "__main__":
    main()
