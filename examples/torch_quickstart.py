"""Quickstart on the PyTorch port: the GaisNet loop in ~60 lines
(counterpart of ``examples/quickstart.py``).

1. pretrain a tiny FM on the cloud corpus (LM task),
2. PEFT fine-tune it with HFSL across 4 client clusters (classification),
3. distribute only the adapters (parameter-efficient inference) and serve.

    python examples/torch_quickstart.py [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config
from repro_torch.core import hfsl
from repro_torch.core.device import resolve_device
from repro_torch.core.peft import (peft_value_and_grad, trainable_fraction,
                                   tree_bytes)
from repro_torch.data.noniid import partition_by_classes
from repro_torch.data.pipeline import cluster_batches
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw, apply_updates

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

# 1. the edge foundation model (the paper's ViT-B/16 case study, tiny here)
# vocab 64 keeps per-sample token statistics dense enough to classify
cfg = get_config("vit-edge").reduced().with_(dtype="float32", vocab_size=64)
cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
task = ClassificationTask(5, cfg.vocab_size, 64, class_strength=0.6, seed=0)

print("== pretraining (cloud tier: unlabeled corpus) ==")
params = M.init(cfg, 0, device=dev)
opt = adamw(3e-3)
vg = peft_value_and_grad(M.lm_loss, trainable="all")
opt_state = opt.init(params)


def step(p, s, b):
    (loss, _), grads = vg(p, b, cfg)
    with torch.no_grad():
        updates, s = opt.update(grads, s, p)
        return apply_updates(p, updates), s, loss


stream = task.pretrain_stream(16)
for i in range(250):
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             next(stream).items()}
    params, opt_state, loss = step(params, opt_state, batch)
print(f"   pretrain loss: {float(loss):.3f}")

print("== HFSL fine-tuning (edge-end tier: 4 client clusters) ==")
print(f"   trainable fraction: {trainable_fraction(params):.3%} "
      f"(paper: 'less than 1%')")
data = task.dataset(400)
parts = partition_by_classes(data["label"], 4, classes_per_client=5)
it = cluster_batches(data, parts, batch_size=8, device=dev)
fopt = adamw(5e-3)
state = hfsl.init_hfsl_state(1, cfg, 4, fopt,
                             lambda c, s, device=None: params, device=dev)
hstep = hfsl.make_hfsl_step(cfg, fopt, M.classify_loss, sync_every=5)
for i in range(100):
    state, metrics = hstep(state, next(it))
    if (i + 1) % 20 == 0:
        print(f"   step {i+1}: loss {float(metrics['loss']):.3f} "
              f"(fedavg moves {hfsl.sync_bytes(state['adapters_c'])} B/sync)")

print("== parameter-efficient serving (end tier) ==")
tuned = hfsl.consensus_params(state)
print(f"   distributing adapters only: {tree_bytes(tuned['adapters'])} B "
      f"vs full model {tree_bytes(tuned)} B")
test = task.dataset(100, seed=9)
with torch.no_grad():
    logits = M.classify(tuned, {k: torch.as_tensor(v, device=dev)
                                for k, v in test.items()}, cfg)
acc = float((logits.argmax(-1).cpu() == torch.as_tensor(test["label"]))
            .float().mean())
print(f"   served accuracy on 100 fresh samples: {acc:.1%}")
