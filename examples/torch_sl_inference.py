"""SL-based task inference on the PyTorch port (paper Fig 5; counterpart
of ``examples/sl_inference.py``): the model's tunable stack is split
across a chain of 4 "clients", activations hop from stage to stage, the
end point's result returns to the start point. The reference runs the
chain on a mesh of 4 devices; the port runs the same chain on one card
(a mesh is multi-GPU sharding, not ported yet).

    python examples/torch_sl_inference.py [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config
from repro_torch.core.comm import CostModel, sl_round_cost
from repro_torch.core.device import resolve_device
from repro_torch.core.sl_pipeline import (pipeline_classify, simulate_sl,
                                          split_for_stages)
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.models import model as M

N_STAGES = 4

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


cfg = get_config("vit-edge").reduced().with_(n_layers=4, dtype="float32")
cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
params = M.init(cfg, 0, device=dev)
task = ClassificationTask(5, cfg.vocab_size, 32, seed=0)

stages = split_for_stages(params, cfg, N_STAGES)
print(f"[sl] split {cfg.n_layers} layers across {N_STAGES} clients "
      f"({cfg.n_layers // N_STAGES} layers each)")

# batched inference requests from the start point
with torch.no_grad():
    for req in range(3):
        batch = task.dataset(16, seed=req)
        toks = torch.as_tensor(batch["tokens"], device=dev)
        t0 = time.perf_counter()
        logits = pipeline_classify(params, stages, toks, cfg,
                                   n_microbatches=4)
        sync()
        dt = time.perf_counter() - t0
        acc = float((logits.argmax(-1).cpu()
                     == torch.as_tensor(batch["label"])).float().mean())
        print(f"[sl] request {req}: 16 samples in {dt:.2f}s, acc={acc:.2f} "
              f"(untuned adapters — see torch_hfsl_finetune.py)")

    # verify against the monolithic model
    mono = M.classify(params, {"tokens": toks}, cfg)
err = float((mono - logits).abs().max())
print(f"[sl] pipelined == monolithic: max err {err:.2e}")

# the paper's §III-D.2 metrics for this round, priced on the wireless model
trace = simulate_sl(cfg, batch=16, seq=32, n_clients=N_STAGES, training=False)
cost = sl_round_cost(trace, CostModel(),
                     model_delivery_bytes=0)   # adapters pre-delivered
print(f"[sl] per-request metrics (6G wireless pricing): "
      f"latency={cost.latency_s*1e3:.1f}ms comm={cost.comm_bytes/1e3:.0f}KB "
      f"energy={cost.energy_j:.3f}J mem={cost.memory_bytes/1e3:.0f}KB")
