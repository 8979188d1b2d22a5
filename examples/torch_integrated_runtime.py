"""Integrated fine-tuning-and-inference runtime demo on the PyTorch port
(paper §IV + §V-F, executed against REAL models instead of the paper's
constant profits; counterpart of ``examples/integrated_runtime.py``).

Two domain edge models share one frozen FM. A demand stream arrives; the
MLCP policy decides per round whether to serve (profit = measured accuracy)
or fine-tune (pay the upgrade cost, raise future accuracy).

    python examples/torch_integrated_runtime.py [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config
from repro_torch.core.integrated import IntegratedRuntime
from repro_torch.core.scheduler import SchedulerEnv, msip_policy
from repro_torch.data.synthetic import ClassificationTask

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = ap.parse_args().device

cfg = get_config("vit-edge").reduced().with_(dtype="float32", vocab_size=64)
cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
tasks = {
    "nlp": ClassificationTask(5, 64, 48, class_strength=0.6, seed=0),
    "cv": ClassificationTask(5, 64, 48, class_strength=0.6, seed=7),
}
demand = ["nlp"] * 2 + ["cv"] + ["nlp"] * 7          # nlp-heavy stream

print("== MLCP (proposed): may sacrifice early rounds to fine-tune ==")
rt = IntegratedRuntime(cfg, tasks, n_clusters=2, steps_per_upgrade=60,
                       serve_batch=32, upgrade_cost=30.0, seed=0,
                       device=device)
print(f"   cold-start accuracy: "
      f"{ {n: round(d.accuracy, 2) for n, d in rt.domains.items()} }")
for r in rt.run(demand):
    rate = (f"ex/s {r.cost.ex_per_s:7.1f}" if r.action == "upgrade"
            else f"tok/s {r.cost.tok_per_s:6.1f}")
    print(f"   round {r.round:2d}: {r.action:8s} {r.domain:4s} "
          f"profit {r.profit:+7.1f}  acc {r.accuracy:.2f}  {rate}  "
          f"cum {r.cumulative:8.1f}")
print(f"   MLCP total: {rt.total_profit():.1f}")

print("\n== MSIP (greedy): never fine-tunes ==")
rt2 = IntegratedRuntime(cfg, tasks, n_clusters=2, steps_per_upgrade=60,
                        serve_batch=32, upgrade_cost=30.0, seed=0,
                        device=device)
greedy = msip_policy(SchedulerEnv(demand=tuple(0 for _ in demand),
                                  n_devices=2))
rt2.run(demand, policy=greedy)
print(f"   MSIP total: {rt2.total_profit():.1f}")

win = rt.total_profit() - rt2.total_profit()
print(f"\n== integrated fine-tuning+inference gain: {win:+.1f} "
      f"({'MLCP pays off' if win > 0 else 'greedy wins this stream'}) ==")
print("   (unlike the paper's constant-profit Table V, profits here come from")
print("    MEASURED accuracy — MLCP's edge depends on the real gain curve of")
print("    fine-tuning, which the DP's value model must estimate)")
