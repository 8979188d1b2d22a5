"""Integrated fine-tuning-or-inference scheduling demo on the PyTorch port
(paper §IV-C, §V-F; counterpart of ``examples/scheduler_demo.py``).

Reproduces Table V / Fig 8, then goes beyond the paper: stochastic demand
handled by value iteration, and a sweep of upgrade costs showing when
fine-tuning stops paying for itself. The scheduler is host code: nothing
here runs on the device, which ``--device`` only checks.

    python examples/torch_scheduler_demo.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.device import resolve_device
from repro_torch.core.scheduler import (SchedulerEnv, mlcp_policy,
                                        mlcp_value_iteration, msip_policy,
                                        paper_env, rs_policy, run_policy,
                                        total_profit)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
resolve_device(ap.parse_args().device)

env = paper_env()
print("== paper Table V (demand: A A B C C C C C C C) ==")
for name, pol in [("MLCP (proposed)", mlcp_policy(env)),
                  ("MSIP", msip_policy(env)), ("RS", rs_policy(env, 3))]:
    rec = run_policy(env, pol)
    trace = " ".join(
        (f"{'abc'[r.device]}/{r.profit}" if r.action == "upgrade"
         else f"{'ABC'[r.device]}/{r.profit}") for r in rec)
    print(f"  {name:16s} total={total_profit(rec):5d}  {trace}")

print("\n== cumulative profit per round (Fig 8) ==")
recs = {n: run_policy(env, p) for n, p in
        [("MLCP", mlcp_policy(env)), ("MSIP", msip_policy(env)),
         ("RS", rs_policy(env, 3))]}
print("  round: " + " ".join(f"{i+1:5d}" for i in range(env.horizon)))
for n, rec in recs.items():
    print(f"  {n:5s}: " + " ".join(f"{r.cumulative:5d}" for r in rec))

print("\n== beyond paper: stochastic demand (value iteration) ==")
rng = np.random.default_rng(0)
for probs in ([0.2, 0.1, 0.7], [0.34, 0.33, 0.33]):
    vi = mlcp_value_iteration(env, probs)
    totals = []
    for trial in range(200):
        demand = tuple(rng.choice(3, size=10, p=probs).tolist())
        e = SchedulerEnv(demand=demand)
        totals.append(total_profit(run_policy(e, vi)))
        oracle = total_profit(run_policy(e, mlcp_policy(e)))
    print(f"  p={probs}: VI mean profit {np.mean(totals):.0f} "
          f"(oracle DP on last draw: {oracle})")

print("\n== beyond paper: when does fine-tuning pay? (upgrade-cost sweep) ==")
for cost in (25, 50, 100, 200, 400):
    e = SchedulerEnv(demand=env.demand, upgrade_cost=cost)
    m = total_profit(run_policy(e, mlcp_policy(e)))
    g = total_profit(run_policy(e, msip_policy(e)))
    n_up = sum(r.action == "upgrade"
               for r in run_policy(e, mlcp_policy(e)))
    print(f"  upgrade_cost={cost:3d}: MLCP={m:5d} (upgrades={n_up}) "
          f"vs MSIP={g}  -> fine-tuning {'pays' if m > g else 'does not pay'}")
