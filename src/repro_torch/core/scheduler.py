"""Integrated fine-tuning-or-inference scheduling (paper §IV-C, §V-F; a
copy of ``repro/core/scheduler.py``, numpy only).

The paper's economy: M edge models ("devices") serve M inference services.
Each round serves one request from a known demand sequence; the scheduler
either produces (profit = the device's current value) or upgrades a device
(profit = -cost, raising that device's future value).

Policies: MLCP (exact horizon DP, or value iteration for stochastic
demand), MSIP (greedy: always produce), RS (uniform random action).
:func:`paper_env` with the three policies gives Table V / Fig 8.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerEnv:
    demand: tuple[int, ...]            # device index demanded per round
    values: tuple[int, ...] = (50, 75, 100)   # production value per level
    upgrade_cost: int = 50
    n_devices: int = 3

    @property
    def horizon(self) -> int:
        return len(self.demand)

    @property
    def max_level(self) -> int:
        return len(self.values) - 1


def paper_env() -> SchedulerEnv:
    """Table V: demand 1 x A, 1 x A, 1 x B, 7 x C."""
    return SchedulerEnv(demand=(0, 0, 1, 2, 2, 2, 2, 2, 2, 2))


@dataclasses.dataclass
class Record:
    round: int
    action: str                        # 'produce' | 'upgrade'
    device: int
    profit: int
    cumulative: int


# Policies: state = (round r, levels tuple); action 0..M-1 upgrades device
# m, action M produces.

def mlcp_policy(env: SchedulerEnv) -> Callable[[int, tuple], int]:
    """Exact horizon DP (maximum long-term cumulative profit)."""
    @functools.lru_cache(maxsize=None)
    def value(r: int, levels: tuple) -> tuple[int, int]:
        if r == env.horizon:
            return 0, -1
        best, best_a = -10 ** 9, -1
        dev = env.demand[r]
        v = env.values[levels[dev]] + value(r + 1, levels)[0]
        if v > best:
            best, best_a = v, env.n_devices
        for m in range(env.n_devices):
            if levels[m] >= env.max_level:
                continue
            nl = tuple(l + 1 if i == m else l for i, l in enumerate(levels))
            v = -env.upgrade_cost + value(r + 1, nl)[0]
            if v > best:
                best, best_a = v, m
        return best, best_a

    return lambda r, levels: value(r, levels)[1]


def msip_policy(env: SchedulerEnv) -> Callable[[int, tuple], int]:
    """Greedy: producing always beats paying an upgrade cost."""
    return lambda r, levels: env.n_devices


def rs_policy(env: SchedulerEnv, seed: int = 0) -> Callable[[int, tuple], int]:
    rng = np.random.default_rng(seed)
    return lambda r, levels: int(rng.integers(0, env.n_devices + 1))


def run_policy(env: SchedulerEnv, policy: Callable[[int, tuple], int]
               ) -> list[Record]:
    levels = tuple([0] * env.n_devices)
    cum = 0
    out = []
    for r in range(env.horizon):
        a = policy(r, levels)
        if a == env.n_devices:
            dev = env.demand[r]
            profit = env.values[levels[dev]]
            action = "produce"
        else:
            dev = a
            profit = -env.upgrade_cost
            # an upgrade past the top level burns the cost without effect
            levels = tuple(min(l + 1, env.max_level) if i == dev else l
                           for i, l in enumerate(levels))
            action = "upgrade"
        cum += profit
        out.append(Record(r + 1, action, dev, profit, cum))
    return out


def total_profit(records: Sequence[Record]) -> int:
    return records[-1].cumulative if records else 0


def mlcp_value_iteration(env: SchedulerEnv, demand_probs: Sequence[float],
                         gamma: float = 0.95, iters: int = 200
                         ) -> Callable[[int, tuple], int]:
    """Stationary policy for unknown future demand (demand ~ Cat(p)):
    value iteration over the levels with the expected immediate reward."""
    p = np.asarray(demand_probs, float)
    p = p / p.sum()
    states = list(itertools.product(range(env.max_level + 1),
                                    repeat=env.n_devices))
    sidx = {s: i for i, s in enumerate(states)}
    V = np.zeros(len(states))
    for _ in range(iters):
        newV = np.empty_like(V)
        for s in states:
            i = sidx[s]
            best = sum(p[d] * env.values[s[d]]
                       for d in range(env.n_devices)) + gamma * V[i]
            for m in range(env.n_devices):
                if s[m] >= env.max_level:
                    continue
                ns = tuple(l + 1 if j == m else l for j, l in enumerate(s))
                best = max(best, -env.upgrade_cost + gamma * V[sidx[ns]])
            newV[i] = best
        if np.max(np.abs(newV - V)) < 1e-9:
            V = newV
            break
        V = newV

    def policy(r: int, levels: tuple) -> int:
        i = sidx[levels]
        best_a, best_v = env.n_devices, \
            sum(p[d] * env.values[levels[d]] for d in range(env.n_devices)) \
            + gamma * V[i]
        for m in range(env.n_devices):
            if levels[m] >= env.max_level:
                continue
            ns = tuple(l + 1 if j == m else l for j, l in enumerate(levels))
            v = -env.upgrade_cost + gamma * V[sidx[ns]]
            if v > best_v:
                best_a, best_v = m, v
        return best_a

    return policy
