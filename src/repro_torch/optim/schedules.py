"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
callables over the int32 step tensor, returning an f32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def linear_decay(peak: float, total: int, floor: float = 0.0):
    def f(step):
        prog = torch.clamp(step.float() / max(total, 1), 0.0, 1.0)
        return peak + (floor - peak) * prog
    return f
