"""Optimizers over trees of tensors (counterpart of
``repro/optim/optimizers.py``).

Optax-like ``(init, update)`` pairs over dict/list trees. Under the paper's
PEFT regime the optimizer only ever sees the ``adapters`` subtree, so its
state is adapter-sized. As in the reference: moments are f32, the step is
an int32 tensor, bias correction is computed in f32, and an update is cast
to the parameter dtype before :func:`apply_updates`. Updates are
functional: no input tensor is written.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.models.params import tree_leaves, tree_map

LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params) -> (updates, state)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                          state["mu"], grads)
            return tree_map(lambda m: -lr_t * m, mu), {"step": step,
                                                        "mu": mu}
        return tree_map(lambda g: -lr_t * g, grads), {"step": step,
                                                       "mu": None}

    return Optimizer(init, update)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
        return {"step": _step0(params), "m": tree_map(f32, params),
                "v": tree_map(f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr(step) if callable(lr) else lr
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        sf = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=sf.device) ** sf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=sf.device) ** sf

        def upd(m_, v_, p):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves)) if leaves else torch.zeros(())


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n
