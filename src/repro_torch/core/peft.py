"""Parameter-efficient fine-tuning mechanics (paper §III-A.1; counterpart
of ``repro/core/peft.py``).

Params split at the top level into ``backbone`` / ``adapters``. Around that
split:

- gradients exist *only* for the trainable subtree
  (:func:`peft_value_and_grad`): its leaves are the only tensors that
  require grad, the backbone never does, so no backbone gradient is formed
  (``lora_matmul``'s backward skips ``dW``);
- full fine-tuning is the same entry point with ``trainable='all'`` (the
  paper's Fig 7 baseline);
- accounting helpers report the trainable fraction and transport bytes.
"""
from __future__ import annotations

from typing import Callable, Literal

import torch

from repro_torch.models.params import tree_leaves, tree_map

Trainable = Literal["adapters", "all", "backbone"]


def split(params: dict, trainable: Trainable = "adapters") -> tuple[dict, dict]:
    """-> (trainable_subtree, frozen_subtree)."""
    if trainable == "adapters":
        return {"adapters": params["adapters"]}, {"backbone": params["backbone"]}
    if trainable == "backbone":
        return {"backbone": params["backbone"]}, {"adapters": params["adapters"]}
    return params, {}


def merge(trainable: dict, frozen: dict) -> dict:
    return {**frozen, **trainable}


def value_and_grad(loss_fn: Callable, tree, *args, has_aux: bool = True):
    """``((loss, aux), grads)`` of ``loss_fn(tree, *args)`` with respect to
    every leaf of ``tree``, by ``torch.autograd.grad``. The leaves are
    differentiated through detached aliases (the caller's tensors are left
    as they are); a leaf the loss does not reach gets a zero gradient, as
    JAX gives. Loss and aux come back detached."""
    t = tree_map(lambda x: x.detach().requires_grad_(True), tree)
    with torch.enable_grad():
        out = loss_fn(t, *args)
        loss, aux = out if has_aux else (out, None)
        leaves = tree_leaves(t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(x) if g is None else _like(g, x)
               for x, g in zip(leaves, grads)])
    grads = tree_map(lambda _: next(it), t)
    aux = tree_map(lambda x: x.detach(), aux)
    return ((loss.detach(), aux) if has_aux else loss.detach()), grads


def _like(g, x):
    """A DTensor gradient in its leaf's placements (a sum over ranks where
    autograd left it ``Partial``); a plain gradient as it is."""
    if hasattr(g, "placements") and g.placements != x.placements:
        return g.redistribute(x.device_mesh, x.placements)
    return g


def peft_value_and_grad(loss_fn: Callable, trainable: Trainable = "adapters",
                        has_aux: bool = True) -> Callable:
    """value_and_grad over the trainable subtree only.

    loss_fn(params, *args) -> loss | (loss, aux).
    Returned fn(params, *args) -> ((loss, aux), grads_subtree).
    """
    def wrapped(params: dict, *args):
        t, f = split(params, trainable)
        return value_and_grad(lambda t_, *a: loss_fn(merge(t_, f), *a), t,
                              *args, has_aux=has_aux)

    return wrapped


def count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def trainable_fraction(params: dict) -> float:
    """The paper's '<1% of model parameters' claim, measured."""
    a = count_params(params.get("adapters", {}))
    b = count_params(params.get("backbone", {}))
    return a / max(a + b, 1)


def merge_lora_into_backbone(params: dict, cfg) -> dict:
    """Bake LoRA deltas into frozen weights (deploy-time optimization).

    W' = W + scale * A @ B per target projection, per layer of the port's
    per-layer lists; the merged adapters' ``b`` become zeros (disarming the
    runtime branch). Prefix prompts are untouched (runtime inputs, not
    weight deltas). Returns a new tree; ``params`` is left as it is."""
    out = tree_map(lambda x: x, params)           # new containers, same leaves
    scale = cfg.peft.lora_alpha / max(cfg.peft.lora_rank, 1)
    name_map = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}
    for gname, layers in out["adapters"].get("stack", {}).items():
        for l, layer in enumerate(layers):
            for sname, sub in layer.items():
                lora = sub.get("lora")
                if not lora:
                    continue
                tgt = out["backbone"]["layers"][gname][l][sname]
                blk = tgt.get("attn", tgt.get("mix"))
                for t, ab in lora.items():
                    w = blk[name_map[t]]
                    delta = scale * (ab["a"].float() @ ab["b"].float())
                    blk[name_map[t]] = (w.float() + delta).to(w.dtype)
                    ab["b"] = torch.zeros_like(ab["b"])
    return out
