"""Weight bridge from the JAX package's param tree to the port's.

The input is the reference's ``{backbone, adapters}`` tree with every leaf
already a numpy array (the caller does the ``jax -> numpy`` step; the port
never sees a jax array). bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays: they are widened to f32 and cast to ``torch.bfloat16``, which is
exact. Leaves under a ``layers`` or ``stack`` key carry the reference's
leading scanned-layer dim; the bridge unstacks it into the port's list of
per-layer dicts. A JAX AdapterBank's ``serving_params`` crosses the same
way: its ``stack`` leaves ``(L, n_slots, ...)`` become per-layer
``(n_slots, ...)`` leaves and its ``head`` stays slot-leading, which is
the port's bank layout (``core/adapter_bank.py``). :func:`to_numpy` is the
inverse (bf16 leaves come back as f32 arrays holding the same values).

An HFSL train state crosses with :func:`hfsl_state_from_jax` and
:func:`hfsl_state_to_numpy`. Its cluster-leading trees (``adapters_c``,
the optimizer's ``m``/``v``/``mu``) carry ``(n_clusters, L, ...)`` leaves
under ``stack`` in the reference and per-layer ``(n_clusters, ...)`` leaves
in the port (``core/hfsl.py``); the per-cluster optimizer ``step``
``(n_clusters,)`` and the round counter ``step`` cross as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map

_STACKED = ("layers", "stack")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _unstack(tree):
    """{group: {sub: leaves (L, ...)}} -> {group: [per-layer trees]}."""
    def leaves(t):
        return [t] if not isinstance(t, dict) else \
            [x for v in t.values() for x in leaves(v)]

    def pick(t, l):
        return {k: pick(v, l) for k, v in t.items()} \
            if isinstance(t, dict) else t[l]

    out = {}
    for g, sub in tree.items():
        ls = leaves(sub)
        L = ls[0].shape[0] if ls else 0
        out[g] = [pick(sub, l) for l in range(L)]
    return out


def from_jax(tree: dict, device="cpu") -> dict:
    """Reference param tree (numpy leaves) -> port params on ``device``."""
    def conv(t, stacked=False):
        if isinstance(t, dict):
            if stacked:
                return {g: [conv(layer) for layer in layers]
                        for g, layers in _unstack(t).items()}
            return {k: conv(v, k in _STACKED) for k, v in t.items()}
        return _tensor(t, device)
    return conv(tree)


def to_numpy(params: dict) -> dict:
    """Port params -> the reference's tree layout with numpy leaves."""
    def conv(t, stacked=False):
        if isinstance(t, dict):
            if stacked:
                return {g: _restack([conv(layer) for layer in layers])
                        for g, layers in t.items()}
            return {k: conv(v, k in _STACKED) for k, v in t.items()}
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return conv(params)


def _restack(layers: list):
    if not layers or not isinstance(layers[0], dict):
        return np.stack(layers) if layers else layers
    return {k: _restack([layer[k] for layer in layers]) for k in layers[0]}


def _swap_stack(tree, swap):
    """Swap the two leading dims of every leaf under a ``stack`` key:
    cluster-leading ``(n, L, ...)`` <-> layer-leading ``(L, n, ...)``."""
    def conv(t, stacked=False):
        if isinstance(t, dict):
            return {k: conv(v, stacked or k == "stack") for k, v in t.items()}
        return swap(t) if stacked else t
    return conv(tree)


def _clustered_from_jax(tree, device):
    if tree is None:
        return None
    t = from_jax(_swap_stack(tree, lambda a: np.swapaxes(a, 0, 1)), device)
    return tree_map(lambda x: x.contiguous(), t)


def hfsl_state_from_jax(tree: dict, device="cpu") -> dict:
    """Reference HFSL state (numpy leaves) -> the port's state on
    ``device``."""
    opt = {k: (_tensor(v, device) if k == "step"
               else _clustered_from_jax(v, device))
           for k, v in tree["opt"].items()}
    return {"backbone": from_jax({"backbone": tree["backbone"]},
                                 device)["backbone"],
            "adapters_c": _clustered_from_jax(tree["adapters_c"], device),
            "opt": opt,
            "step": _tensor(tree["step"], device)}


def hfsl_state_to_numpy(state: dict) -> dict:
    """The port's HFSL state -> the reference's layout, numpy leaves."""
    def clustered(t):
        if t is None:
            return None
        return _swap_stack(to_numpy(t), lambda a: np.swapaxes(a, 0, 1))
    return {"backbone": to_numpy({"backbone": state["backbone"]})["backbone"],
            "adapters_c": clustered(state["adapters_c"]),
            "opt": {k: (to_numpy(v) if k == "step" else clustered(v))
                    for k, v in state["opt"].items()},
            "step": to_numpy(state["step"])}
