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
"""
from __future__ import annotations

import numpy as np
import torch

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
