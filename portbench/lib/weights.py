"""Weights and adapters made on the device from the seed.

The layout (names, shapes, dtypes) is the port's declaration of what it
takes (``models.model.model_spec``); the values are the benchmark's: one
``torch.randn`` call per dtype on a ``torch.Generator`` on the card, cut
into the leaves as views and scaled in place. The same tensors are
handed to the program and to the plain reference, which reads them by
name and makes nothing of its own.

Scales: a matrix ``N(0, 1 / fan_in)``; an embedding or output table
``N(0, 0.02^2)``; a norm scale ``1 + N(0, 0.05^2)``; a bias
``N(0, 0.05^2)``; an adapter's prefix keys and values ``N(0, 1)``, LoRA
``a`` ``N(0, 1 / fan_in)`` and LoRA ``b`` ``N(0, 0.05^2)`` (so every
adapter term is live).
"""
from __future__ import annotations

import math

import torch

_TABLES = ("table",)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def _scale_of(path, shape) -> tuple[float, float]:
    """(offset, std) of one leaf by its name."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name in _TABLES:
        return 0.0, 0.02
    if name == "scale":                            # a norm
        return 1.0, 0.05
    if name in ("bq", "bk", "bv", "bias", "b") and len(shape) == 1:
        return 0.0, 0.05
    if parent == "prefix":
        return 0.0, 1.0
    if name == "b" and len(shape) == 2:            # LoRA b (r, N)
        return 0.0, 0.05
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    return 0.0, 1.0 / math.sqrt(fan_in)


def materialise(spec_tree, gen: torch.Generator, device) -> dict:
    """Every leaf of a ``ParamSpec`` tree, drawn in one call per dtype."""
    leaves = _paths(spec_tree)
    out = _skeleton(spec_tree)
    by_dtype: dict = {}
    for path, s in leaves:
        by_dtype.setdefault(s.dtype, []).append((path, s))
    for dtype, items in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        n = sum(math.prod(s.shape) for _, s in items)
        flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
        o = 0
        for path, s in items:
            k = math.prod(s.shape)
            t = flat[o:o + k].view(s.shape)
            o += k
            off, std = _scale_of(path, s.shape)
            t.mul_(std)
            if off:
                t.add_(off)
            _set(out, path, t)
    return out


def model(cfg, seed: int, device, n_domains: int) -> tuple[dict, list]:
    """(backbone, [adapters of each domain]) for ``cfg`` from ``seed``."""
    from repro_torch.models import model as M
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    spec = M.model_spec(cfg)
    backbone = materialise(spec["backbone"], gen, device)
    adapters = [materialise(spec["adapters"], gen, device)
                for _ in range(n_domains)]
    return backbone, adapters
