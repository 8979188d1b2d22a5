"""Parameter declarations and their initialisation (torch counterpart of
``repro/sharding/rules.py::ParamSpec`` and ``init_from_spec``).

A spec tree is nested dicts and lists whose leaves are :class:`ParamSpec`.
The port drops the reference's logical sharding axes (one card, no mesh)
and keeps shape, dtype and the init rule. Initialisation draws from an
explicit ``torch.Generator`` on the target device, one leaf at a time: the
f32 draw of a leaf is cast to the leaf's dtype before the next leaf is
drawn, so a full-size init never holds the whole model in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter: shape + dtype + init rule."""
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if self.init not in ("normal", "zeros", "ones", "scaled"):
            raise ValueError(f"ParamSpec init {self.init!r}: expected "
                             "'normal', 'zeros', 'ones' or 'scaled'")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a dict/list tree (``None`` stays), and
    to the matching leaves of ``rest``, trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list tree in ``tree_map`` order (no ``None``)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def init_leaf(s: ParamSpec, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """Materialise one spec (``scaled`` is the fan-in scaled normal)."""
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    w = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if s.init == "scaled":
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        w.mul_(1.0 / math.sqrt(fan_in))
    else:
        w.mul_(s.scale)
    return w.to(s.dtype)


def init_from_spec(gen: torch.Generator, tree: Any,
                   device: torch.device) -> Any:
    """Materialise a spec tree, leaf by leaf, from ``gen`` on ``device``."""
    return tree_map(lambda s: init_leaf(s, gen, device), tree)
