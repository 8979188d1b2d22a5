"""Checkpoints of tensor trees (npz) and adapter-only checkpoints
(counterpart of ``repro/checkpoint/io.py``).

The adapter-only checkpoint is the storage and transport unit of the
paper's parameter-efficient inference (§III-A.2, Fig 2): shipping a
fine-tuned model costs only the tunable modules' bytes, the frozen
backbone being synchronized out of band.

A tree is nested dicts and lists of tensors (the port's layout); a leaf is
stored under its path joined by ``/``, a bf16 leaf as its raw 16 bits
under ``<path>.bf16`` (numpy has no bfloat16). Writes are atomic: a temp
file in the target directory, then ``os.replace``. The int8 adapter
transport (``save_adapters_quantized``) waits for the relay slice
(ROADMAP).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_paths

_SEP = "/"


def _atomic_savez(path: str, flat: dict) -> int:
    """Crash-safe npz write: a temp file in the target directory, then
    ``os.replace`` (readers only ever see a complete file). Returns bytes
    written."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return os.path.getsize(path)


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            flat[_key(path) + ".bf16"] = t.view(torch.int16).numpy() \
                .view(np.uint16)
        else:
            flat[_key(path)] = t.numpy()
    return flat


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree) -> int:
    """Save a tree of tensors (atomically). Returns bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _atomic_savez(_npz(path), _flatten(tree))


def _read(path: str) -> dict[str, torch.Tensor]:
    with np.load(_npz(path)) as raw:
        out = {}
        for k, v in raw.items():
            if k.endswith(".bf16"):
                out[k[:-5]] = torch.from_numpy(
                    v.view(np.int16).copy()).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(v.copy())
    return out


def load(path: str, like: Optional[Any] = None):
    """Load a checkpoint. With ``like``, into its structure: every leaf
    takes ``like``'s dtype and device, and a stored leaf of another shape,
    or a missing one, raises. Without, a nested dict by key path."""
    arrays = _read(path)
    if like is None:
        out: dict = {}
        for k, v in arrays.items():
            node = out
            parts = k.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out

    def place(path, leaf):
        key = _key(path)
        if key not in arrays:
            raise KeyError(f"missing {key} in checkpoint")
        got = arrays[key]
        if tuple(got.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key} has shape "
                             f"{tuple(got.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        return got.to(device=leaf.device, dtype=leaf.dtype)

    return _build(like, (), place)


def _build(tree, path: tuple, fn):
    if isinstance(tree, dict):
        return {k: _build(v, path + (k,), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, path + (i,), fn) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def save_adapters(path: str, params: dict) -> int:
    """Adapter-only checkpoint: the parameter-efficient transport unit."""
    return save(path, {"adapters": params["adapters"]})


def load_adapters(path: str, params: dict) -> dict:
    loaded = load(path, {"adapters": params["adapters"]})
    return {**params, "adapters": loaded["adapters"]}


def tree_bytes(tree) -> int:
    return sum(torch.as_tensor(x).numel() * torch.as_tensor(x).element_size()
               for x in tree_leaves(tree))
