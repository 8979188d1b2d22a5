"""Checkpoints of tensor trees (npz) and adapter-only checkpoints
(counterpart of ``repro/checkpoint/io.py``).

The adapter-only checkpoint is the storage and transport unit of the
paper's parameter-efficient inference (§III-A.2, Fig 2): shipping a
fine-tuned model costs only the tunable modules' bytes, the frozen
backbone being synchronized out of band.

A tree is nested dicts and lists of tensors (the port's layout); a leaf is
stored under its path joined by ``/``, a bf16 leaf as its raw 16 bits
under ``<path>.bf16`` (numpy has no bfloat16). Writes are atomic: a temp
file in the target directory, then ``os.replace``.

The int8 adapter transport (``save_adapters_quantized``) squeezes the
tunable modules further for the edge's D2D and client-server links: one
symmetric int8 scale per row of each leaf. It quantizes the reference's
*wire leaves* (:func:`wire_tree`: dict keys sorted, each group's
per-layer list stacked back to ``(L, ...)``, dtypes kept), so a stacked
LoRA leaf gets one scale per layer, exactly as in the reference, and a
file written by either package loads in the other. The knowledge relay
(``core/relay.py``) checksums and retransmits over the same wire leaves.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_paths

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


# ---------------------------------------------------------------------------
# The reference's wire layout, and the int8 adapter transport
# ---------------------------------------------------------------------------

def wire_tree(tree):
    """A port tree in the reference's layout: dict keys sorted (the order
    of ``jax.tree.leaves``), each list of per-layer trees stacked into one
    tree of ``(L, ...)`` leaves, every dtype kept. The stacked leaves are
    new tensors; the others are the tree's own."""
    if isinstance(tree, dict):
        return {k: wire_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return tree_map(lambda *xs: torch.stack(xs),
                        *[wire_tree(t) for t in tree]) if tree else {}
    return tree


def from_wire(wire, like):
    """The inverse of :func:`wire_tree`: ``wire``'s leaves in ``like``'s
    structure, each layer list unstacked, on ``like``'s devices and in its
    dtypes."""
    if isinstance(like, dict):
        return {k: from_wire(wire[k], v) for k, v in like.items()}
    if isinstance(like, list):
        return [from_wire(tree_map(lambda x: x[l], wire), v)
                for l, v in enumerate(like)]
    return None if like is None else \
        wire.to(device=like.device, dtype=like.dtype)


def _quantize(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8, one scale per row of ``arr.reshape(arr.shape[0],
    -1)`` (a 1-D leaf is one row): the reference's arithmetic, in numpy."""
    a = np.asarray(arr, np.float32)
    flat = a.reshape(a.shape[0], -1) if a.ndim > 1 else a.reshape(1, -1)
    scale = np.abs(flat).max(axis=1, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.round(flat / scale), -127, 127).astype(np.int8)
    return q.reshape(a.shape), scale.astype(np.float32)


def save_adapters_quantized(path: str, params: dict) -> int:
    """int8 adapter-only checkpoint, the reference's keys
    (``adapters/stack/g0/s0/lora/q/a.q8`` and ``.scale``, ``.dtype``).
    Returns bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for p, leaf in tree_paths(wire_tree({"adapters": params["adapters"]})):
        key = _key(p)
        q, scale = _quantize(leaf.detach().float().cpu().numpy())
        flat[key + ".q8"] = q
        flat[key + ".scale"] = scale
        name = str(leaf.dtype).replace("torch.", "")
        flat[key + ".dtype"] = np.frombuffer(name.encode().ljust(16),
                                             np.uint8).copy()
    return _atomic_savez(_npz(path), flat)


def load_adapters_quantized(path: str, params: dict) -> dict:
    """Dequantize an int8 adapter checkpoint into ``params``' adapter
    structure (each leaf in its dtype and on its device)."""
    like = {"adapters": params["adapters"]}
    with np.load(_npz(path)) as raw:
        def deq(p, leaf):
            key = _key(p)
            q = raw[key + ".q8"].astype(np.float32)
            flat = q.reshape(q.shape[0], -1) if q.ndim > 1 else \
                q.reshape(1, -1)
            return torch.from_numpy(
                (flat * raw[key + ".scale"]).reshape(tuple(leaf.shape)))
        wire = _build(wire_tree(like), (), deq)
    return {**params, "adapters": from_wire(wire, like)["adapters"]}
