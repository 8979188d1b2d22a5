"""Seeded fault injection for the fine-tune / serve loop (the chaos layer;
counterpart of ``repro/core/faults.py``).

GaisNet's edge is fragmented compute over wireless links: dropout,
stragglers and lossy links are the normal case. This module decides when
things fail; every layer consumes it:

- HFSL rounds (``core/hfsl.py``): a per-round per-cluster participation
  mask (dropout + stragglers) and a per-cluster gradient-corruption mask;
- the knowledge relay (``core/relay.py``): per-attempt link drops,
  payload corruption and retry jitter;
- serving: publish validation, per-request deadlines.

Every schedule is a pure function of ``(seed, coordinates)`` through
``np.random.SeedSequence``, the reference's own construction, so a plan
replays the same faults in any call order, and the port's schedules equal
the reference's bit for bit. A default-constructed plan is all-off.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_paths

# schedule namespaces (SeedSequence entropy words), one per fault kind
_DROP, _STRAGGLE, _CORRUPT, _LINK, _PAYLOAD, _FLIP, _JITTER = range(7)

_RATES = ("dropout", "straggler", "grad_nan", "link_loss", "payload_corrupt")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic, replayable fault schedule. Rates are per-event
    probabilities in [0, 1): ``dropout`` / ``straggler`` / ``grad_nan``
    per (round, cluster); ``link_loss`` / ``payload_corrupt`` per
    (transfer, attempt)."""
    seed: int = 0
    dropout: float = 0.0          # P(cluster absent for a whole round)
    straggler: float = 0.0        # P(cluster misses the round's sync)
    grad_nan: float = 0.0         # P(cluster's round updates go non-finite)
    link_loss: float = 0.0        # P(one relay transfer attempt is dropped)
    payload_corrupt: float = 0.0  # P(a delivered payload is bit-corrupted)

    def __post_init__(self):
        for f in _RATES:
            v = getattr(self, f)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"FaultPlan.{f}={v} must be in [0, 1)")

    @property
    def active(self) -> bool:
        """False for the all-off plan: consumers take the happy path."""
        return any(getattr(self, f) > 0.0 for f in _RATES)

    def _rng(self, *coords: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.seed, *map(int, coords))))

    def participation(self, round_idx: int, n_clusters: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-cluster presence for one round: ``(mask, dropped,
        stragglers)``, bool ``(n_clusters,)``; ``mask`` True means the
        cluster trains and syncs this round."""
        dropped = self._rng(_DROP, round_idx).random(n_clusters) < self.dropout
        stragglers = (self._rng(_STRAGGLE, round_idx).random(n_clusters)
                      < self.straggler) & ~dropped
        return ~(dropped | stragglers), dropped, stragglers

    def corrupt_mask(self, round_idx: int, n_clusters: int) -> np.ndarray:
        """Which clusters' updates are NaN-poisoned this round (bool)."""
        return (self._rng(_CORRUPT, round_idx).random(n_clusters)
                < self.grad_nan)

    def link_drops(self, transfer_id: int, attempt: int) -> bool:
        """True if this (transfer, attempt) is lost on the wire."""
        return (self.link_loss > 0.0
                and self._rng(_LINK, transfer_id, attempt).random()
                < self.link_loss)

    def payload_corrupted(self, transfer_id: int, attempt: int) -> bool:
        """True if this attempt arrives bit-corrupted."""
        return (self.payload_corrupt > 0.0
                and self._rng(_PAYLOAD, transfer_id, attempt).random()
                < self.payload_corrupt)

    def retry_jitter(self, transfer_id: int, attempt: int) -> float:
        """Deterministic backoff jitter in [0, 1) for (transfer, attempt)."""
        return float(self._rng(_JITTER, transfer_id, attempt).random())

    def corrupt_payload(self, tree, transfer_id: int, attempt: int):
        """The wire copy of ``tree`` with one byte of one leaf flipped (the
        XOR always changes the byte, so :func:`payload_checksum` catches
        it). The other leaves are shared, the flipped one is a copy."""
        paths = tree_paths(tree)
        r = self._rng(_FLIP, transfer_id, attempt)
        i = int(r.integers(len(paths)))
        leaf = paths[i][1]
        wire = leaf.detach().cpu().clone().contiguous()
        buf = wire.reshape(-1).view(torch.uint8)
        buf[int(r.integers(buf.numel()))] ^= 0xFF
        target = paths[i][0]
        return _replace(tree, target, wire.to(leaf.device))


def _replace(tree, path: tuple, leaf):
    """A copy of ``tree``'s containers with the leaf at ``path`` swapped."""
    if not path:
        return leaf
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {k: (_replace(v, rest, leaf) if k == head else v)
                for k, v in tree.items()}
    return [(_replace(v, rest, leaf) if j == head else v)
            for j, v in enumerate(tree)]


def _leaf_bytes(x) -> tuple[str, tuple, bytes]:
    """(dtype name, shape, raw bytes) of a tensor or array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return name, tuple(t.shape), raw
    a = np.ascontiguousarray(np.asarray(x))
    return str(a.dtype), a.shape, a.tobytes()


def _crc_leaf(x, c: int = 0) -> int:
    name, shape, raw = _leaf_bytes(x)
    c = zlib.crc32(name.encode(), c)
    c = zlib.crc32(np.asarray(shape, np.int64).tobytes(), c)
    return zlib.crc32(raw, c)


def payload_checksum(tree) -> int:
    """CRC32 over a tree's structure (its leaf paths), dtypes, shapes and
    raw bytes: the relay's end-to-end wire check."""
    paths = tree_paths(tree)
    c = zlib.crc32(repr([p for p, _ in paths]).encode())
    for _, x in paths:
        c = _crc_leaf(x, c)
    return c


def leaf_checksums(tree) -> list:
    """Per-leaf CRC32 (dtype + shape + raw bytes) in ``tree_leaves``
    order: the relay's partial-retransmit unit."""
    return [_crc_leaf(x) for _, x in tree_paths(tree)]


# The canonical all-off plan: schedules exist, nothing ever fires.
NO_FAULTS = FaultPlan()
