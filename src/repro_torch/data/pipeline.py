"""Batching over in-memory datasets, per-cluster shards (counterpart of
``repro/data/pipeline.py``). Tensors are made here, on ``device``
(``cuda`` unless the caller passes ``"cpu"``), from the numpy arrays of
``data/synthetic.py``.

Two ways to feed ``core/hfsl.py``:

- :func:`cluster_batches` — host iterator: one host->device copy per step
  (kept for the one-step-per-call path and host-streamed datasets).
- :class:`BatchBank` — device-resident bank: a whole epoch of per-cluster
  batches packed into stacked ``(steps, cluster, batch, ...)`` tensors on
  the device, gathered on the device by step index inside a round
  (hfsl.make_hfsl_round): no host transfer inside a round.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device, unported


def _to(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v)).to(device)


def batches(data: dict, batch_size: int, *, shuffle: bool = True,
            seed: int = 0, drop_last: bool = True,
            epochs: Optional[int] = None, device=None) -> Iterator[dict]:
    """Yield dict batches (tensors on ``device``) from a dict of
    equal-length numpy arrays."""
    dev = resolve_device(device)
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = (n // batch_size) * batch_size if drop_last else n
        for lo in range(0, stop, batch_size):
            idx = order[lo:lo + batch_size]
            yield {k: _to(v[idx], dev) for k, v in data.items()}
        epoch += 1


def cluster_batches(data: dict, parts: Sequence[np.ndarray], batch_size: int,
                    *, seed: int = 0, device=None) -> Iterator[dict]:
    """Stacked per-cluster batches: leaves get a leading cluster dim.
    Cluster c trains on parts[c] only (the paper's 'personalized local data
    stays in its cluster')."""
    dev = resolve_device(device)
    its = [batches({k: v[p] for k, v in data.items()}, batch_size,
                   seed=seed + i, device=dev) for i, p in enumerate(parts)]
    while True:
        bs = [next(it) for it in its]
        yield {k: torch.stack([b[k] for b in bs]) for k in bs[0]}


@dataclasses.dataclass
class BatchBank:
    """Device-resident epoch of stacked per-cluster batches.

    ``arrays`` leaves are ``(steps, n_clusters, batch, ...)`` tensors on the
    device. hfsl.make_hfsl_round gathers row ``(offset + i) % steps`` on the
    device, so a round of K steps reads nothing from the host; the
    ``offset`` cursor (see :meth:`advance`) carries the epoch position
    across rounds exactly as the host iterator would. Cluster-sharded
    placement over several GPUs (``mesh=``) is not ported yet.
    """
    arrays: dict
    offset: int = 0

    @property
    def steps(self) -> int:
        return next(iter(self.arrays.values())).shape[0]

    @property
    def n_clusters(self) -> int:
        return next(iter(self.arrays.values())).shape[1]

    def advance(self, steps: int) -> int:
        """Return the current cursor and move it ``steps`` forward (wraps)."""
        off = self.offset
        self.offset = (self.offset + steps) % self.steps
        return off

    @classmethod
    def pack(cls, data: dict, parts: Sequence[np.ndarray], batch_size: int,
             *, seed: int = 0, steps: Optional[int] = None, mesh=None,
             device=None) -> "BatchBank":
        """Pre-pack one epoch of :func:`cluster_batches`-shaped batches.

        The epoch length is the smallest cluster's batch count (every row
        must hold one batch per cluster) unless ``steps`` caps it."""
        if mesh is not None:
            raise unported("BatchBank.pack(mesh=...)", "later, multi-GPU")
        epoch = min(len(p) // batch_size for p in parts)
        if steps is not None:
            epoch = min(epoch, steps)
        if epoch < 1:
            raise ValueError(
                f"smallest cluster has < {batch_size} examples; "
                "cannot pack a BatchBank row")
        it = cluster_batches(data, parts, batch_size, seed=seed,
                             device=device)
        return cls.from_iterator(it, epoch, device=device)

    @classmethod
    def from_iterator(cls, it: Iterator[dict], steps: int, *, mesh=None,
                      device=None) -> "BatchBank":
        """Stack ``steps`` batches from any cluster-batch iterator (numpy
        or tensor leaves) onto ``device``."""
        if mesh is not None:
            raise unported("BatchBank.from_iterator(mesh=...)",
                           "later, multi-GPU")
        dev = resolve_device(device)
        rows = list(itertools.islice(it, steps))
        arrays = {k: torch.stack([torch.as_tensor(r[k]).to(dev)
                                  for r in rows]) for k in rows[0]}
        return cls(arrays)
