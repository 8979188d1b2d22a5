"""Synthetic data generators (counterpart of ``repro/data/synthetic.py``).

The generators are the reference's numpy code unchanged, so the same seeds
give the same arrays bit for bit; they yield numpy arrays, and tensors are
made at the package boundary (``data/pipeline.py``).

Two workloads, mirroring the paper's pipeline:

1. **LM pretraining stream** — Markov-chain token sequences over the model's
   vocab (the "large-scale unlabeled corpus" of the cloud tier). A learnable
   structure (low-entropy transitions) so pretraining measurably reduces loss.

2. **Classification task** — the stand-in for the paper's flower dataset
   (§V): each class is a perturbed Markov chain sharing a common base, so a
   backbone pretrained on the mixture transfers to classification.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


def _row_normalize(m: np.ndarray) -> np.ndarray:
    return m / m.sum(axis=1, keepdims=True)


def markov_chain(rng: np.random.Generator, vocab: int,
                 concentration: float = 0.1) -> np.ndarray:
    """Sparse-ish transition matrix: low entropy => learnable."""
    m = rng.dirichlet(np.full(vocab, concentration), size=vocab)
    return m.astype(np.float64)


def sample_markov(rng: np.random.Generator, trans: np.ndarray, n: int,
                  seq: int) -> np.ndarray:
    vocab = trans.shape[0]
    out = np.empty((n, seq), np.int32)
    state = rng.integers(0, vocab, size=n)
    cum = np.cumsum(trans, axis=1)
    for t in range(seq):
        out[:, t] = state
        u = rng.random(n)[:, None]
        state = (u > cum[state]).sum(axis=1)
    return out


@dataclasses.dataclass
class LMStream:
    """Infinite next-token-prediction batches from a Markov corpus."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    concentration: float = 0.1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.trans = markov_chain(rng, self.vocab, self.concentration)
        self._rng = np.random.default_rng(self.seed + 1)

    def __iter__(self) -> Iterator[dict]:
        while True:
            toks = sample_markov(self._rng, self.trans, self.batch,
                                 self.seq + 1)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class ClassificationTask:
    """Class-conditional Markov sequences (the synthetic 'flowers')."""
    n_classes: int
    vocab: int
    seq: int
    seed: int = 0
    class_strength: float = 0.5     # 0 = identical classes, 1 = disjoint

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        base = markov_chain(rng, self.vocab)
        self.trans = []
        for _ in range(self.n_classes):
            pert = markov_chain(rng, self.vocab)
            self.trans.append(_row_normalize(
                (1 - self.class_strength) * base + self.class_strength * pert))
        self._rng = np.random.default_rng(self.seed + 7)

    def sample(self, n: int, rng: Optional[np.random.Generator] = None,
               classes: Optional[np.ndarray] = None) -> dict:
        rng = rng or self._rng
        labels = rng.integers(0, self.n_classes, size=n) if classes is None \
            else rng.choice(classes, size=n)
        toks = np.empty((n, self.seq), np.int32)
        for c in range(self.n_classes):
            idx = np.nonzero(labels == c)[0]
            if len(idx):
                toks[idx] = sample_markov(rng, self.trans[c], len(idx),
                                          self.seq)
        return {"tokens": toks, "label": labels.astype(np.int32)}

    def dataset(self, n: int, seed: int = 0) -> dict:
        """Fixed train/eval arrays (numpy, for partitioning)."""
        return self.sample(n, np.random.default_rng(seed))

    def pretrain_stream(self, batch: int) -> Iterator[dict]:
        """LM batches over the class mixture (the 'unlabeled corpus')."""
        while True:
            toks = self.sample(batch)["tokens"]
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
