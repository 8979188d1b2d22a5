"""Traffic generators, in numpy, driven by a cell's parameters and a seed.

Every seed gets the same sizes and gaps in the same order: lengths are
the quantiles of their distribution at ``(i + 0.5) / n``, clipped, and
the inter-arrival gaps the quantiles of the exponential distribution,
shuffled by a fixed stream (:data:`ORDER`); the seed draws the token ids
and the tenants' order. So two seeds offer the same work: a drain's last
requests set how long its tail runs with few rows live, and with the
order drawn from the seed the rate of one cell spread by a quarter
between seeds.

- :func:`lognormal_lengths`: a heavy-tailed length set (prompts, outputs).
- :func:`zipf_counts`: how many of ``n`` requests each of ``k`` tenants
  sends under Zipf(s) popularity (largest remainder).
- :func:`poisson_gaps`: ``n`` inter-arrival gaps of a Poisson process.
- :func:`requests`: ``n`` requests of a cell's ``traffic`` block.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


ORDER = 0          # the seed of the sizes' and gaps' order, for every run


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per (seed, stream); any non-negative
    seed, 64-bit included."""
    tag = [ord(c) for c in stream]
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *tag])


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """``n`` lengths: the lognormal(ln median, sigma) quantiles at
    ``(i + 0.5) / n``, rounded and clipped to ``[lo, hi]``, ascending."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.exp(math.log(median) + sigma * z)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def zipf_counts(n: int, k: int, s: float) -> np.ndarray:
    """Requests per tenant (rank order) summing to ``n`` under Zipf(s)."""
    w = 1.0 / np.arange(1, k + 1) ** s
    share = n * w / w.sum()
    counts = np.floor(share).astype(np.int64)
    rest = n - counts.sum()
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


def poisson_gaps(n: int, rate: float) -> np.ndarray:
    """The exponential(rate) quantiles at ``(i + 0.5) / n`` (mean
    ``1 / rate`` up to the discretisation)."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def requests(traffic: dict, n: int, seed: int, stream: str,
             vocab: int, domains: list) -> list[dict]:
    """``n`` requests of the ``traffic`` block: prompt tokens, output
    budget and tenant of each, in a seed-drawn order. Keys of
    ``traffic``: ``prompt`` and ``output`` ({median, sigma, min, max}),
    ``zipf_s`` (tenant popularity)."""
    rng, order = rng_for(seed, stream), rng_for(ORDER, stream)
    p, o = traffic["prompt"], traffic["output"]
    plen = order.permutation(lognormal_lengths(n, p["median"], p["sigma"],
                                               p["min"], p["max"]))
    olen = order.permutation(lognormal_lengths(n, o["median"], o["sigma"],
                                               o["min"], o["max"]))
    counts = zipf_counts(n, len(domains), traffic["zipf_s"])
    tenants = rng.permutation(np.repeat(np.arange(len(domains)), counts))
    out = []
    for i in range(n):
        out.append({"tokens": rng.integers(0, vocab, int(plen[i]),
                                           dtype=np.int64).astype(np.int32),
                    "gen": int(olen[i]),
                    "domain": domains[int(tenants[i])]})
    return out


def arrivals(traffic: dict, seconds: float, seed: int, stream: str,
             vocab: int, domains: list, t0: float = 0.0) -> list[dict]:
    """Open-loop arrivals at ``traffic['rate']`` per second for
    ``seconds``: ``round(rate * seconds)`` requests, each with its due
    time ``t`` (offset from the trace's start), the first due at ``t0``
    plus its gap."""
    n = max(1, int(round(traffic["rate"] * seconds)))
    gaps = rng_for(ORDER, stream + ".gaps").permutation(
        poisson_gaps(n, traffic["rate"]))
    reqs = requests(traffic, n, seed, stream, vocab, domains)
    t = t0 + np.cumsum(gaps)
    for r, ti in zip(reqs, t):
        r["t"] = float(ti)
    return reqs
