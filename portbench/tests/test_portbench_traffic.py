"""Traffic: one seed gives one trace; seeds reorder the same sizes."""
import numpy as np

from portbench.lib import traffic

TR = {"rate": 8.0, "domains": 8, "zipf_s": 1.1,
      "prompt": {"median": 512, "sigma": 0.8, "min": 64, "max": 2048},
      "output": {"median": 128, "sigma": 0.8, "min": 16, "max": 512}}
DOMS = [f"d{i}" for i in range(8)]


def _arr(seed):
    return traffic.arrivals(TR, 30.0, seed, "window", 152064, DOMS, t0=20.0)


def test_same_seed_same_trace():
    a, b = _arr(3_000_000_001), _arr(3_000_000_001)
    assert len(a) == len(b) == 240
    for x, y in zip(a, b):
        assert x["t"] == y["t"] and x["gen"] == y["gen"]
        assert x["domain"] == y["domain"]
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_seeds_differ_in_content_not_in_work():
    a, b = _arr(7), _arr(2 ** 31 + 5)
    assert any(not np.array_equal(x["tokens"], y["tokens"])
               for x, y in zip(a, b))
    assert [r["domain"] for r in a] != [r["domain"] for r in b]
    assert sorted(r["domain"] for r in a) == sorted(r["domain"] for r in b)
    # the same sizes and due times, in the same order
    assert [(r["t"], r["gen"], len(r["tokens"])) for r in a] == \
        [(r["t"], r["gen"], len(r["tokens"])) for r in b]
    assert all(20.0 < r["t"] < 20.0 + 30.0 * 1.5 for r in a)
    # another stream (a later drain) orders them otherwise
    c = traffic.arrivals(TR, 30.0, 7, "drain1", 152064, DOMS)
    assert [r["gen"] for r in c] != [r["gen"] for r in a]


def test_distributions():
    p = traffic.lognormal_lengths(1001, 512, 0.8, 64, 2048)
    assert p.min() >= 64 and p.max() <= 2048 and np.median(p) == 512
    c = traffic.zipf_counts(240, 8, 1.1)
    assert c.sum() == 240 and all(np.diff(c) <= 0)
    g = traffic.poisson_gaps(10000, 8.0)
    assert abs(g.mean() - 1 / 8.0) < 0.01 / 8.0
