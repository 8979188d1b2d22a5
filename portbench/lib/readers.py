"""What the metric readers (``metrics/<name>.py``) share. Each takes the
run's observations ``obs`` and returns a number, or None where the run
holds nothing to read."""
from __future__ import annotations

from portbench.lib import flops, stats, trace

PEAK = flops.PEAK_BF16


def ttft_s(obs):
    reqs = obs.get("requests") or []
    return [r["first"] - r["due"] for r in reqs if r["first"] is not None]


def tpot_ms(obs):
    reqs = obs.get("requests") or []
    return [1e3 * (r["done"] - r["first"]) / (r["n_out"] - 1)
            for r in reqs if r["first"] is not None and r["n_out"] > 1]


def queue_s(obs):
    return [r["admit"] - r["due"] for r in obs.get("requests") or []]


def p95(vals):
    return stats.pct(vals, 95) if vals else None


def padded_share(obs):
    st = obs.get("stats") or []
    tok = sum(s.tokens for s in st)
    pad = sum(s.padded_tokens for s in st)
    return 100.0 * pad / (tok + pad) if tok + pad else None


def decode_step_ms(obs):
    segs = obs.get("segments") or []
    steps = sum(n for _, _, n in segs)
    return 1e3 * sum(d for _, d, _ in segs) / steps if steps else None


def segment_mfu(obs):
    """Model FLOPs of every decode token served, over the time of every
    decode segment, as a share of the peak."""
    segs = obs.get("all_segments") or []
    t = sum(d for _, d, _ in segs)
    if not t:
        return None
    sz = obs["sizes"]
    f = sum(flops.decode_flops(sz, r["prompt"], r["n_out"])
            for r in obs["all_requests"])
    return 100.0 * f / t / PEAK


def window_tok_s(obs):
    """Output tokens produced in the window over its length."""
    if obs.get("window_tokens") is None:
        return None
    w0, w1 = obs["window"]
    return obs["window_tokens"] / (w1 - w0)


def window_mfu(obs):
    """Model FLOPs of the work done in the window (the prompts admitted
    in it, the tokens produced in it) over its length, as a share of the
    peak."""
    if obs.get("window_flops") is None:
        return None
    w0, w1 = obs["window"]
    return 100.0 * obs["window_flops"] / (w1 - w0) / PEAK


def roofline(obs, grp: str):
    tr = obs.get("trace")
    if not tr:
        return None
    from portbench.lib.probes import GROUPS
    return trace.roofline_share(tr["bounds"], tr["probe_s"], GROUPS, grp)


def idle_share(obs):
    tr = obs.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
