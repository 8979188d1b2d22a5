"""Open-loop serving: timed arrivals through ``DecodeEngine.serve_trace``
with an ``AdapterBank``, greedy. Below the knee the tails are what a
user feels; above it the output tokens per second that the engine
produces in the window (``serve_tok_s``), and the tails are recorded
beside it.

Cell keys: ``slots``; ``burst``, requests due at once when the trace
starts: more than ``slots``, so the first wave fills every slot and
leaves a queue (the engine sizes a segment by the largest budget left
when its queue is empty, and admits only between segments: with an
empty queue after the first wave, its first segment ran 512 steps, and
the rate in the window swung by a third with the host's speed);
``lead_in_s``, seconds of arrivals at the cell's rate after the burst
and before the window (set-up the traffic needs: the first wave, which
prefills every slot, and the climb to a steady load); ``traffic``
(``rate``, ``prompt``, ``output``, ``domains``, ``zipf_s``;
``lib/traffic.py``); ``trace`` (``offset_s``, ``seconds``: the profiled
sub-window inside the window); ``check``.

The window is ``[lead_in_s, lead_in_s + seconds)`` of the trace's clock.
``serve_tok_s`` counts every output token produced in it, of whatever
request (``lib/emission.py``), over its length. The arrivals due in it
are the window's requests: each is served to its end, however long after
the window that is, and its latency is taken from its due time, so a
request that arrived during a long segment counts its wait (the engine
stamps its own submit time only when it polls the arrivals between
segments).
"""
from __future__ import annotations

import time

import numpy as np

from portbench.lib import serving, traffic


def _load(window: list, w1: float) -> dict:
    """How the engine kept up: the drain-down past the window, the
    window's arrivals still queued at its end, and the median time to
    first token of its first and last thirds of arrivals (a growing
    backlog shows as the second above the first)."""
    if not window:
        return {}
    by_due = sorted(window, key=lambda r: r["due"])
    k = max(1, len(by_due) // 3)
    med = lambda rs: float(np.median([r["first"] - r["due"] for r in rs]))
    return {"drain_down_s": max(r["done"] for r in window) - w1,
            "queued_at_window_end": sum(1 for r in window
                                        if r["admit"] >= w1),
            "ttft_median_first_third_s": med(by_due[:k]),
            "ttft_median_last_third_s": med(by_due[-k:])}


def run(ctx) -> dict:
    cell, tr = ctx.cell, ctx.cell["traffic"]
    sv = serving.Served(ctx)
    vocab = ctx.cfg.vocab_size
    burst = traffic.requests(tr, cell["burst"], ctx.seed, "burst", vocab,
                             sv.domains)
    for r in burst:
        r["t"] = 0.0
    lead = burst + traffic.arrivals(tr, cell["lead_in_s"], ctx.seed, "lead",
                                    vocab, sv.domains)
    win = traffic.arrivals(tr, ctx.seconds, ctx.seed, "window", vocab,
                           sv.domains, t0=cell["lead_in_s"])
    reqs = lead + win
    trace = [(r["t"], r["tokens"], r["gen"], {"domain": r["domain"]})
             for r in reqs]
    ctx.ready()                                # weights made, kernels built
    t_call = time.perf_counter()
    w0 = t_call + cell["lead_in_s"]
    if ctx.trace:
        ts = cell["trace"]
        ctx.open_window(w0 + ts["offset_s"], ts["seconds"])
    comps, stats = sv.engine.serve_trace(sv.params, trace)
    if ctx.window is not None:
        ctx.window.stop()
    t0 = sv.engine._trace_t0               # the trace's clock origin
    w0, w1 = t0 + cell["lead_in_s"], t0 + cell["lead_in_s"] + ctx.seconds
    ctx.window_start = w0
    # the k-th submit is the k-th arrival in due order
    order = sorted(range(len(reqs)), key=lambda i: reqs[i]["t"])
    req_of = {uid: order[k] for k, uid in enumerate(sv.submitted)}
    done, window = [], []
    for c in comps:
        i = req_of[c.uid]
        rec = sv.record(c, reqs[i], t0 + reqs[i]["t"])
        done.append(rec)
        if i >= len(lead):
            window.append(rec)
    ctx.mark_memory()
    load = _load(window, w1)
    made = sv.produced(done, w0, w1)
    ctx.notes.update(load, window_tokens=made["tokens"])
    obs = {"requests": window, "all_requests": done,
           "window_tokens": made["tokens"], "window_flops": made["flops"],
           "segments": sv.segments(w0, w1),
           "all_segments": sv.segments(float("-inf"), float("inf")),
           "window": (w0, w1), "stats": [stats],
           "attempted": len(win),
           "failed": len(win) - sum(1 for r in window if not r["timed_out"])}
    sv.free_program()
    obs["checks"] = sv.check(window)
    return obs
