"""Saturated serving: back-to-back ``DecodeEngine.run`` drains of a fixed
number of requests each, through an ``AdapterBank``, greedy.

Cell keys: ``slots``; ``drain_requests`` (each drain's queue, at least
twice the slots, so every drain refills slots in-wave);
``warm`` (``drains`` before the window, from a traffic stream of their
own, each request's output cut to ``gen`` tokens: set-up that loads
every kernel and sizes the allocator for the first wave's buffers,
whose shapes are the window's); ``traffic`` (``prompt``, ``output``,
``domains``, ``zipf_s``); ``trace`` (``offset_s``, ``seconds``);
``check``.

The window is ``--seconds`` long from the submission of the first
measured drain; drains follow each other until one ends past it, and
that one is served to its end and checked. ``serve_tok_s`` counts every
output token produced in the window (``lib/emission.py``) over its
length: drain tails and the next drain's first wave are in it as they
fall. Drain k offers the same sizes in the same order on every seed
(``lib/traffic.py``).
"""
from __future__ import annotations

import time

from portbench.lib import serving, traffic


def _drain(sv, reqs):
    for r in reqs:
        sv.engine.submit(r["tokens"], r["gen"], domain=r["domain"])
    return sv.engine.run(sv.params)


def run(ctx) -> dict:
    cell, tr = ctx.cell, ctx.cell["traffic"]
    sv = serving.Served(ctx)
    vocab, n = ctx.cfg.vocab_size, cell["drain_requests"]
    for k in range(cell["warm"]["drains"]):
        reqs = traffic.requests(tr, n, ctx.seed, f"warm{k}", vocab,
                                sv.domains)
        _drain(sv, [{**r, "gen": min(r["gen"], cell["warm"]["gen"])}
                    for r in reqs])
    ctx.ready()
    w0 = time.perf_counter()
    ctx.window_start = w0
    if ctx.trace:
        ts = cell["trace"]
        ctx.open_window(w0 + ts["offset_s"], ts["seconds"])
    done, stats, k = [], [], 0
    while True:
        reqs = traffic.requests(tr, n, ctx.seed, f"drain{k}", vocab,
                                sv.domains)
        base = len(sv.submitted)
        comps, st = _drain(sv, reqs)
        uids = sv.submitted[base:]
        by_uid = {u: reqs[j] for j, u in enumerate(uids)}
        for c in comps:
            done.append(sv.record(c, by_uid[c.uid], sv.t_submit[c.uid]))
        stats.append(st)
        k += 1
        if time.perf_counter() - w0 >= ctx.seconds:
            break
    t_end = time.perf_counter()
    if ctx.window is not None:
        ctx.window.stop()
    ctx.mark_memory()
    w1 = w0 + ctx.seconds
    made = sv.produced(done, w0, w1)
    ctx.notes.update(window_tokens=made["tokens"], drains=k,
                     drain_down_s=t_end - w1)
    obs = {"requests": done, "all_requests": done,
           "window_tokens": made["tokens"], "window_flops": made["flops"],
           "segments": sv.segments(w0, w1),
           "all_segments": sv.segments(w0, t_end), "window": (w0, w1),
           "stats": stats, "drains": k, "attempted": n * k,
           "failed": n * k - sum(1 for r in done if not r["timed_out"])}
    sv.free_program()
    obs["checks"] = sv.check(done)
    return obs
