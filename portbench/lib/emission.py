"""When each served token was produced, from the engine's decode segments.

The engine runs a wave's decode in segments (``model.segment``) of
``steps`` steps and sees their tokens only when a segment ends; a row
that is live in a segment with ``r`` tokens of its budget left takes
``min(steps, r)`` of them, one at each of the first steps. The harness
records each segment's call time, its ``steps`` and the host time at
which each of its steps was launched (``model.decode_step``, called once
a step; the launches are host-paced, the card idle most of the time, so
a step runs as it is launched). A finished request's first and last
host-visible tokens (``first``, ``done``) fall between its first and its
last segment's call and the next call, so the segments it was live in
are known, and with them the step at which each of its tokens was
produced.

A segment whose step calls were not seen one by one, or a request whose
tokens do not add up over its segments (``n_out`` left over, or a
segment before the first), makes :func:`token_times` return None: the
harness's view of the engine no longer holds, and no rate is read.
"""
from __future__ import annotations

import bisect

import numpy as np


def token_times(recs: list[dict], segs: list[dict]):
    """For each finished request (``first``, ``done``, ``n_out``), the
    times at which its tokens were produced, in order; None where the
    record and the segments disagree."""
    if any(len(s["step_t"]) != s["steps"] for s in segs):
        return None
    calls = [s["t"] for s in segs]
    out = []
    for r in recs:
        if r["first"] is None or r["n_out"] == 0:
            out.append(np.zeros(0))
            continue
        k0 = bisect.bisect_right(calls, r["first"]) - 1
        k1 = bisect.bisect_right(calls, r["done"]) - 1
        if k0 < 0 or k1 < k0:
            return None
        rem, parts = r["n_out"], []
        for k in range(k0, k1 + 1):
            n = min(segs[k]["steps"], rem)
            if n <= 0:
                return None
            parts.append(segs[k]["step_t"][:n])
            rem -= n
        if rem:
            return None
        out.append(np.concatenate(parts).astype(np.float64))
    return out


def in_window(times: list, w0: float, w1: float) -> int:
    """Tokens produced in ``[w0, w1)``."""
    return int(sum(((t >= w0) & (t < w1)).sum() for t in times))
