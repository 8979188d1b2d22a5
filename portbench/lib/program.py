"""The program's own spans (``repro_torch.core.telemetry``), as the
benchmark reads them.

The program records its spans into the telemetry the traced run hands
the engine (``ctx.tel``), and names it in each drain's ``EngineStats.tel``
(the run's ``obs["stats"]``), where :func:`telemetry` finds it: ``engine.prefill`` / ``engine.refill`` (with
``device_ms``, the stream time from the span's first launch to its last
op's completion), ``model.decode_step`` (one a step), and inside a step
``layer.attn``, ``layer.ffn`` (the moe's ``moe.route``, ``moe.experts``,
``moe.combine`` inside it), ``model.head``; ``model.sample`` follows each
step. While the profiler collects, each span is also a profiler range of
its own name, on the device trace's clock.

:func:`spans` reads the records. :func:`read_trace` reads the profiler's
trace file before ``lib/trace.py::read`` deletes it, which ``run.py``
does not do: ``spans.py`` does, for the launch count and the notes. A
program without these spans (tracing off, or a version that records
none) gives None and empty notes: nothing here raises for want of them.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

STEP = "model.decode_step"
# the CUDA runtime and driver calls that put work on a stream
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cudaMemcpyAsync", "cudaMemsetAsync",
                      "cudaGraphLaunch"})
_HOST_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HARNESS = ("hb:", "pb:")               # the benchmark's own ranges
# ranges that name what a nested range serves: a layer's idle inside a
# step is "model.decode_step > layer.attn", inside a refill's prefill
# "engine.refill > layer.attn"
ANCHORS = ("model.decode_step", "engine.refill", "engine.prefill")


def is_launch(name: str) -> bool:
    return name in LAUNCHES or name.startswith("cuLaunchKernel")


def is_sync(name: str) -> bool:
    return name.startswith("cu") and name.endswith("Synchronize")


def telemetry(obs: dict):
    """The telemetry the run's drains recorded into (``EngineStats.tel``
    of ``obs["stats"]``); None where tracing was off or the program names
    none."""
    for st in obs.get("stats") or []:
        tel = getattr(st, "tel", None)
        if tel is not None:
            return tel
    return None


def spans(tel, w0: float, w1: float):
    """The ``model.decode_step`` spans begun in ``[w0, w1)`` (host clock):
    ``steps``, each one's host seconds; ``total`` and ``self``, seconds by
    span name summed over the spans inside those steps (the steps
    included), ``self`` a span's time less its children's. None where
    there is no such step."""
    if tel is None:
        return None
    recs = tel.spans
    step_of: list = [None] * len(recs)   # the step a record lies in
    steps = []
    total: dict = defaultdict(float)
    own: dict = defaultdict(float)
    for i, s in enumerate(recs):
        p = getattr(s, "parent", -1)
        if s.name == STEP and w0 <= tel._epoch + s.t0 < w1:
            step_of[i] = i
            steps.append(s.dur)
        elif p >= 0:
            step_of[i] = step_of[p]      # a parent precedes its children
        if step_of[i] is None:
            continue
        total[s.name] += s.dur
        own[s.name] += s.dur
        if step_of[i] != i:
            own[recs[p].name] -= s.dur
    if not steps:
        return None
    return {"steps": steps, "total": dict(total), "self": dict(own)}


def device_ms(tel, name: str, w0: float, w1: float) -> list:
    """``device_ms`` of the spans ``name`` begun in ``[w0, w1)``."""
    if tel is None:
        return []
    return [s.args["device_ms"] for s in tel.spans
            if s.name == name and "device_ms" in s.args
            and w0 <= tel._epoch + s.t0 < w1]


def _x(ev, cats):
    return [e for e in ev if e.get("ph") == "X" and e.get("cat") in cats]


def _covering(ranges: list, points: list) -> list:
    """For each of the sorted ``points``, the names of the ranges of
    ``ranges`` (one thread's, so nested) that cover it, outermost first."""
    out, stack, j = [], [], 0
    order = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    for t in points:
        while j < len(order) and order[j]["ts"] <= t:
            r = order[j]
            while stack and stack[-1][0] < r["ts"]:
                stack.pop()
            stack.append((r["ts"] + r["dur"], r["name"]))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append(tuple(name for _, name in stack))
    return out


def _gap_name(path: tuple):
    """The innermost range of ``path``, after the outermost anchor that
    holds it; None for no range."""
    if not path:
        return None
    for a in path[:-1]:
        if a in ANCHORS:
            return f"{a} > {path[-1]}"
    return path[-1]


def read_trace(path: str):
    """What the program's ranges say in one profiler trace file (left in
    place): ``steps``, the ``model.decode_step`` ranges; ``launches`` and
    ``syncs``, the launch and blocking CUDA calls made inside them on
    their thread; ``gaps_s``, the device's idle gaps in seconds by the
    innermost program range around each gap's middle, after the step,
    refill or prefill that holds it (``model.decode_step > layer.attn``;
    else the innermost harness range, ``hb:<name>``, else ``outside``).
    None where the trace holds no step range."""
    try:
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    except (OSError, ValueError, KeyError):
        return None
    annot = _x(ev, ("user_annotation",))
    prog = [e for e in annot if not e["name"].startswith(_HARNESS)]
    step = sorted((e for e in prog if e["name"] == STEP),
                  key=lambda e: e["ts"])
    if not step:
        return None
    tid = step[0]["tid"]
    starts = [e["ts"] for e in step]
    launches = syncs = 0
    for e in _x(ev, _HOST_CATS):
        launch, sync = is_launch(e["name"]), is_sync(e["name"])
        if e["tid"] != tid or not (launch or sync):
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= step[i]["ts"] + step[i]["dur"]:
            launches += launch
            syncs += sync
    merged: list = []
    for s, d in sorted((float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in _x(ev, _DEVICE_CATS)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    gaps = [((e0 + s1) / 2, s1 - e0)
            for (_, e0), (s1, _) in zip(merged, merged[1:])]
    mids = [m for m, _ in gaps]
    inner = _covering([e for e in prog if e["tid"] == tid], mids)
    harness = _covering([e for e in annot if e["tid"] == tid
                         and e["name"].startswith("hb:")], mids)
    gaps_s: dict = defaultdict(float)
    for (_, g), p, h in zip(gaps, inner, harness):
        gaps_s[_gap_name(p) or _gap_name(h) or "outside"] += g / 1e6
    return {"steps": len(step), "launches": launches, "syncs": syncs,
            "gaps_s": dict(gaps_s)}


def notes(obs: dict, pt=None) -> dict:
    """What the program's spans say beside the metrics:
    ``step_host_ms_by_span`` (each span's self time a step, ms) from the
    records, and from ``pt`` (:func:`read_trace`) ``launches_per_step``,
    ``syncs_per_step`` and ``idle_gaps_by_span``; empty where the run has
    neither spans nor a trace."""
    out = {}
    sp = spans(telemetry(obs), *obs["window"]) if "window" in obs else None
    if sp:
        n = len(sp["steps"])
        out["step_host_ms_by_span"] = {k: 1e3 * v / n
                                       for k, v in sp["self"].items()}
    if pt:
        out["launches_per_step"] = pt["launches"] / pt["steps"]
        out["syncs_per_step"] = pt["syncs"] / pt["steps"]
        out["idle_gaps_by_span"] = pt["gaps_s"]
    return out
