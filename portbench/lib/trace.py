"""The traced sub-window: ``torch.profiler`` over a few seconds of the
measured window, and what the benchmark reads from its trace.

:class:`SubWindow` starts the profiler (CPU and CUDA activity) once the
run's clock passes ``start`` and stops it once it passes ``end``; the
driver calls :meth:`SubWindow.tick` from the hooks it has around the
program's calls, so the edges fall between two calls. The trace is
written as Chrome trace JSON under ``TMPDIR``, read by :func:`read`, and
deleted.

:func:`read` gives the device's busy time (the union of the intervals of
kernels, copies and fills), each kernel's time, the device time of each
probe range ``pb:<i>`` (``lib/probes.py``: a kernel belongs to the range
on whose thread, and inside which, its launch call ran), and the idle
gaps, each named by the harness range (``hb:<name>``) the host was in
at the gap's middle, and the kernels' time by :func:`group`.

:func:`group` and :func:`busy_us` are frozen copies of the port's
``launch/profile.py``.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

# substrings of the port's CUDA kernels' names (kernels/csrc)
PORT_KERNELS = ("lora_", "attn_wgmma", "flash_attention", "flash_decode",
                "decode_split", "selective_scan", "rglru_scan")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def group(name: str) -> str:
    """The group of a device kernel (the port's ``launch/profile.py``)."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "cublas",
                                       "nvjet")):
        return "GEMM (cuBLAS)"
    return "other device work"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class SubWindow:
    """Profiles ``seconds`` of the run's ``time.perf_counter`` clock from
    the first tick at or past ``start``; ``probes`` (optional) record
    kernel calls while it is on."""

    def __init__(self, start: float, seconds: float, probes=None):
        self.start, self.seconds = start, seconds
        self.probes = probes
        self.prof = None
        self.t0 = self.t1 = None
        self.path = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self.prof is None and self.t0 is None and now >= self.start:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            if self.probes is not None:
                self.probes.active = True
            self.t0 = time.perf_counter()
        elif self.prof is not None and now >= self.t0 + self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.probes is not None:
            self.probes.active = False
        self.prof.stop()
        fd, self.path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


def _x(ev, cats):
    return [e for e in ev if e.get("ph") == "X" and e.get("cat") in cats]


def read(path: str, window_s: float) -> dict:
    """What the benchmark reads from one trace file (then deleted)."""
    try:
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev = _x(ev, _DEVICE_CATS)
    launch = {e["args"]["correlation"]: e for e in _x(ev, _LAUNCH_CATS)
              if "correlation" in e.get("args", {})}
    annot = sorted((e for e in _x(ev, ("user_annotation",))
                    if e["name"].startswith(("pb:", "hb:"))),
                   key=lambda e: e["ts"])
    probe = [e for e in annot if e["name"].startswith("pb:")]
    host = [e for e in annot if e["name"].startswith("hb:")]
    by_tid: dict = defaultdict(list)
    for e in probe:
        by_tid[e["tid"]].append(e)
    starts = {t: [e["ts"] for e in lst] for t, lst in by_tid.items()}

    def owner(ts, tid):
        lst = by_tid.get(tid)
        if not lst:
            return None
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and ts <= lst[i]["ts"] + lst[i]["dur"]:
            return int(lst[i]["name"][3:])
        return None

    kernels: dict = defaultdict(float)
    probe_us: dict = defaultdict(float)
    spans = []
    for e in dev:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((s, s + d))
        if e.get("cat") == "kernel":
            kernels[e["name"]] += d
        corr = e.get("args", {}).get("correlation")
        ln = launch.get(corr)
        if ln is not None:
            i = owner(float(ln["ts"]), ln["tid"])
            if i is not None:
                probe_us[i] += d
    busy = busy_us(spans)
    groups: dict = defaultdict(float)
    for k, v in kernels.items():
        groups[group(k)] += v / 1e6
    # idle gaps on the device, named by the harness range around them
    gaps: dict = defaultdict(float)
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    hs = [e["ts"] for e in host]
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(hs, mid) - 1
        name = "host: outside the harness's ranges"
        # innermost enclosing range: the latest-starting one that covers
        while i >= 0:
            h = host[i]
            if h["ts"] + h["dur"] >= mid:
                name = h["name"][3:]
                break
            i -= 1
        gaps[name] += (s1 - e0) / 1e6
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "kernels_s": {k: v / 1e6 for k, v in kernels.items()},
            "probe_s": {i: v / 1e6 for i, v in probe_us.items()},
            "gaps_s": dict(gaps), "groups_s": dict(groups),
            "n_device_events": len(dev)}


def breakdown(tr: dict) -> dict:
    """The ``breakdown`` of the result line: the ten device operations
    that took most time, and the ten largest idle totals by host range."""
    ops = sorted(tr["kernels_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["gaps_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def roofline_share(bounds: list, probe_s: dict, group_of: dict,
                   grp: str):
    """Sum of the bounds over the sum of the device time of the probed
    calls of kernel group ``grp``, as a percentage; None where no call
    of the group ran kernels inside the traced window."""
    b = t = 0.0
    for i, (name, ms) in enumerate(bounds):
        if group_of.get(name) != grp or i not in probe_s:
            continue
        b += ms / 1e3
        t += probe_s[i]
    return 100.0 * b / t if t > 0 else None
