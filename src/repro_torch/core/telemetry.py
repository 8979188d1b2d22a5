"""Unified host-side telemetry: counters, latency histograms, spans, traces.

A copy of ``repro/core/telemetry.py`` (stdlib only), kept in the port so
that ``repro_torch`` imports nothing of the JAX package.

The paper's whole argument is metric-driven (§III enumerates latency /
compute / energy / comm metrics for every workflow), but aggregate
per-round ledgers (core/comm.py::RoundCost, launch/engine.py::EngineStats)
can't answer the questions production serving is judged on: what is the
p99 time-to-first-token, how long did requests queue, what did the engine
actually execute and when. This module is the one instrument every tier
reports through:

- **Counters / gauges** — monotonically accumulated ints / last-written
  floats (``tel.count("relay.retries")``, ``tel.gauge("bank.slots", 8)``).
- **Log-bucketed latency histograms** — ``tel.observe("engine.ttft_s", dt)``
  records into geometric buckets (default 8 per decade), so p50/p95/p99
  come from bucket counts with bounded RELATIVE error (~±15% per bucket
  step) without ever storing samples: O(1) record, O(buckets) memory, no
  reservoir bias at the tail — the standard HDR-histogram trade.
- **Spans** — ``with tel.span("decode_segment", wave=3, rows=8):`` records
  a named interval on the monotonic clock (`time.perf_counter`), with
  nesting depth and the enclosing span tracked per thread. ``span(...) as
  sp`` allows late attributes (``sp.set(tokens=n)``) for values only known
  at exit. While a ``torch.profiler`` is collecting, an enabled span also
  opens a ``torch.profiler.record_function`` range of its own name, so it
  shows in the profiler's trace on the same timeline as the device's
  kernels.
- **The current telemetry** — model-level code (``models/``) records into
  :func:`current`, which a caller sets for a block with :func:`using`
  (``DecodeEngine`` does for each drain, with its own ``tel=`` or the
  global one); outside such a block it is a disabled instance.
- **Export** — :meth:`Telemetry.export_trace` writes Chrome trace-event
  JSON (open in Perfetto / chrome://tracing: one timeline row per thread,
  spans nested by enclosure), :meth:`Telemetry.snapshot` returns a plain
  dict (counters + gauges + histogram summaries), :meth:`Telemetry.report`
  a human-readable text block.

**Overhead discipline**: the module-level singleton defaults OFF, and every
disabled call is a guard-and-return — ``span()`` hands back one shared
no-op context manager (zero allocations on the hot path), ``observe`` /
``count`` return before touching any dict. Enabling is explicit
(:func:`enable`), per-component ``tel=`` arguments override the singleton.

Host-side by design: spans bracket *dispatches* (what the host asked
the device to do and when the result synced), not on-device kernel time;
the profiler ranges put them beside the kernels in a device trace. Not
thread-safe for concurrent writers beyond CPython atomicity; the engines
are host-serial.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# geometric bucket growth: 8 buckets per decade resolves percentiles to
# ~±15% relative error, plenty for latency SLOs (p99 = 12ms vs 13ms is
# noise; 12ms vs 120ms is the signal) at ~100 buckets across ns..minutes
_GROWTH = 10.0 ** (1.0 / 8.0)
_MIN_VALUE = 1e-9                      # 1ns floor: below it, bucket 0


class Histogram:
    """Log-bucketed scalar histogram: O(1) record, percentile from counts.

    Bucket ``i`` covers ``[min_value * growth**i, min_value * growth**(i+1))``;
    a recorded value increments its bucket count, so quantiles are read off
    the cumulative bucket counts and reported as the bucket's geometric
    midpoint — bounded relative error, no stored samples, no tail bias.
    """
    __slots__ = ("counts", "n", "total", "vmin", "vmax", "_log_g")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._log_g = math.log(_GROWTH)

    def record(self, value: float, n: int = 1) -> None:
        """Record ``value`` with multiplicity ``n`` (e.g. one per-token
        latency observed ``tokens`` times in one decode segment)."""
        v = float(value)
        idx = 0 if v <= _MIN_VALUE else int(
            math.log(v / _MIN_VALUE) / self._log_g) + 1
        self.counts[idx] = self.counts.get(idx, 0) + n
        self.n += n
        self.total += v * n
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def _bucket_value(self, idx: int) -> float:
        if idx == 0:
            return _MIN_VALUE
        # geometric midpoint of [g**(i-1), g**i) * min_value
        return _MIN_VALUE * _GROWTH ** (idx - 0.5)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) from bucket counts,
        clamped into the observed [min, max] so tiny histograms don't
        report a bucket edge outside what was ever recorded."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.n))
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= rank:
                return min(max(self._bucket_value(idx), self.vmin), self.vmax)
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> dict:
        """Plain-dict summary (snapshot / EngineStats embedding)."""
        return {"count": self.n, "sum": self.total, "mean": self.mean,
                "min": self.vmin if self.n else 0.0,
                "max": self.vmax if self.n else 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


@dataclasses.dataclass
class SpanRecord:
    """One span: monotonic start offset + duration (seconds, relative to
    the Telemetry epoch; the duration is 0 until the span closes), thread
    id, nesting depth, attrs, and ``parent``, the index in
    ``Telemetry.spans`` of the enclosing span (-1 at the top). A span is
    recorded when it opens, so a parent's index is below its children's."""
    name: str
    t0: float
    dur: float
    tid: int
    depth: int
    args: dict
    parent: int = -1


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-mode hot path."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args) -> None:
        return None


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Live span handle; recorded into the owning Telemetry when it opens,
    its duration set when it closes."""
    __slots__ = ("_tel", "name", "args", "_t0", "_depth", "_parent",
                 "_rec", "_range")

    def __init__(self, tel: "Telemetry", name: str, args: dict) -> None:
        self._tel = tel
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Attach attributes discovered mid-span (e.g. tokens served)."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        tel = self._tel
        local = tel._local
        self._depth = getattr(local, "depth", 0)
        self._parent = getattr(local, "open", -1)
        local.depth = self._depth + 1
        local.open = len(tel.spans)
        # a profiler range only while a profiler collects (the flag is
        # the module's; without torch imported none can be running)
        prof = sys.modules.get("torch.autograd.profiler")
        self._range = None
        if prof is not None and prof._is_profiler_enabled:
            self._range = prof.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        self._rec = SpanRecord(self.name, self._t0 - tel._epoch, 0.0,
                               threading.get_ident(), self._depth,
                               self.args, self._parent)
        tel.spans.append(self._rec)
        return self

    def __exit__(self, *exc) -> None:
        self._rec.dur = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        local = self._tel._local
        local.depth = self._depth
        local.open = self._parent


class Telemetry:
    """Registry of counters / gauges / histograms + span recorder.

    One instance per observed subsystem is fine (the runtime threads one
    through engine/bank/relay), but the common path is the module-level
    singleton: components resolve :func:`get` at call time, so
    ``telemetry.enable()`` before a run instruments everything with no
    construction-order coupling. Disabled (the default for the singleton)
    every method is a guard-and-return no-op.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self.spans: List[SpanRecord] = []
        self._local = threading.local()
        self._epoch = time.perf_counter()
        # Perfetto needs a wall-clock epoch; never used for durations.
        self._epoch_wall = time.time()    # tracelint: ignore[R3] trace epoch

    # -- recording ----------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float, n: int = 1) -> None:
        if not self.enabled:
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram()
        h.record(value, n)

    def span(self, name: str, **args):
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args)

    def record_span(self, name: str, t0: float, t1: float, **args) -> None:
        """Record an interval measured externally (``time.perf_counter``
        values) — e.g. a request lifecycle whose start predates the drain
        span. Depth 0: rendered as a top-level track row."""
        if not self.enabled:
            return
        self.spans.append(SpanRecord(name, t0 - self._epoch, t1 - t0,
                                     threading.get_ident(), 0, args))

    def reset(self) -> None:
        """Drop all recorded data (epoch restarts; enabled flag kept)."""
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()
        self.spans.clear()
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()    # tracelint: ignore[R3] trace epoch

    # -- reading ------------------------------------------------------------
    def hist_summary(self, name: str) -> Optional[dict]:
        h = self.hists.get(name)
        return h.summary() if h is not None else None

    def snapshot(self) -> dict:
        """Everything as one plain dict (JSON-serializable)."""
        return {
            "enabled": self.enabled,
            "epoch_unix_s": self._epoch_wall,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary() for k, h in self.hists.items()},
            "spans": len(self.spans),
        }

    def report(self) -> str:
        """Human-readable text block (the CLI --metrics-out companion)."""
        lines = [f"telemetry: {len(self.spans)} spans, "
                 f"{len(self.counters)} counters, {len(self.hists)} hists"]
        for k in sorted(self.counters):
            lines.append(f"  counter {k:<32} {self.counters[k]:g}")
        for k in sorted(self.gauges):
            lines.append(f"  gauge   {k:<32} {self.gauges[k]:g}")
        for k in sorted(self.hists):
            s = self.hists[k].summary()
            lines.append(
                f"  hist    {k:<32} n={s['count']} mean={s['mean']:.3e} "
                f"p50={s['p50']:.3e} p95={s['p95']:.3e} p99={s['p99']:.3e}")
        return "\n".join(lines)

    # -- trace export -------------------------------------------------------
    def trace_events(self, *, pid: int = 1) -> List[dict]:
        """Chrome trace-event list: one complete ("X") event per span
        (microsecond timestamps relative to the telemetry epoch), plus
        counter ("C") events at the trace end so totals show as tracks."""
        events: List[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "repro-telemetry"}}]
        tids = {}
        t_end = 0.0
        for sp in self.spans:
            tid = tids.setdefault(sp.tid, len(tids) + 1)
            events.append({
                "name": sp.name, "cat": sp.name.split(".")[0], "ph": "X",
                "ts": sp.t0 * 1e6, "dur": sp.dur * 1e6,
                "pid": pid, "tid": tid,
                "args": {k: _jsonable(v) for k, v in sp.args.items()}})
            t_end = max(t_end, sp.t0 + sp.dur)
        for name, value in sorted(self.counters.items()):
            events.append({"name": name, "ph": "C", "ts": t_end * 1e6,
                           "pid": pid, "tid": 0, "args": {"value": value}})
        return events

    def export_trace(self, path: str) -> int:
        """Write the Perfetto/chrome://tracing JSON file; returns the
        number of span events exported."""
        events = self.trace_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "metadata": {"epoch_unix_s": self._epoch_wall}}, f)
        return len(self.spans)

    def export_metrics(self, path: str) -> None:
        """Write :meth:`snapshot` as JSON."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


def _jsonable(v: Any):
    """Span attrs may carry numpy scalars; coerce to plain JSON types."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


# ---------------------------------------------------------------------------
# Module-level singleton (defaults OFF: zero-overhead unless asked for)
# ---------------------------------------------------------------------------

_GLOBAL = Telemetry(enabled=False)


def get() -> Telemetry:
    """The process-wide telemetry instance (disabled until :func:`enable`).
    Instrumented components resolve this at CALL time, so enabling after
    construction still instruments them."""
    return _GLOBAL


def enable(fresh: bool = True) -> Telemetry:
    """Switch the global instance on (optionally resetting recorded data);
    returns it for chaining (``tel = telemetry.enable()``)."""
    if fresh:
        _GLOBAL.reset()
    _GLOBAL.enabled = True
    return _GLOBAL


def disable() -> Telemetry:
    """Switch the global instance off (recorded data kept for export)."""
    _GLOBAL.enabled = False
    return _GLOBAL


class _Current(threading.local):
    """Per thread, the telemetry model-level code records into (a class
    default, so that reading it in a thread that never set it costs an
    attribute lookup and not a caught AttributeError)."""
    tel = Telemetry(enabled=False)


_CURRENT = _Current()


def current() -> Telemetry:
    """The telemetry that model-level code (``models/``) records into: the
    one made current by the innermost :func:`using` block of this thread,
    else a disabled instance. Resolved at call time, like :func:`get`."""
    return _CURRENT.tel


@contextlib.contextmanager
def using(tel: Telemetry):
    """Make ``tel`` current (:func:`current`) for the block; the previous
    one is current again on exit."""
    prev = _CURRENT.tel
    _CURRENT.tel = tel
    try:
        yield tel
    finally:
        _CURRENT.tel = prev
