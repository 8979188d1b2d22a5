"""What the serving drivers share: the program under test built from
the seed (backbone, adapter bank, engine), the harness's hooks around
the calls into the program's layers, and the check of what it served.

Hooks (installed at run time, the program unedited):

- ``engine.submit`` on the engine instance: the host time at which each
  request entered the queue (``Request.t_submit``), by uid;
- ``model.wave_prefill``, ``model.refill``, ``model.segment``,
  ``model.decode_step``: profiler ranges ``hb:<name>`` in the traced
  run, which name the host's part in the device's idle gaps (a step's
  range opens after the tick, so the sub-window's first step has one);
- ``model.decode_step``, ``engine._admit_due`` and ``engine.submit``
  tick the traced sub-window (``lib/trace.py``), so it opens and
  closes between two calls;
- ``model.segment`` and ``model.decode_step``: each segment's call
  time, steps and step launch times (``lib/emission.py``: when each
  served token was produced), in every run.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from portbench.lib import check, emission, weights


class Served:
    """The program for one serving cell, and the inputs both it and the
    reference take."""

    def __init__(self, ctx):
        from repro_torch.core.adapter_bank import AdapterBank
        from repro_torch.launch.engine import DecodeEngine
        cell, tr = ctx.cell, ctx.cell["traffic"]
        self.ctx = ctx
        self.domains = [f"domain{i}" for i in range(tr["domains"])]
        self.backbone, adapters = weights.model(ctx.cfg, ctx.seed,
                                                ctx.device, len(self.domains))
        self.adapters = dict(zip(self.domains, adapters))
        self.bank = AdapterBank.create(self.adapters)
        self.engine = DecodeEngine(ctx.cfg, slots=cell["slots"], greedy=True,
                                   seed=ctx.seed % (2 ** 63), bank=self.bank,
                                   tel=ctx.tel, device=ctx.device)
        self.params = {"backbone": self.backbone,
                       "adapters": self.bank.stacked}
        self.t_submit: dict[int, float] = {}
        self.submitted: list[int] = []
        self.segs: list[dict] = []         # model.segment calls, in order
        self._seg = None                   # the segment being launched
        self._undo: list = []
        self._hook()

    # -- hooks ---------------------------------------------------------
    def _tick(self):
        if self.ctx.window is not None:
            self.ctx.window.tick()

    def _hook(self):
        from repro_torch.models import model as M
        eng, orig_submit = self.engine, self.engine.submit

        @functools.wraps(orig_submit)
        def submit(*a, **kw):
            uid = orig_submit(*a, **kw)
            self.t_submit[uid] = eng._queue[-1].t_submit
            self.submitted.append(uid)
            self._tick()
            return uid
        eng.submit = submit
        orig_admit = eng._admit_due

        def admit_due():
            self._tick()
            return orig_admit()
        eng._admit_due = admit_due
        traced = self.ctx.trace
        for name in ("wave_prefill", "refill", "segment", "decode_step"):
            orig = getattr(M, name)
            setattr(M, name, self._wrap(name, orig, traced))
            self._undo.append((M, name, orig))

    def _wrap(self, name, orig, traced):
        tick = self._tick

        @functools.wraps(orig)
        def hooked(*a, **kw):
            if name == "decode_step":
                tick()
                if self._seg is not None:
                    self._seg["step_t"].append(time.perf_counter())
            elif name == "segment":
                steps = kw["steps"] if "steps" in kw else a[2]
                self._seg = {"t": time.perf_counter(), "steps": int(steps),
                             "step_t": []}
            try:
                if not traced:
                    return orig(*a, **kw)
                with torch.profiler.record_function(f"hb:model.{name}"):
                    return orig(*a, **kw)
            finally:
                if name == "segment":
                    self.segs.append(self._seg)
                    self._seg = None
        return hooked

    def unhook(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()

    def free_program(self):
        """Drop the program's own state (engine, bank) before the check;
        the benchmark's inputs (weights, adapters) stay for the reference."""
        self.unhook()
        self.engine = self.bank = None
        self.params = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- records -------------------------------------------------------
    def record(self, comp, req: dict, due: float) -> dict:
        """One finished request's times (host clock) and tokens."""
        t0 = self.t_submit[comp.uid]
        return {"due": due, "submit": t0, "admit": t0 + comp.queue_s,
                "first": (t0 + comp.ttft_s) if comp.ttft_s is not None
                else None,
                "done": t0 + comp.latency_s, "prompt": len(req["tokens"]),
                "n_out": len(comp.tokens), "out": np.asarray(comp.tokens),
                "tokens": req["tokens"], "domain": req["domain"],
                "timed_out": bool(comp.timed_out)}

    def segments(self, t0: float, t1: float) -> list[tuple[float, float, int]]:
        """(start, seconds, steps) of the ``engine.segment`` spans that
        began in [t0, t1) (traced run: the program's telemetry on)."""
        tel = self.ctx.tel
        if tel is None:
            return []
        out = []
        for s in tel.spans:
            if s.name != "engine.segment" or "seg" not in s.args:
                continue
            start = tel._epoch + s.t0
            if t0 <= start < t1:
                out.append((start, s.dur, int(s.args["seg"])))
        return out

    def produced(self, recs: list[dict], w0: float, w1: float) -> dict:
        """Tokens of ``recs`` (every request the run finished) produced
        in ``[w0, w1)``, and the decode FLOPs of those tokens and the
        prefill FLOPs of the prompts admitted in it (``lib/flops.py``);
        ``tokens`` None where the segments and records disagree."""
        from portbench.lib import flops
        times = emission.token_times(recs, self.segs)
        if times is None:
            return {"tokens": None, "flops": None}
        sz = self.ctx.sizes
        f = 0.0
        for r, t in zip(recs, times):
            if w0 <= r["admit"] < w1:
                f += flops.prefill_flops(sz, r["prompt"])
            for i in np.nonzero((t >= w0) & (t < w1))[0]:
                if i:                    # token 0 comes from the prefill
                    f += flops.token_flops(
                        sz, r["prompt"] + int(i) + sz["n_prefix"], True)
        return {"tokens": emission.in_window(times, w0, w1), "flops": f}

    def check(self, done: list[dict]) -> dict:
        """The numbers compared, each beside its limit."""
        cell = self.ctx.cell
        ref = self.ctx.reference
        pick = check.sample(done, self.ctx.seed, cell["check"]["tokens"],
                            cell["check"]["requests"])
        reqs = [done[i] for i in pick]
        t0 = time.perf_counter()
        got = check.served_gaps(ref, self.backbone, self.adapters,
                                self.ctx.sizes, reqs, self.ctx.device)
        self.ctx.check_s = time.perf_counter() - t0
        self.ctx.notes["program"] = got
        if self.ctx.control:
            # the control in the program's place: its tokens are judged
            got = self.ctx.notes["control"] = check.control_gaps(
                ref, self.backbone, self.adapters, self.ctx.sizes, reqs,
                self.ctx.device)
        self.ctx.checked_tokens = int(sum(len(r["out"]) for r in reqs))
        num = cell["check"]["number"]
        return {num: {"value": got[num], "limit": cell["check"]["limit"]}}
