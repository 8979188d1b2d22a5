"""Ragged continuous-batching decode engine, dense mode, single- and
multi-tenant (counterpart of ``repro/launch/engine.py``).

One ``run()`` drain:

1. **Pack** — free slots fill from the queue FIFO with no length
   bucketing; prompts are right-padded to the pack's longest, rounded up
   to a power of two.
2. **Prefill** — one dispatch builds every packed row's decode state with
   per-row cache positions (``model.wave_prefill``). The cache capacity
   ``cap`` is sized once per drain: the power-of-two ceiling of the
   largest ``prompt + budget`` in the queue.
3. **Decode segments** — each segment's length is the power-of-two floor
   of the smallest remaining budget among live rows (of the largest once
   the queue is empty), so no segment outlasts the next retirement.
4. **Retire + refill in-wave** — a row that spends its budget retires
   inside the segment (its cache writes are dropped, its position
   freezes); at the next segment boundary its slot is re-prefilled from
   the queue (``model.refill``).
5. **Account** — ``EngineStats.tokens`` counts served tokens and
   ``padded_tokens`` the slot-steps that served nothing.

The host-side logic is the reference's, so for one queue both engines
count the same ``waves``, ``segments``, ``tokens`` and ``padded_tokens``.
A drain is token for token the same as serving each request alone.

**Multi-tenant serving**: constructed with an
:class:`~repro_torch.core.adapter_bank.AdapterBank`, requests carry a
``domain`` and one wave freely mixes domains; each row's bank slot id
rides the wave as per-row ``adapter_ids`` into the multi-LoRA kernels.
``bank.stacked`` is re-read at every prefill, refill and segment, so a
publish between drains (or between segments) is served by the very next
dispatch. The speculative, paged and mesh modes are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.device import resolve_device, unported
from repro_torch.core.telemetry import Histogram, Telemetry
from repro_torch.models import model as M
from repro_torch.models.transformer import groups_for


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _pow2floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray                 # (S,) int32 prompt
    max_new_tokens: int
    domain: Optional[str] = None       # multi-tenant: AdapterBank slot owner
    deadline_s: Optional[float] = None  # monotonic budget from submit time
    t_submit: float = 0.0              # time.perf_counter() at submit
    sla: Optional[str] = None          # service class label


@dataclasses.dataclass
class Slot:
    """One fixed batch slot; live fields track the resident request."""
    uid: int = -1
    prompt_len: int = 0
    target: int = 0                    # requested new tokens
    active: bool = False

    def assign(self, req: Request) -> None:
        self.uid, self.prompt_len = req.uid, len(req.tokens)
        self.target = req.max_new_tokens
        self.active = True

    def recycle(self) -> None:
        self.uid, self.prompt_len, self.target = -1, 0, 0
        self.active = False


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray                 # (max_new_tokens,) generated tokens
    latency_s: float                   # submit -> retirement (monotonic)
    wave: int                          # prefill wave that admitted the row
    timed_out: bool = False            # retired at its deadline
    queue_s: float = 0.0               # submit -> wave admission
    ttft_s: Optional[float] = None     # submit -> first token host-visible
    tok_s: float = 0.0                 # tokens / (admission -> retirement)


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    waves: int = 0                     # prefill/refill dispatches
    segments: int = 0                  # decode-segment dispatches
    tokens: int = 0                    # served (budgeted) tokens
    padded_tokens: int = 0             # wasted slot-steps
    timed_out: int = 0                 # requests retired at their deadline
    wall_s: float = 0.0
    ttft_hist: Optional[dict] = None       # time-to-first-token (s)
    queue_hist: Optional[dict] = None      # queue wait (s)
    tok_latency_hist: Optional[dict] = None  # per-token decode latency (s)
    sla_stats: Optional[dict] = None       # per service class

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def utilization(self) -> float:
        """Served fraction of executed decode slot-steps."""
        total = self.tokens + self.padded_tokens
        return self.tokens / total if total else 1.0


class DecodeEngine:
    """Packs queued requests into fixed slots and serves them ragged."""

    def __init__(self, cfg, *, slots: int = 8, greedy: bool = True,
                 seed: int = 0, bank=None, mesh=None, spec=None,
                 tel: Optional[Telemetry] = None, paged=None, device=None):
        for name, val, item in (
                ("spec=", spec, "slice 6, ssm family and speculative "
                                "decoding"),
                ("paged=", paged, "slice 5, paged engine"),
                ("mesh=", mesh, "later, multi-GPU sharding")):
            if val is not None:
                raise unported(f"DecodeEngine({name}...)", item)
        groups_for(cfg)                    # raises for unported families
        self.cfg = cfg
        self.slots = slots
        self.greedy = greedy
        self.bank = bank                   # Optional[AdapterBank]
        self.tel = tel
        self.device = resolve_device(device)
        self.slot_table = [Slot() for _ in range(slots)]
        self._queue: deque[Request] = deque()
        self._uid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # -- queue --------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 8,
               extras: Optional[dict] = None,
               domain: Optional[str] = None,
               deadline_s: Optional[float] = None,
               sla: Optional[str] = None) -> int:
        """Enqueue one request; returns its uid. ``deadline_s`` is a budget
        from now: a row still live past it retires mid-wave as a
        ``timed_out`` completion with its partial tokens. ``sla`` labels
        the request's service class (per-class histograms and misses in
        ``EngineStats.sla_stats``). ``domain`` names the request's adapter
        slot in the engine's AdapterBank. Malformed requests fail here with
        ``ValueError``, as in the reference."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError(
                f"submit: prompt must be a non-empty 1-D token row, got "
                f"shape {tokens.shape}")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"submit: max_new_tokens must be >= 1, got {max_new_tokens}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(
                f"submit: deadline_s must be >= 0, got {deadline_s}")
        if domain is not None:
            if self.bank is None:
                raise ValueError("submit(domain=...) requires an engine "
                                 "constructed with an AdapterBank")
            if domain not in self.bank.domains:
                raise ValueError(
                    f"domain {domain!r} has no adapter slot "
                    f"(known: {list(self.bank.domains)})")
        # all-or-none tenancy, enforced at the door (the offending request
        # is rejected, the queue is left intact): bank params served
        # without adapter_ids would fail deep inside the projections
        if self._queue and (domain is None) != (self._queue[0].domain is None):
            raise ValueError("all requests in a drain must carry a domain "
                             "or none (mixing tenant-addressed and "
                             "merged-param requests is ambiguous)")
        if extras is not None:
            raise unported("submit(extras=...)", "later, remaining families")
        uid = self._uid
        self._uid += 1
        self._queue.append(Request(uid, tokens, int(max_new_tokens), domain,
                                   deadline_s, time.perf_counter(), sla))
        self._telemetry().count("engine.submitted")
        return uid

    def _telemetry(self) -> Telemetry:
        return self.tel if self.tel is not None else telemetry.get()

    def pending(self) -> int:
        return len(self._queue)

    def _fill_slots(self) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots FIFO (no length bucketing).
        Returns [(slot_index, request)] for the rows to (re-)prefill."""
        packed: list[tuple[int, Request]] = []
        for i, slot in enumerate(self.slot_table):
            if slot.active or not self._queue:
                continue
            req = self._queue.popleft()
            slot.assign(req)
            packed.append((i, req))
        return packed

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _wave_params(self, params, tenant: bool):
        """Per-dispatch params: re-read the bank so publishes are fresh."""
        return params if not tenant else \
            {**params, "adapters": self.bank.stacked}

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def run(self, params) -> tuple[list[Completion], EngineStats]:
        """Drain the queue as one ragged continuous-batching wave.
        Returns (completions, stats)."""
        stats = EngineStats()
        out: list[Completion] = []
        if not self._queue:
            return out, stats
        tel = self._telemetry()
        h_ttft, h_queue, h_tok = Histogram(), Histogram(), Histogram()
        sla_acc: dict[str, dict] = {}
        t_all = time.perf_counter()
        # one cache capacity per drain keeps every refill shape-stable
        cap = _pow2ceil(max(len(r.tokens) + r.max_new_tokens
                            for r in self._queue))
        B = self.slots
        slot_req: list[Optional[Request]] = [None] * B
        slot_wave = [0] * B
        bufs: list[list[np.ndarray]] = [[] for _ in range(B)]
        remaining = np.zeros(B, np.int64)
        tok = caches = pos = None
        tenant = self._queue[0].domain is not None
        ids = None                         # (B,) adapter slot ids of the wave
        cur_dom: list[Optional[str]] = [None] * B
        t_admit = [0.0] * B
        t_first: list[Optional[float]] = [None] * B

        def retire(i: int, now: float, *, timed_out: bool = False) -> None:
            """Complete slot i's request: latency fields + trace span."""
            req = slot_req[i]
            toks_i = (np.concatenate(bufs[i]) if bufs[i]
                      else np.zeros(0, np.int32))
            ttft = t_first[i] - req.t_submit if t_first[i] is not None \
                else None
            decode_dt = now - t_admit[i]
            out.append(Completion(
                req.uid, toks_i, now - req.t_submit, slot_wave[i],
                timed_out=timed_out, queue_s=t_admit[i] - req.t_submit,
                ttft_s=ttft,
                tok_s=len(toks_i) / decode_dt if decode_dt > 0 else 0.0))
            stats.requests += 1
            if timed_out:
                stats.timed_out += 1
                tel.count("engine.timed_out")
            if ttft is not None:
                h_ttft.record(ttft)
                tel.observe("engine.ttft_s", ttft)
            if req.sla is not None:
                acc = sla_acc.setdefault(
                    req.sla, {"ttft": Histogram(), "queue": Histogram(),
                              "miss": 0, "n": 0})
                acc["n"] += 1
                acc["queue"].record(t_admit[i] - req.t_submit)
                if ttft is not None:
                    acc["ttft"].record(ttft)
                    tel.observe(f"engine.ttft_s.{req.sla}", ttft)
                if timed_out:
                    acc["miss"] += 1
                    tel.count(f"engine.deadline_miss.{req.sla}")
            tel.count("engine.retired")
            tel.record_span("engine.request", req.t_submit, now,
                            uid=req.uid, wave=slot_wave[i],
                            tokens=len(toks_i), domain=req.domain,
                            timed_out=timed_out)
            bufs[i] = []
            remaining[i] = 0
            slot_req[i] = None
            self.slot_table[i].recycle()

        drain = tel.span("engine.drain", slots=B, queued=len(self._queue))
        drain.__enter__()
        while self._queue or remaining.any():
            packed = self._fill_slots()
            if packed:
                stats.waves += 1
                t_adm = time.perf_counter()
                for i, req in packed:
                    slot_req[i], slot_wave[i] = req, stats.waves - 1
                    remaining[i] = req.max_new_tokens
                    cur_dom[i] = req.domain
                    t_admit[i], t_first[i] = t_adm, None
                    h_queue.record(t_adm - req.t_submit)
                    tel.observe("engine.queue_s", t_adm - req.t_submit)
                if tenant:
                    # full-wave ids for the segments, recomputed at every
                    # packing; a slot that never filled takes the first
                    # live row's domain (its tokens are discarded)
                    live = [i for i in range(B) if slot_req[i] is not None]
                    ids = self.bank.adapter_ids(
                        [cur_dom[i] if cur_dom[i] is not None
                         else cur_dom[live[0]] for i in range(B)])
                wp = self._wave_params(params, tenant)
                S_pad = _pow2ceil(max(len(req.tokens) for _, req in packed))
                if caches is None:
                    # initial wave prefill: all B slots (empty slots carry
                    # 1-token dummies and retire immediately)
                    prompts = np.zeros((B, S_pad), np.int32)
                    lens = np.ones(B, np.int32)
                    for i, req in packed:
                        prompts[i, :len(req.tokens)] = req.tokens
                        lens[i] = len(req.tokens)
                    with tel.span("engine.prefill", wave=stats.waves - 1,
                                  rows=len(packed), seq=S_pad):
                        tok, caches, pos = M.wave_prefill(
                            wp, self.cfg, cap,
                            {"tokens": self._tensor(prompts)},
                            self._tensor(lens), ids)
                else:
                    # in-wave refill: prefill only the admitted rows
                    # (pow2-padded row count) into their slots
                    Br = min(_pow2ceil(len(packed)), _pow2ceil(B))
                    prompts = np.zeros((Br, S_pad), np.int32)
                    lens = np.ones(Br, np.int32)
                    row_idx = np.full(Br, B, np.int32)   # pad rows: dropped
                    for r, (i, req) in enumerate(packed):
                        prompts[r, :len(req.tokens)] = req.tokens
                        lens[r] = len(req.tokens)
                        row_idx[r] = i
                    ids_rows = None
                    if tenant:             # pad rows take the first row's
                        rdom = [req.domain for _, req in packed]
                        rdom += [rdom[0]] * (Br - len(packed))
                        ids_rows = self.bank.adapter_ids(rdom)
                    with tel.span("engine.refill", wave=stats.waves - 1,
                                  rows=len(packed), seq=S_pad):
                        tok, caches, pos = M.refill(
                            wp, self.cfg, cap,
                            {"tokens": self._tensor(prompts)},
                            self._tensor(lens), row_idx, tok, caches, pos,
                            ids_rows)
            # deadline sweep: a live row past its budget retires here with
            # the tokens it has so far
            now = time.perf_counter()
            for i in range(B):
                req = slot_req[i]
                if req is None or req.deadline_s is None:
                    continue
                if now - req.t_submit >= req.deadline_s:
                    retire(i, now, timed_out=True)
            if not remaining.any():
                continue                       # re-pack freed slots (or exit)
            live_rem = remaining[remaining > 0]
            live_n = int((remaining > 0).sum())
            t_seg0 = time.perf_counter()
            seg = _pow2floor(int(live_rem.min() if self._queue
                                 else live_rem.max()))
            with tel.span("engine.segment", seg=seg, live=live_n):
                toks, tok, caches, pos, _ = M.segment(
                    self._wave_params(params, tenant), self.cfg, seg,
                    self.greedy, tok, caches, pos,
                    self._tensor(remaining.astype(np.int32)), self._gen, ids)
                toks = toks.cpu().numpy()      # the one sync: segment done
            counts = np.minimum(seg, remaining)
            executed = seg * B
            t_seg1 = time.perf_counter()
            seg_wall = t_seg1 - t_seg0
            stats.segments += 1
            served_now = 0
            for i in range(B):
                if remaining[i] <= 0:
                    continue
                served = int(counts[i])
                bufs[i].append(toks[i, :served])
                remaining[i] -= served
                served_now += served
                if served > 0:
                    h_tok.record(seg_wall / served, n=served)
                    tel.observe("engine.tok_latency_s", seg_wall / served,
                                n=served)
                    if t_first[i] is None:     # first token host-visible
                        t_first[i] = t_seg1
                if remaining[i] == 0:
                    retire(i, t_seg1)
            stats.tokens += served_now
            stats.padded_tokens += executed - served_now
            tel.observe("engine.segment_s", seg_wall)
        stats.wall_s = time.perf_counter() - t_all
        stats.ttft_hist = h_ttft.summary()
        stats.queue_hist = h_queue.summary()
        stats.tok_latency_hist = h_tok.summary()
        if sla_acc:
            stats.sla_stats = {
                cls: {"ttft_hist": a["ttft"].summary(),
                      "queue_hist": a["queue"].summary(),
                      "deadline_miss": a["miss"], "requests": a["n"]}
                for cls, a in sla_acc.items()}
        tel.count("engine.tokens", stats.tokens)
        tel.count("engine.padded_tokens", stats.padded_tokens)
        drain.set(requests=stats.requests, tokens=stats.tokens,
                  waves=stats.waves, segments=stats.segments)
        drain.__exit__(None, None, None)
        return out, stats

    def serve(self, params, prompts, *, gen: int,
              domains: Optional[list] = None
              ) -> tuple[np.ndarray, EngineStats]:
        """Serve an (N, S) prompt batch in one drain, row i with adapter
        slot ``domains[i]`` if given; returns ((N, gen) tokens in
        submission order, stats)."""
        prompts = np.asarray(prompts)
        if domains is not None and len(domains) != len(prompts):
            raise ValueError(f"domains ({len(domains)}) must name one "
                             f"adapter slot per prompt ({len(prompts)})")
        uids = [self.submit(p, gen,
                            domain=None if domains is None else domains[i])
                for i, p in enumerate(prompts)]
        comps, stats = self.run(params)
        by_uid = {c.uid: c.tokens for c in comps}
        return np.stack([by_uid[u] for u in uids]), stats
