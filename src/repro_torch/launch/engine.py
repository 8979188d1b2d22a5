"""Ragged continuous-batching decode engine, single- and multi-tenant,
plain or speculative (counterpart of ``repro/launch/engine.py``).

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
dispatch.

**Paged serving** (``paged=PagedSpec(...)``): the per-slot dense cache is
replaced by a device block pool and per-row block tables
(``models/attention.py``), kept by a host-side refcounted allocator
(``core/paged.py``). Admission is block-gated FIFO; with
``share_prefix`` a request whose prompt prefix is cached acquires the
shared blocks and prefills only its suffix. The pool and allocator persist
across drains, so a later drain's matching prompt revives freed blocks.

:meth:`DecodeEngine.serve_trace` admits a timed arrival trace as its
timestamps come due, paged or dense.

**Modality-conditioned requests** (the vlm and audio families) carry
their own extras row (``submit(..., extras={"vision_embeds": (n_vis,
d)})`` or ``{"frames": (n_frames, d)}``, no batch dim); every prefill
and refill stacks the admitted rows' extras, so each slot stays bound to
its own conditioning. Every request of one drain carries the same extras
keys, or none. Paged serving refuses both families, as the reference
does.

**Speculative serving** (``spec=SpecDecoder``, ``core/spec_decode.py``):
the drafter rides the same waves (its own prefill and refill beside the
target's), and each decode segment is a number of draft-verify chunks
(k proposals and one verify pass each), pow2-bucketed like plain segments.
Greedy only: exact-match acceptance is what keeps a speculative drain
token for token the plain one. A request submitted with
``speculative=False`` decodes plainly through the verify pass, so one
wave mixes both. Paged serving composes with plain decode only.

**Mesh serving** (``mesh=``, a ``DeviceMesh`` of (`data`, `model`)): every
rank runs the same host scheduler on the same submissions and seed; the
params are DTensors (``model.place_params``, a slot-sharded bank), each
dispatch runs under ``serving_rules`` (wave rows on `data`, heads and FF
on `model`), and the tokens each segment returns are whole on every rank,
so every rank returns every completion. Paged serving keeps its
allocator on the host, the same on every rank, and its pool on the mesh
(blocks on the batch axes, kv heads on `model`; ``models/attention.py``
writes and reads it); speculative serving replicates the drafter
(``SpecDecoder.place``) and runs its dispatches under ``drafter_rules``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.device import resolve_device
from repro_torch.core.paged import BlockAllocator, PagedSpec
from repro_torch.core.telemetry import Histogram, Telemetry
from repro_torch.models import model as M
from repro_torch.models.params import init_from_spec
from repro_torch.models.transformer import groups_for, paged_subs
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import (drafter_rules, serving_rules,
                                        use_rules)


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
    t_submit: float = 0.0              # time.perf_counter() at submit, or
                                       # the timed arrival's due time
    sla: Optional[str] = None          # service class label
    speculative: bool = True           # spec engine: draft for this row
    extras: Optional[dict] = None      # per-request modality rows (no batch dim)


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
    drafted: int = 0                   # drafter proposals (spec serving)
    accepted: int = 0                  # proposals the verify pass committed
    ttft_hist: Optional[dict] = None       # time-to-first-token (s)
    tok_latency_hist: Optional[dict] = None  # per-token decode latency (s)
    sla_stats: Optional[dict] = None       # per service class
    # paged serving (DecodeEngine(paged=PagedSpec(...))):
    pool_block_size: int = 0           # tokens per pool block (0 = dense)
    pool_peak_blocks: int = 0          # most blocks referenced at once
    pool_blocks_alloc: int = 0         # private blocks allocated this drain
    cache_tokens: int = 0              # prompt + budget tokens placed in new
                                       # blocks (a shared prefix counts once)
    prefix_hits: int = 0               # admissions that matched a cached prefix
    prefix_hit_tokens: int = 0         # prompt tokens served from shared blocks
    # the telemetry this drain's spans went to while it was on, else None
    tel: Optional[Telemetry] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @property
    def pool_occupancy(self) -> float:
        """Paged: useful tokens per allocated pool-block token."""
        denom = self.pool_blocks_alloc * self.pool_block_size
        return self.cache_tokens / denom if denom else 0.0

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Committed fraction of drafted tokens (speculative serving)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def utilization(self) -> float:
        """Served fraction of executed decode slot-steps."""
        total = self.tokens + self.padded_tokens
        return self.tokens / total if total else 1.0


class DecodeEngine:
    """Packs queued requests into fixed slots and serves them ragged."""

    def __init__(self, cfg, *, slots: int = 8, greedy: bool = True,
                 seed: int = 0, bank=None, mesh=None, spec=None,
                 tel: Optional[Telemetry] = None,
                 paged: Optional[PagedSpec] = None, device=None):
        if paged is not None and spec is not None:
            raise ValueError(
                "paged serving composes with plain decode only "
                "(speculative verify reads the dense slot layout)")
        if paged is not None and cfg.family in ("audio", "vlm"):
            raise ValueError(
                f"paged serving does not support the {cfg.family} family "
                "(modality prefixes address the dense slab)")
        self.mesh = mesh
        self.rules = serving_rules() if mesh is not None else None
        # speculative serving: greedy only (exact-match acceptance is what
        # keeps spec drains token for token the plain ones)
        if spec is not None:
            if not greedy:
                raise ValueError(
                    "speculative serving is greedy-only (sampled residual "
                    "acceptance is a recorded follow-up)")
            spec.validate_target(cfg)
            spec = spec.place(mesh)        # replicated under drafter_rules
        self.spec = spec
        self.cfg = cfg
        self.slots = slots
        self.greedy = greedy
        self.bank = bank                   # Optional[AdapterBank]
        self.tel = tel
        self.device = resolve_device(device)
        # paged serving: a device block pool + per-row tables, kept by a
        # host-side allocator; both persist across drains (a freed block
        # keeps its prefix hash on the LRU free list)
        self.paged = paged
        self._pool: Optional[dict] = None
        self._alloc: Optional[BlockAllocator] = None
        self._psubs: list[tuple[str, str]] = []
        self._slot_blocks: list[Optional[dict]] = [None] * slots
        self._arrivals: deque = deque()    # serve_trace timed admissions
        self._trace_t0 = 0.0
        if paged is not None:
            self._psubs = paged_subs(cfg)
            if paged.share_prefix:
                n_subs = sum(len(kinds) for _, kinds, _ in groups_for(cfg))
                if len(self._psubs) != n_subs or not self._psubs:
                    raise ValueError(
                        "share_prefix requires a fully paged stack (every "
                        "sub-layer full-window attention): suffix-only "
                        "prefill has no partial-stack path")
            self._alloc = BlockAllocator(paged.n_blocks, paged.block_size)
        self.slot_table = [Slot() for _ in range(slots)]
        self._queue: deque[Request] = deque()
        self._uid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # -- queue --------------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int = 8,
               extras: Optional[dict] = None,
               domain: Optional[str] = None,
               deadline_s: Optional[float] = None,
               speculative: bool = True,
               sla: Optional[str] = None,
               t_due: Optional[float] = None) -> int:
        """Enqueue one request; returns its uid. ``extras`` is one modality
        row per key (``{"vision_embeds": (n_vis, d)}`` or ``{"frames":
        (n_frames, d)}``, numpy or torch, no batch dim), bound to this
        request across wave packing. ``deadline_s`` is a budget
        from now: a row still live past it retires mid-wave as a
        ``timed_out`` completion with its partial tokens. ``sla`` labels
        the request's service class (per-class histograms and misses in
        ``EngineStats.sla_stats``). ``domain`` names the request's adapter
        slot in the engine's AdapterBank. ``speculative=False`` opts the
        row out of drafting on a spec engine (it decodes plainly through
        the verify pass; ignored on plain engines). ``t_due``
        (``time.perf_counter``, default now) is when the request was due:
        queue wait, time to first token, latency and the deadline count
        from it (``serve_trace`` passes each arrival's due time). Malformed
        requests fail here with ``ValueError``, as in the reference."""
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
        if self.paged is not None:
            need = -(-(tokens.size + int(max_new_tokens))
                     // self.paged.block_size)
            if need > self.paged.n_blocks:
                raise ValueError(
                    f"submit: request needs {need} pool blocks but the "
                    f"pool only has {self.paged.n_blocks}: it could never "
                    "be admitted")
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
        uid = self._uid
        self._uid += 1
        self._queue.append(Request(
            uid, tokens, int(max_new_tokens), domain, deadline_s,
            time.perf_counter() if t_due is None else t_due, sla,
            bool(speculative), extras))
        return uid

    def _telemetry(self) -> Telemetry:
        return self.tel if self.tel is not None else telemetry.get()

    def pending(self) -> int:
        return len(self._queue)

    def _fill_slots(self) -> list[tuple[int, Request]]:
        """Assign queued requests to free slots FIFO (no length bucketing).
        Returns [(slot_index, request)] for the rows to (re-)prefill.

        Paged admission is block-gated: the head request's blocks must all
        be reservable now, else packing stops head-of-line until a
        retirement frees blocks."""
        packed: list[tuple[int, Request]] = []
        for i, slot in enumerate(self.slot_table):
            if slot.active or not self._queue:
                continue
            if self.paged is not None:
                plan = self._plan_blocks(self._queue[0])
                if plan is None:
                    break                     # pool full: wait for a retire
                self._slot_blocks[i] = plan
            req = self._queue.popleft()
            slot.assign(req)
            packed.append((i, req))
        return packed

    def _plan_blocks(self, req: Request) -> Optional[dict]:
        """Reserve one request's pool blocks, or None if they do not fit.

        ``shared`` are prefix-cache hits (acquired, never written);
        ``owned`` are fresh private blocks for the prompt tail and the
        budget. The match is capped at (len - 1) // bs blocks so that every
        row keeps a private suffix token to produce its first logits."""
        ps, alloc = self.paged, self._alloc
        total = -(-(len(req.tokens) + req.max_new_tokens) // ps.block_size)
        shared: list[int] = []
        if ps.share_prefix:
            ids, _ = alloc.match_prefix(req.tokens)
            shared = ids[:min(len(ids), (len(req.tokens) - 1)
                              // ps.block_size)]
        need = total - len(shared)
        # reviving a dead (rc 0) shared block takes a free-list slot too
        revive = sum(1 for b in shared if alloc.refcount[b] == 0)
        if need + revive > alloc.free_blocks:
            return None
        for b in shared:
            alloc.acquire(b)
        owned = alloc.alloc(need) if need else []
        # a full-prefill row publishes its prompt blocks at plan time, so a
        # same-wave sibling already matches them (the sibling's suffix pass
        # runs after the prefill that fills them); hit rows stay private
        if ps.share_prefix and not shared:
            alloc.register(req.tokens, owned)
        return {"owned": owned, "shared": shared}

    def _ensure_pool(self) -> None:
        """Make the persistent device block pool (zeros) on first use: one
        (L, n_blocks, bs, Hkv, D) k/v pair per eligible sub-layer."""
        if self._pool is not None:
            return
        ps = self.paged
        spec = M.cache_spec(self.cfg, 1, ps.block_size,
                            paged=(ps.n_blocks, ps.block_size))
        gen = torch.Generator(device=self.device)
        self._pool = {}
        for g, s in self._psubs:
            sub = {"k": spec[g][s]["k"], "v": spec[g][s]["v"]}
            pool = init_from_spec(gen, sub, self.device)
            if self.mesh is not None:      # kv_blocks on (pod, data)
                pool = R.distribute_tree(pool, R.partition_specs(
                    sub, self.mesh, self.rules), self.mesh)
            self._pool.setdefault(g, {})[s] = pool

    def _admit_due(self) -> None:
        """serve_trace: submit every arrival whose timestamp has passed,
        stamped with its due time (a request that fell due during a
        segment counts its wait from then)."""
        while self._arrivals and \
                time.perf_counter() - self._trace_t0 >= self._arrivals[0][0]:
            t_s, tokens, gen, kw = self._arrivals.popleft()
            self.submit(tokens, gen, t_due=self._trace_t0 + t_s, **kw)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _check_extras(self) -> frozenset:
        """The drain's extras keys: every queued request carries the same
        keys, or none carries any."""
        keys = {k for r in self._queue if r.extras for k in r.extras}
        if keys and any(r.extras is None or set(r.extras) != keys
                        for r in self._queue):
            raise ValueError("all requests in a drain must carry the same "
                             f"extras keys ({sorted(keys)}) or none")
        return frozenset(keys)

    def _stack_extras(self, cur_extras: list, keys: frozenset,
                      live: list) -> dict:
        """Each slot's extras rows stacked per key, on the engine's device
        (an empty slot replicates the row of slot ``live[0]``)."""
        if not keys:
            return {}
        fallback = cur_extras[live[0]]
        rows = [e if e is not None else fallback for e in cur_extras]
        return {k: torch.stack([self._tensor(r[k]) for r in rows])
                for k in keys}

    def _drafting(self):
        """The drafter's dispatches run under ``drafter_rules`` on a mesh
        (the target's under ``serving_rules``)."""
        return use_rules(self.mesh, drafter_rules()) \
            if self.mesh is not None else contextlib.nullcontext()

    def _mark(self, tel: Telemetry):
        """A point on the device's stream at a span's edge, only while
        ``tel`` is on (None otherwise): a recorded CUDA event, or the host
        clock on a CPU device, whose ops run in the caller."""
        if not tel.enabled:
            return None
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @contextlib.contextmanager
    def _device_span(self, tel: Telemetry, timed: list, name: str, **args):
        """Span ``name`` whose device marks, while ``tel`` is on, go on
        ``timed`` for :meth:`_set_device_ms` (a prefill's or refill's
        ``device_ms``: stream time from its first launch to its last op's
        completion)."""
        with tel.span(name, **args) as sp:
            e0 = self._mark(tel)
            yield
            if e0 is not None:
                timed.append((sp, e0, self._mark(tel)))

    @staticmethod
    def _set_device_ms(timed: list) -> None:
        """Set ``device_ms`` on each (span, start, end) of ``timed``, whose
        marks the last fetch has passed, and empty it."""
        for sp, a, b in timed:
            sp.set(device_ms=(b - a) * 1e3 if isinstance(a, float)
                   else a.elapsed_time(b))
        timed.clear()

    def _wave_params(self, params, tenant: bool):
        """Per-dispatch params: re-read the bank so publishes are fresh."""
        return params if not tenant else \
            {**params, "adapters": self.bank.stacked}

    # -- serving ------------------------------------------------------------
    def run(self, params) -> tuple[list[Completion], EngineStats]:
        """Drain the queue as one ragged continuous-batching wave.
        Returns (completions, stats)."""
        # model-level spans (models/) record into the drain's telemetry
        with (use_rules(self.mesh, self.rules) if self.mesh is not None
              else contextlib.nullcontext()), \
                telemetry.using(self._telemetry()):
            return self._drain(params)

    # tracelint: hot
    @torch.no_grad()
    def _drain(self, params) -> tuple[list[Completion], EngineStats]:
        stats = EngineStats()
        out: list[Completion] = []
        if not self._queue and not self._arrivals:
            return out, stats
        tel = self._telemetry()
        if tel.enabled:
            stats.tel = tel
        h_ttft, h_tok = Histogram(), Histogram()
        # (span, start, end) of the prefills and refills whose device time
        # the next segment's fetch makes readable (telemetry on)
        timed: list = []
        sla_acc: dict[str, dict] = {}
        t_all = time.perf_counter()
        extras_keys = self._check_extras()
        # one cache capacity per drain keeps every refill shape-stable
        # (timed arrivals not yet submitted join this drain too)
        cap = _pow2ceil(max(
            [len(r.tokens) + r.max_new_tokens for r in self._queue]
            + [e[1].size + e[2] for e in self._arrivals]))
        bs_ = maxb = 0
        if self.paged is not None:
            bs_ = self.paged.block_size
            cap = max(cap, bs_)            # pow2 cap >= pow2 bs divides evenly
            maxb = cap // bs_
            self._ensure_pool()
            stats.pool_block_size = bs_
        B = self.slots
        slot_req: list[Optional[Request]] = [None] * B
        slot_wave = [0] * B
        bufs: list[list[np.ndarray]] = [[] for _ in range(B)]
        remaining = np.zeros(B, np.int64)
        tok = caches = pos = None
        dtok = dcaches = dpos = None       # the drafter's wave state
        spec_rows = np.ones(B, bool)       # per-slot speculative opt-in
        tenant = bool(self._queue) and self._queue[0].domain is not None
        ids = None                         # (B,) adapter slot ids of the wave
        cur_dom: list[Optional[str]] = [None] * B
        cur_extras: list[Optional[dict]] = [None] * B
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
            if self.paged is not None and self._slot_blocks[i] is not None:
                pb = self._slot_blocks[i]
                self._alloc.free(pb["owned"] + pb["shared"])
                self._slot_blocks[i] = None
                tel.gauge("engine.pool_blocks_used", self._alloc.used_blocks)
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
        while self._queue or remaining.any() or self._arrivals:
            self._admit_due()
            if not self._queue and not remaining.any():
                # arrival-driven drain with nothing live: sleep toward the
                # next arrival (capped, so a deadline sweep never starves)
                dt = self._trace_t0 + self._arrivals[0][0] \
                    - time.perf_counter()
                if dt > 0:
                    time.sleep(min(dt, 0.025))
                continue
            packed = self._fill_slots()
            if packed:
                stats.waves += 1
                # a drain admitted from a timed trace learns its tenancy
                # from its first packed wave
                tenant = packed[0][1].domain is not None
                t_adm = time.perf_counter()
                for i, req in packed:
                    slot_req[i], slot_wave[i] = req, stats.waves - 1
                    remaining[i] = req.max_new_tokens
                    cur_dom[i], cur_extras[i] = req.domain, req.extras
                    spec_rows[i] = req.speculative
                    t_admit[i], t_first[i] = t_adm, None
                    tel.observe("engine.queue_s", t_adm - req.t_submit)
                    if self.paged is not None:
                        nshared = len(self._slot_blocks[i]["shared"])
                        stats.pool_blocks_alloc += len(
                            self._slot_blocks[i]["owned"])
                        stats.cache_tokens += (len(req.tokens)
                                               + req.max_new_tokens
                                               - nshared * bs_)
                        if nshared:
                            stats.prefix_hits += 1
                            stats.prefix_hit_tokens += nshared * bs_
                            tel.count("engine.prefix_hits")
                if self.paged is not None:
                    stats.pool_peak_blocks = max(stats.pool_peak_blocks,
                                                 self._alloc.used_blocks)
                    tel.gauge("engine.pool_blocks_used",
                              self._alloc.used_blocks)
                live = [i for i in range(B) if slot_req[i] is not None]
                if tenant:
                    # full-wave ids for the segments, recomputed at every
                    # packing; a slot that never filled takes the first
                    # live row's domain (its tokens are discarded)
                    ids = self.bank.adapter_ids(
                        [cur_dom[i] if cur_dom[i] is not None
                         else cur_dom[live[0]] for i in range(B)])
                wp = self._wave_params(params, tenant)
                S_pad = _pow2ceil(max(len(req.tokens) for _, req in packed))
                if self.paged is not None:
                    tok, caches, pos = self._paged_admit(
                        wp, packed, tenant, ids, tok, caches, pos, S_pad,
                        maxb, stats.waves - 1, tel, timed)
                elif caches is None:
                    # initial wave prefill: all B slots (empty slots carry
                    # 1-token dummies and retire immediately, with a live
                    # slot's extras)
                    prompts = np.zeros((B, S_pad), np.int32)
                    lens = np.ones(B, np.int32)
                    for i, req in packed:
                        prompts[i, :len(req.tokens)] = req.tokens
                        lens[i] = len(req.tokens)
                    with self._device_span(tel, timed, "engine.prefill",
                                           wave=stats.waves - 1,
                                           rows=len(packed), seq=S_pad):
                        tokens = self._tensor(prompts)
                        batch = {"tokens": tokens, **self._stack_extras(
                            cur_extras, extras_keys, live)}
                        tok, caches, pos = M.wave_prefill(
                            wp, self.cfg, cap, batch, self._tensor(lens),
                            ids)
                        if self.spec is not None:
                            # the drafter rides the same wave: its own
                            # prefill builds its state per row (its next
                            # token is discarded: a chunk's carry is always
                            # the target's committed token)
                            with self._drafting():
                                dtok, dcaches, dpos = M.wave_prefill(
                                    self.spec.params, self.spec.cfg, cap,
                                    {"tokens": tokens}, self._tensor(lens))
                else:
                    # in-wave refill: prefill only the admitted rows
                    # (pow2-padded row count) into their slots
                    prompts, lens, row_idx, ids_rows = self._refill_rows(
                        packed, S_pad, tenant)
                    with self._device_span(tel, timed, "engine.refill",
                                           wave=stats.waves - 1,
                                           rows=len(packed), seq=S_pad):
                        tokens = self._tensor(prompts)
                        batch = {"tokens": tokens, **self._refill_extras(
                            packed, len(row_idx), extras_keys)}
                        tok, caches, pos = M.refill(
                            wp, self.cfg, cap, batch, self._tensor(lens),
                            row_idx, tok, caches, pos, ids_rows)
                        if self.spec is not None:
                            with self._drafting():
                                dtok, dcaches, dpos = M.refill(
                                    self.spec.params, self.spec.cfg, cap,
                                    {"tokens": tokens}, self._tensor(lens),
                                    row_idx, dtok, dcaches, dpos)
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
            if self.spec is not None:
                # speculative segment: `chunks` draft-verify chunks, each
                # committing 1..k+1 tokens per row; the chunk count is the
                # pow2 floor of the budget in chunk units (one committed
                # token per chunk at worst keeps every chunk useful)
                Tc = self.spec.k + 1
                budget = int(live_rem.min() if self._queue
                             else live_rem.max())
                chunks = max(1, _pow2floor(max(1, budget // Tc)))
                with tel.span("engine.segment", chunks=chunks,
                              k=self.spec.k, live=live_n,
                              speculative=True) as ssp:
                    (toks, counts, dr, ac, tok, caches, dcaches, pos,
                     _) = M.spec_segment(
                        self._wave_params(params, tenant), self.spec.params,
                        self.cfg, self.spec.cfg, chunks, self.spec.k, tok,
                        caches, dcaches, pos,
                        self._tensor(remaining.astype(np.int32)),
                        self._tensor(spec_rows), ids)
                    toks = toks.cpu().numpy()  # tracelint: ignore[R2] the one sync: segment done
                    counts = counts.cpu().numpy()  # tracelint: ignore[R2] same fetch, already synced
                    dr, ac = int(dr), int(ac)  # tracelint: ignore[R2] already synced
                    ssp.set(drafted=dr, accepted=ac)
                if timed:
                    self._set_device_ms(timed)
                stats.drafted += dr
                stats.accepted += ac
                executed = chunks * Tc * B     # verify slot-steps run
            else:
                seg = _pow2floor(int(live_rem.min() if self._queue
                                     else live_rem.max()))
                with tel.span("engine.segment", seg=seg, live=live_n,
                              speculative=False):
                    toks, tok, caches, pos, _ = M.segment(
                        self._wave_params(params, tenant), self.cfg, seg,
                        self.greedy, tok, caches, pos,
                        self._tensor(remaining.astype(np.int32)), self._gen,
                        ids)
                    toks = toks.cpu().numpy()  # tracelint: ignore[R2] the one sync: segment done
                if timed:
                    self._set_device_ms(timed)
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

    def _refill_rows(self, rows: list, S_pad: int, tenant: bool):
        """Host arrays of an in-wave refill batch: prompts, lengths and the
        wave slot of each row, padded to a power-of-two row count (a pad
        row's slot index is the wave width and it lands nowhere), and the
        rows' adapter ids (pad rows take the first row's domain)."""
        B = self.slots
        Br = min(_pow2ceil(len(rows)), _pow2ceil(B))
        prompts = np.zeros((Br, S_pad), np.int32)
        lens = np.ones(Br, np.int32)
        row_idx = np.full(Br, B, np.int32)
        for r, (i, req) in enumerate(rows):
            prompts[r, :len(req.tokens)] = req.tokens
            lens[r] = len(req.tokens)
            row_idx[r] = i
        ids_rows = None
        if tenant:
            rdom = [req.domain for _, req in rows]
            ids_rows = self.bank.adapter_ids(
                rdom + [rdom[0]] * (Br - len(rows)))
        return prompts, lens, row_idx, ids_rows

    def _refill_extras(self, rows: list, Br: int, keys: frozenset) -> dict:
        """The extras of an in-wave refill batch of ``Br`` rows: the
        admitted rows' own, pad rows replicating the first."""
        rex = [req.extras for _, req in rows]
        return self._stack_extras(rex + [rex[0]] * (Br - len(rows)), keys,
                                  [0])

    def _table_row(self, i: int, maxb: int) -> np.ndarray:
        """Slot i's block table: shared blocks, then owned ones, then the
        ``n_blocks`` sentinel."""
        pb = self._slot_blocks[i]
        row = np.full(maxb, self.paged.n_blocks, np.int32)
        ids_b = pb["shared"] + pb["owned"]
        row[:len(ids_b)] = ids_b
        return row

    def _paged_admit(self, wp, packed, tenant, ids, tok, caches, pos,
                     S_pad, maxb, wave, tel, timed):
        """Admit a packed wave into the paged cache: full-prefill rows go
        through a dense prefill whose K/V commit into the pool (the initial
        wave prefill, or an in-wave refill); prefix-hit rows skip it and
        run only their suffix (:func:`model.paged_suffix`), so shared
        blocks are never prefilled or written again. The prefill's or
        refill's span and its device marks go on ``timed``."""
        B, bs_, nb_ = self.slots, self.paged.block_size, self.paged.n_blocks
        full_p = [(i, r) for i, r in packed
                  if not self._slot_blocks[i]["shared"]]
        hit_p = [(i, r) for i, r in packed if self._slot_blocks[i]["shared"]]
        if caches is None:
            # all B slots; empty and hit slots carry 1-token dummies with
            # all-sentinel tables (they commit nothing)
            prompts = np.zeros((B, S_pad), np.int32)
            lens = np.ones(B, np.int32)
            tables = np.full((B, maxb), nb_, np.int32)
            for i, req in full_p:
                prompts[i, :len(req.tokens)] = req.tokens
                lens[i] = len(req.tokens)
                tables[i] = self._table_row(i, maxb)
            with self._device_span(tel, timed, "engine.prefill", wave=wave,
                                   rows=len(full_p), seq=S_pad, paged=True):
                tok, caches, pos = M.paged_wave_prefill(
                    wp, self.cfg, {"tokens": self._tensor(prompts)},
                    self._tensor(lens), self._tensor(tables), self._pool,
                    ids)
        elif full_p:
            prompts, lens, row_idx, ids_rows = self._refill_rows(
                full_p, S_pad, tenant)
            tables = np.full((len(row_idx), maxb), nb_, np.int32)
            for r, (i, _) in enumerate(full_p):
                tables[r] = self._table_row(i, maxb)
            with self._device_span(tel, timed, "engine.refill", wave=wave,
                                   rows=len(full_p), seq=S_pad, paged=True):
                tok, caches, pos = M.paged_refill(
                    wp, self.cfg, {"tokens": self._tensor(prompts)},
                    self._tensor(lens), row_idx, self._tensor(tables), tok,
                    caches, pos, ids_rows)
        if hit_p:
            Br = min(_pow2ceil(len(hit_p)), _pow2ceil(B))
            W = _pow2ceil(max(len(r.tokens)
                              - len(self._slot_blocks[i]["shared"]) * bs_
                              for i, r in hit_p))
            suf = np.zeros((Br, W), np.int32)
            slens = np.zeros(Br, np.int32)
            starts = np.zeros(Br, np.int32)
            row_idx = np.full(Br, B, np.int32)
            tables = np.full((Br, maxb), nb_, np.int32)
            for r, (i, req) in enumerate(hit_p):
                st = len(self._slot_blocks[i]["shared"]) * bs_
                tail = req.tokens[st:]
                suf[r, :len(tail)] = tail
                slens[r], starts[r] = len(tail), st
                row_idx[r] = i
                tables[r] = self._table_row(i, maxb)
            ids_rows = None
            if tenant:
                rdom = [req.domain for _, req in hit_p]
                ids_rows = self.bank.adapter_ids(
                    rdom + [rdom[0]] * (Br - len(hit_p)))
            with tel.span("engine.suffix", wave=wave, rows=len(hit_p),
                          seq=W):
                tok, caches, pos = M.paged_suffix(
                    wp, self.cfg, self._tensor(suf), self._tensor(slens),
                    self._tensor(starts), row_idx, self._tensor(tables),
                    tok, caches, pos, ids_rows)
        return tok, caches, pos

    def serve(self, params, prompts, *, gen: int,
              extra_batch: Optional[dict] = None,
              domains: Optional[list] = None
              ) -> tuple[np.ndarray, EngineStats]:
        """Serve an (N, S) prompt batch in one drain, row i with its
        ``extra_batch`` row (leading dim N) if given and adapter slot
        ``domains[i]`` if given; returns ((N, gen) tokens in submission
        order, stats)."""
        prompts = np.asarray(prompts)
        if domains is not None and len(domains) != len(prompts):
            raise ValueError(f"domains ({len(domains)}) must name one "
                             f"adapter slot per prompt ({len(prompts)})")
        for k, v in (extra_batch or {}).items():
            shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
            n = shape[0] if shape else 0
            if n != len(prompts):
                raise ValueError(
                    f"extra_batch[{k!r}] leading dim ({n}) must carry one "
                    f"row per prompt ({len(prompts)})")
        uids = [self.submit(p, gen,
                            extras=None if extra_batch is None else
                            {k: v[i] for k, v in extra_batch.items()},
                            domain=None if domains is None else domains[i])
                for i, p in enumerate(prompts)]
        comps, stats = self.run(params)
        by_uid = {c.uid: c.tokens for c in comps}
        return np.stack([by_uid[u] for u in uids]), stats

    def serve_trace(self, params, trace
                    ) -> tuple[list[Completion], EngineStats]:
        """Serve a timed arrival trace with arrival-driven admission.

        ``trace`` holds ``(t_s, tokens, gen)`` or ``(t_s, tokens, gen,
        submit_kwargs)`` arrivals, ``t_s`` the offset in seconds from the
        drain's start. A request is submitted only when its timestamp comes
        due inside the running drain, so queue wait and TTFT measure the
        engine under the offered load (and, paged, a burst beyond the
        pool's capacity queues head-of-line until blocks free). Returns
        (completions, stats) like :meth:`run`."""
        ev = sorted(((float(e[0]), np.asarray(e[1], np.int32), int(e[2]),
                      dict(e[3]) if len(e) > 3 else {}) for e in trace),
                    key=lambda e: e[0])
        self._arrivals = deque(ev)
        self._trace_t0 = time.perf_counter()
        try:
            return self.run(params)
        finally:
            self._arrivals = deque()
