"""Integrated fine-tuning AND inference runtime (the paper's thesis, §IV;
counterpart of ``repro/core/integrated.py``).

One edge system alternates between fine-tuning rounds (upgrading a domain's
edge model) and inference rounds (serving requests) under a profit policy
(``core/scheduler.py``). The runtime:

- owns the domain edge models, one shared frozen backbone plus per-domain
  adapters (paper Fig 3), kept on the device in ONE multi-tenant
  :class:`~repro_torch.core.adapter_bank.AdapterBank`;
- on ``produce``: serves the round's requests, mixed domains included,
  through the decode engine in one drain against the bank (per-row
  ``adapter_ids`` into the multi-LoRA kernels), paged when constructed with
  ``paged=PagedSpec(...)``, and books profit in proportion to the measured
  accuracy of each row's own domain head;
- on ``upgrade``: runs an HFSL fine-tuning round for the domain
  (``core/hfsl.py``) and publishes the consensus adapters into the bank in
  place, so the next produce round serves them;
- keeps the paper's metric ledger (latency, compute, comm, energy) in
  :class:`~repro_torch.core.comm.RoundCost`.

With ``spec_k`` the produce rounds serve speculatively: a tiny recurrent
drafter (``core/spec_decode.py``, seeded from ``seed + 997``) proposes
``spec_k`` tokens per verify pass, and each produce round books the
drafted and accepted tokens in its RoundCost. It excludes ``paged``, as in
the reference.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed.

With a (`data`, `model`) ``mesh`` both sides of the loop are laid out on
it once, at construction: the backbone and every domain's HFSL state per
``hfsl_round_rules`` (cluster dims on `data`), one cluster-sharded batch
bank per domain, a slot-sharded adapter bank and a mesh engine; the
upgrade round is ``make_hfsl_round(mesh=...)`` and classify runs under
``serving_rules``. Every rank constructs the runtime alike and takes the
same actions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import hfsl, telemetry
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.comm import CostModel, RoundCost
from repro_torch.core.device import resolve_device
from repro_torch.core.faults import FaultPlan
from repro_torch.core.scheduler import SchedulerEnv, mlcp_policy
from repro_torch.core.spec_decode import SpecDecoder
from repro_torch.data.noniid import partition_by_classes
from repro_torch.data.pipeline import BatchBank
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M
from repro_torch.optim.optimizers import adamw
from repro_torch.models.params import tree_map
from repro_torch.sharding.dtensor import whole
from repro_torch.sharding import rules as R


@dataclasses.dataclass
class DomainState:
    name: str
    adapters_c: dict                   # per-cluster replicas (HFSL state)
    opt_state: dict
    # HFSL step counter, kept across upgrade rounds so that the sync_every
    # FedAvg phase continues instead of restarting each round
    step: Any = None                   # int32 scalar tensor
    level: int = 0                     # fine-tuning rounds applied
    accuracy: float = 0.0


@dataclasses.dataclass
class RoundRecord:
    round: int
    action: str                        # 'produce' | 'upgrade'
    domain: str
    profit: float
    accuracy: float
    cumulative: float
    cost: RoundCost


class IntegratedRuntime:
    """Executes fine-tune-or-infer rounds against real edge models."""

    def __init__(self, cfg, tasks: dict, *, n_clusters: int = 2,
                 steps_per_upgrade: int = 20, batch: int = 16,
                 sync_every: int = 5, serve_batch: int = 64,
                 serve_gen: int = 4, serve_slots: int = 16, lr: float = 5e-3,
                 profit_scale: float = 100.0, upgrade_cost: float = 50.0,
                 cost_model: Optional[CostModel] = None, seed: int = 0,
                 mesh=None, faults: Optional[FaultPlan] = None,
                 deadline_s: Optional[float] = None,
                 spec_k: Optional[int] = None, spec_d_model: int = 64,
                 spec_layers: int = 2,
                 tel: Optional[telemetry.Telemetry] = None,
                 paged=None, device=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tasks = tasks                       # domain -> ClassificationTask
        self.n_clusters = n_clusters
        self.steps = steps_per_upgrade
        self.sync_every = sync_every
        self.profit_scale = profit_scale
        self.upgrade_cost = upgrade_cost
        self.cm = cost_model or CostModel()
        self.serve_batch = serve_batch
        self.serve_gen = serve_gen
        # an active FaultPlan drives per-round participation and gradient
        # corruption through the HFSL round; deadline_s bounds every served
        # request's wall time
        self.faults = faults
        self.deadline_s = deadline_s
        self.tel = tel
        self._fault_round = 0                    # upgrade-round schedule index
        self._record_base = 0                    # rounds of restored runs
        self.publish_rejects = 0                 # validated publishes refused
        params = M.init(cfg, seed, device=self.device)
        self.backbone = params["backbone"]       # shared frozen FM
        self.opt = adamw(lr)
        self.batch = batch
        round_rules = state_spec = state_sh = None
        if mesh is not None:
            # one spec tree places the state here and is the round's
            # state_spec, so the two agree by construction
            round_rules = R.hfsl_round_rules(cfg.family)
            state_spec = hfsl.hfsl_state_spec(cfg, n_clusters, self.opt,
                                              M.model_spec)
            state_sh = R.partition_specs(state_spec, mesh, round_rules)
            self.backbone = R.distribute_tree(self.backbone,
                                              state_sh["backbone"], mesh)
        self._state_sh = state_sh                # restore() re-places here
        self.domains: dict[str, DomainState] = {}
        self._banks: dict[str, BatchBank] = {}
        for i, name in enumerate(tasks):
            # every domain starts from the same adapters (the reference
            # hands one init to every domain too)
            state = hfsl.init_hfsl_state(seed + i, cfg, n_clusters, self.opt,
                                         lambda c, s, device=None: params)
            if state_sh is not None:             # cluster replicas on `data`
                state = {**state, **self._place(state)}
            data = tasks[name].dataset(200 * n_clusters, seed=seed + 11 + i)
            parts = partition_by_classes(data["label"], n_clusters,
                                         cfg.peft.head_dim_out,
                                         seed=seed + i)
            # one epoch of per-cluster batches lives on the device for the
            # whole runtime; every upgrade round gathers from it
            self._banks[name] = BatchBank.pack(data, parts, batch,
                                               seed=seed + i, mesh=mesh,
                                               rules=round_rules,
                                               device=self.device)
            self.domains[name] = DomainState(
                name, state["adapters_c"], state["opt"], state["step"])
        # one call per fine-tuning round: steps_per_upgrade HFSL steps with
        # FedAvg inside; the domain's state tensors are updated in place
        self._round = hfsl.make_hfsl_round(
            cfg, self.opt, M.classify_loss, steps=self.steps,
            sync_every=self.sync_every, donate=True, mesh=mesh,
            rules=round_rules, state_spec=state_spec)
        # one multi-tenant bank for every domain's serving adapters
        self.bank = AdapterBank.create(
            {n: self._consensus_adapters(n) for n in self.domains},
            mesh=mesh)
        # speculative produce rounds: a tiny recurrent drafter proposes
        # spec_k tokens per verify pass (the paper's small edge model
        # assisting the large one); DecodeEngine refuses it with paged
        self.spec = None
        if spec_k is not None:
            self.spec = SpecDecoder.init(
                cfg, seed + 997, device=self.device, k=spec_k,
                d_model=spec_d_model, n_layers=spec_layers)
        self.engine = DecodeEngine(cfg, slots=min(serve_slots, serve_batch),
                                   seed=seed, bank=self.bank, tel=tel,
                                   paged=paged, spec=self.spec,
                                   mesh=mesh, device=self.device)
        self.records: list[RoundRecord] = []
        self._eval_cache: dict[str, dict] = {
            n: tasks[n].dataset(150, seed=seed + 91 + i)
            for i, n in enumerate(tasks)}
        for n in self.domains:
            self.domains[n].accuracy = self._measure(n)

    # -- internals ---------------------------------------------------------
    def _telemetry(self) -> telemetry.Telemetry:
        return self.tel if self.tel is not None else telemetry.get()

    def _place(self, state: dict) -> dict:
        """An HFSL state's train leaves laid out on the round's mesh."""
        return {k: R.distribute_tree(state[k], self._state_sh[k], self.mesh)
                for k in ("adapters_c", "opt", "step")}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _consensus_adapters(self, domain: str) -> dict:
        """Edge view after FedAvg: cluster-mean adapters (what serves)."""
        return hfsl.consensus_params({
            "backbone": self.backbone,
            "adapters_c": self.domains[domain].adapters_c})["adapters"]

    @torch.no_grad()
    def _classify(self, params: dict, tokens: np.ndarray,
                  ids: torch.Tensor) -> np.ndarray:
        """Argmax predictions of the bank's multi-tenant classify path
        (under ``serving_rules`` on a mesh)."""
        with (R.use_rules(self.mesh, R.serving_rules())
              if self.mesh is not None else contextlib.nullcontext()):
            logits = M.classify(params, {"tokens": torch.as_tensor(
                tokens, device=self.device)}, self.cfg, adapter_ids=ids)
        return whole(logits).argmax(-1).cpu().numpy()

    def _measure(self, domain: str) -> float:
        """Eval accuracy through the bank's multi-tenant classify path
        (every row addresses one slot: the kernels of mixed waves)."""
        data = self._eval_cache[domain]
        ids = torch.full((data["label"].shape[0],), self.bank.slot(domain),
                         dtype=torch.int32, device=self.device)
        pred = self._classify(self.bank.serving_params(self.backbone),
                              data["tokens"], ids)
        return float(np.mean(pred == np.asarray(data["label"])))

    # -- the two GAI services ----------------------------------------------
    def upgrade(self, domain: str) -> tuple[float, RoundCost]:
        """One HFSL fine-tuning round for ``domain`` (the paper's upgrade):
        steps_per_upgrade steps over the domain's device-resident batch
        bank, the step counter carried across rounds (comm is booked per
        FedAvg actually fired), then the consensus adapters are published
        into the serving bank. The RoundCost books the examples consumed
        and the round's wall time, so ``ex_per_s`` is the fine-tuning twin
        of produce()'s ``tok_per_s``."""
        tel = self._telemetry()
        d = self.domains[domain]
        bank = self._banks[domain]
        state = {"backbone": self.backbone, "adapters_c": d.adapters_c,
                 "opt": d.opt_state, "step": d.step}
        step0 = int(whole(state["step"]))
        fr, self._fault_round = self._fault_round, self._fault_round + 1
        chaos = self.faults is not None and self.faults.active
        part_n, dropped_n = self.n_clusters, 0
        with tel.span("integrated.upgrade", domain=domain,
                      steps=self.steps) as usp:
            t0 = time.perf_counter()
            if chaos:
                # seeded per-round schedules: which clusters take part and
                # which get their updates NaN-poisoned
                mask_np, _, _ = self.faults.participation(fr, self.n_clusters)
                corrupt_np = self.faults.corrupt_mask(fr, self.n_clusters)
                part_n = int(mask_np.sum())
                dropped_n = self.n_clusters - part_n
                state, ms = self._round(state, bank.arrays,
                                        bank.advance(self.steps),
                                        mask=mask_np.astype(np.float32),
                                        corrupt=corrupt_np)
            else:
                state, ms = self._round(state, bank.arrays,
                                        bank.advance(self.steps))
            self._sync()
            dt = time.perf_counter() - t0
            skipped_n = int(ms["skipped"].sum()) if "skipped" in ms else 0
            d.adapters_c, d.opt_state, d.step = \
                state["adapters_c"], state["opt"], state["step"]
            d.level += 1
            try:
                self.bank.publish(domain, self._consensus_adapters(domain))
            except ValueError:
                # a poisoned consensus never reaches live traffic: the bank
                # keeps serving the current (validated) version
                self.publish_rejects += 1
            d.accuracy = self._measure(domain)
            examples = self.steps * part_n * self.batch
            seq = bank.arrays["tokens"].shape[-1]
            flops = 6.0 * self.cfg.active_param_count() * examples * seq
            n_syncs = (step0 + self.steps) // self.sync_every \
                - step0 // self.sync_every
            comm = hfsl.sync_bytes(d.adapters_c) * n_syncs
            if chaos:                  # only survivors exchange sync bytes
                comm = int(comm * part_n / self.n_clusters)
            cost = RoundCost(dt, flops, self.cm.cs.energy(comm), comm, 0,
                             examples=examples, dropped_clusters=dropped_n,
                             skipped_updates=skipped_n)
            usp.set(latency_s=cost.latency_s, examples=cost.examples,
                    comm_bytes=cost.comm_bytes, ex_per_s=cost.ex_per_s,
                    dropped_clusters=dropped_n, skipped_updates=skipped_n,
                    accuracy=d.accuracy)
        tel.count("integrated.upgrades")
        tel.count("integrated.examples", examples)
        tel.observe("integrated.upgrade_s", dt)
        return -self.upgrade_cost, cost

    def produce(self, domain) -> tuple[float, RoundCost]:
        """Serve one round of inference requests.

        ``domain`` is one domain name or a sequence (mixed demand): the
        round's ``serve_batch`` requests split across the demanded domains
        and drain through the engine in one call against the bank. Profit
        is booked from each row's own domain head through the same
        multi-tenant classify path. ``cost.tok_per_s`` is the round's
        decode throughput; compute is booked on executed decode steps
        (served + padded slot-steps)."""
        tel = self._telemetry()
        domains = [domain] if isinstance(domain, str) else list(domain)
        base, rem = divmod(self.serve_batch, len(domains))
        rows: list[tuple[str, np.ndarray, int]] = []   # (domain, tokens, label)
        for i, d in enumerate(domains):
            cnt = base + (1 if i < rem else 0)
            if cnt == 0:
                continue
            data = self.tasks[d].dataset(
                cnt, seed=self._record_base + len(self.records) + 123 + i)
            rows += [(d, np.asarray(data["tokens"][j]),
                      int(data["label"][j])) for j in range(cnt)]
        params = self.bank.serving_params(self.backbone)
        with tel.span("integrated.produce", domains=",".join(domains),
                      requests=len(rows)) as psp:
            t0 = time.perf_counter()
            for d, toks, _ in rows:                    # one drain, mixed waves
                self.engine.submit(toks, self.serve_gen, domain=d,
                                   deadline_s=self.deadline_s)
            _, stats = self.engine.run(params)
            # accuracy through the bank: rows grouped by prompt length,
            # each scored by its own domain's head
            correct = 0
            by_len: dict[int, list[int]] = {}
            for j, (_, toks, _) in enumerate(rows):
                by_len.setdefault(len(toks), []).append(j)
            for idxs in by_len.values():
                pred = self._classify(
                    params, np.stack([rows[j][1] for j in idxs]),
                    self.bank.adapter_ids([rows[j][0] for j in idxs]))
                correct += int(np.sum(pred == np.asarray(
                    [rows[j][2] for j in idxs])))
            acc = correct / max(len(rows), 1)
            nbytes = self.serve_batch * (self.cfg.peft.head_dim_out * 4
                                         + self.serve_gen * 4)
            executed = stats.tokens + stats.padded_tokens
            flops = 2.0 * self.cfg.active_param_count() * executed
            cost = RoundCost(time.perf_counter() - t0, flops,
                             self.cm.d2d.energy(nbytes),
                             nbytes, 0, tokens=stats.tokens,
                             padded_tokens=stats.padded_tokens,
                             timed_out=stats.timed_out,
                             drafted_tokens=stats.drafted,
                             accepted_tokens=stats.accepted)
            psp.set(latency_s=cost.latency_s, tokens=cost.tokens,
                    padded_tokens=cost.padded_tokens,
                    tok_per_s=cost.tok_per_s, utilization=cost.utilization,
                    timed_out=cost.timed_out, accuracy=acc)
        tel.count("integrated.produces")
        tel.observe("integrated.produce_s", cost.latency_s)
        return self.profit_scale * acc, cost

    # -- scheduling ----------------------------------------------------------
    def run(self, demand: Sequence[str],
            policy: Optional[Callable[[int, tuple], int]] = None
            ) -> list[RoundRecord]:
        """Execute a demand sequence under a policy (default: MLCP DP on the
        measured-accuracy value model)."""
        names = list(self.domains)
        didx = {n: i for i, n in enumerate(names)}
        if policy is None:
            # value model for the DP: expected profit at level l
            base = {n: self.domains[n].accuracy for n in names}
            lift = 0.25                       # typical per-round gain
            values = tuple(
                int(self.profit_scale * min(1.0, np.mean(list(base.values()))
                                            + lift * l)) for l in range(3))
            env = SchedulerEnv(demand=tuple(didx[d] for d in demand),
                               values=values,
                               upgrade_cost=int(self.upgrade_cost),
                               n_devices=len(names))
            policy = mlcp_policy(env)

        cum = 0.0
        levels = tuple(0 for _ in names)
        for r, dom in enumerate(demand):
            a = policy(r, levels)
            if a == len(names):
                profit, cost = self.produce(dom)
                action, target = "produce", dom
            else:
                target = names[a]
                profit, cost = self.upgrade(target)
                levels = tuple(min(l + 1, 2) if i == a else l
                               for i, l in enumerate(levels))
                action = "upgrade"
            cum += profit
            self.records.append(RoundRecord(
                r + 1, action, target, profit,
                self.domains[target].accuracy, cum, cost))
        return self.records

    # -- crash-safe persistence ---------------------------------------------
    def _ckpt_tree(self) -> dict:
        """The resumable state as one tree: per-domain HFSL state (cluster
        adapters, optimizer, step counter), batch-bank cursors, bank
        versions and round counters. The backbone and engine come from the
        config and seed at construction and are not stored."""
        def i32(v):
            return torch.tensor(v, dtype=torch.int32)

        def whole_tree(tree):            # a mesh state, whole on every rank
            return tree_map(whole, tree)

        doms = {}
        for n, d in self.domains.items():
            doms[n] = {
                "adapters_c": whole_tree(d.adapters_c),
                "opt": whole_tree(d.opt_state),
                "step": whole(d.step),
                "level": i32(d.level),
                "accuracy": torch.tensor(d.accuracy, dtype=torch.float32),
                "bank_offset": i32(self._banks[n].offset),
                "bank_version": i32(self.versions_of(n)),
            }
        return {"domains": doms,
                "rounds": i32(self._record_base + len(self.records)),
                "fault_round": i32(self._fault_round)}

    def versions_of(self, domain: str) -> int:
        return self.bank.versions[domain]

    def save(self, path: str) -> int:
        """Atomically checkpoint the runtime (checkpoint/io.py: a temp file
        then ``os.replace``). Returns bytes written."""
        return ckpt_io.save(path, self._ckpt_tree())

    def restore(self, path: str) -> None:
        """Resume from a :meth:`save` checkpoint step for step: HFSL step
        counters, batch-bank cursors, bank versions and round counters
        continue where the saved run stopped. The runtime must be built
        with the same config and seed (the backbone is not stored)."""
        tree = ckpt_io.load(path, like=self._ckpt_tree())
        for n, saved in tree["domains"].items():
            d = self.domains[n]
            train = {"adapters_c": saved["adapters_c"], "opt": saved["opt"],
                     "step": saved["step"]}
            if self._state_sh is not None:       # back onto the round's mesh
                train = self._place(train)
            d.adapters_c, d.opt_state, d.step = \
                train["adapters_c"], train["opt"], train["step"]
            d.level = int(saved["level"])
            d.accuracy = float(saved["accuracy"])
            self._banks[n].offset = int(saved["bank_offset"])
            # serve the restored consensus at once; the version counter is
            # set to the saved value (publish bumped it by one)
            self.bank.publish(n, self._consensus_adapters(n))
            self.bank.versions[n] = int(saved["bank_version"])
        self._record_base = int(tree["rounds"])
        self._fault_round = int(tree["fault_round"])
        self.records = []

    def total_profit(self) -> float:
        return self.records[-1].cumulative if self.records else 0.0


# The paper names the system GaisNet; the runtime is the system.
GaisNet = IntegratedRuntime
