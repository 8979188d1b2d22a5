"""Hybrid Federated Split Learning trainer (paper §III-C, Fig 4; counterpart
of ``repro/core/hfsl.py``).

Every fine-tuning client cluster trains its own adapter replica on its own
data shard against one shared frozen backbone; every ``sync_every`` steps
the replicas are averaged (FedAvg, the paper's "uploading and aggregation
of end model"). Optimizer state stays cluster-local, as in standard
FedAvg. With ``sync_every=1`` this is synchronous data-parallel PEFT; with
one cluster it is SL.

Layout. The train state is ``{backbone, adapters_c, opt, step}``.
``adapters_c`` has the adapters' structure with a leading cluster dim on
every leaf: ``(n_clusters, ...)`` inside the port's per-layer lists (the
same idea as the AdapterBank's slot-leading leaves; the reference's leaves
are ``(n_clusters, L, ...)``). ``opt`` is cluster-leading too: an int32
``step`` of shape ``(n_clusters,)`` and f32 moments shaped like
``adapters_c``. FedAvg is an f32 mean over dim 0, cast back.

Execution. The reference vmaps one cluster's update over the cluster dim
and scans the steps in one jitted dispatch. The port loops over clusters
(sharing the one frozen backbone) and over steps in Python. Batches come
from a device-resident bank and are gathered on the device by step index;
the FedAvg boundary is decided on the device from the carried step
counter; nothing inside a round reads a value back to the host. Metrics
come back as stacked ``(steps,)`` tensors.

Two entry points share one step body (:func:`_make_step_body`):
:func:`make_hfsl_step` (one step per call) and :func:`make_hfsl_round`
(``steps`` steps per call).

Mesh. ``make_hfsl_round(mesh=...)`` runs the round on a (`data`, `model`)
device mesh, every family: the train state and the batch bank are
DTensors with their cluster dim on (`pod`, `data`)
(:func:`hfsl_state_shardings`, ``BatchBank.pack(mesh=)``). Each `data`
rank runs its own clusters through the cluster loop; FedAvg is a local
sum plus an ``all_reduce`` over the cluster axes, in f32
(:class:`_Clusters`). Inside a cluster the `model` ranks split the work
as ``hfsl_round_rules`` says:

- dense, moe, vlm and audio: tensor parallelism, against the backbone
  split over `model` (the hand-written kernels on local shards, a moe's
  experts on their ranks);
- ssm and hybrid (the rules put the cluster's `batch` on `model`): each
  `model` rank takes its rows of the cluster batch against the backbone
  and the cluster's adapters gathered whole once, at the round's start
  (the backbone is frozen and the adapters change only through the
  reduced gradients, the same on every rank); the loss and the
  gradients are the cluster's token-weighted means: each rank's mean
  weighted by its share of the rows (every row carries the same tokens)
  and summed over `model` before the update, so the update is the one of
  the whole batch.

The output state keeps the input's placements.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.peft import value_and_grad
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm)
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.rules import (hfsl_round_rules, partition_specs,
                                        use_rules)

_TRAIN_KEYS = ("adapters_c", "opt", "step")    # donated; backbone never is


def _cluster(tree, c: int):
    """Cluster ``c``'s slice of a cluster-leading tree (views)."""
    return tree_map(lambda x: x[c], tree)


def _stack_clusters(trees: list):
    """Per-cluster trees -> one cluster-leading tree."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(n,) per-cluster values shaped to broadcast against leaf ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# Specs / init
# ---------------------------------------------------------------------------

def _cluster_stack(tree, n: int):
    """A leading `cluster` dim on every adapter ParamSpec; inner `fsdp`
    axes are dropped (`cluster` already takes the (pod, data) axes)."""
    def f(s: ParamSpec) -> ParamSpec:
        inner = tuple(None if a == "fsdp" else a for a in s.axes) \
            if s.axes else (None,) * len(s.shape)
        return ParamSpec((n, *s.shape), s.dtype, ("cluster", *inner),
                         init=s.init, scale=s.scale)
    return tree_map(f, tree)


def hfsl_state_spec(cfg, n_clusters: int, optimizer: Optimizer,
                    model_spec_fn: Callable) -> dict:
    """ParamSpec tree of the whole HFSL train state. The optimizer state
    is declared from ``optimizer.init``'s structure: a cluster-leading
    step and f32 moments shaped like ``adapters_c``."""
    ms = model_spec_fn(cfg)
    adapters_c = _cluster_stack(ms["adapters"], n_clusters)
    meta = tree_map(lambda s: torch.empty(s.shape[1:], dtype=s.dtype,
                                          device="meta"), adapters_c)

    def f32_like(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, torch.float32, s.axes, init="zeros")

    opt = {k: ParamSpec((n_clusters,), torch.int32, ("cluster",),
                        init="zeros") if k == "step"
           else (None if v is None else tree_map(f32_like, adapters_c))
           for k, v in optimizer.init(meta).items()}
    return {"backbone": ms["backbone"], "adapters_c": adapters_c,
            "opt": opt, "step": ParamSpec((), torch.int32, (),
                                          init="zeros")}


def hfsl_state_shardings(cfg, n_clusters: int, optimizer: Optimizer,
                         model_spec_fn: Callable, mesh,
                         rules: Optional[dict] = None) -> dict:
    """Partition-spec tree of the whole train state on ``mesh`` (default
    rules ``hfsl_round_rules``): the adapter replicas and the optimizer
    moments put their cluster dim on (`pod`, `data`), the backbone splits
    where its dims divide. ``sharding.rules.distribute_tree(state, specs,
    mesh)`` places a state so."""
    rules = rules or hfsl_round_rules(cfg.family)
    return partition_specs(hfsl_state_spec(cfg, n_clusters, optimizer,
                                           model_spec_fn), mesh, rules)


# ---------------------------------------------------------------------------
# The cluster dim, whole or split over a mesh
# ---------------------------------------------------------------------------

class _Clusters:
    """The cluster dim as one rank sees it. Without a mesh every cluster is
    local and every operation is the plain one. On a mesh, a rank holds
    the clusters of its (`pod`, `data`) coordinates (``n_local`` from
    ``lo``); cluster means are a local f32 sum and an ``all_reduce`` over
    those axes, per-cluster vectors are gathered whole, and each cluster's
    adapters and optimizer moments become DTensors on the `model` sub-mesh
    for its forward and update, split over `model` as the matching
    leaves of ``train`` (the round's input train state) are."""

    def __init__(self, mesh=None, rules=None, train=None):
        self.mesh, self.rules, self.like = mesh, rules, train
        self.split: list = []            # mesh dims the clusters split over
        self.sub = None                  # the `model` sub-mesh
        self.lo, self.n_local = 0, None
        # the cluster batch's rows split over `model` (ssm, hybrid)
        self.rows = bool(rules) and rules.get("batch") == "model"
        if mesh is None:
            return
        from torch.distributed.tensor import Shard
        leaf = tree_leaves(train["adapters_c"])[0]
        self.n = leaf.shape[0]
        md = dt.model_dim(mesh)
        self.split = [i for i, p in enumerate(leaf.placements)
                      if isinstance(p, Shard) and p.dim == 0 and i != md]
        loc, self.lo = dt.local_rows(leaf)
        self.n_local = loc.shape[0]
        if md is not None:
            self.sub = mesh[mesh.mesh_dim_names[md]]

    # -- per-cluster vectors and means
    def local(self, v: torch.Tensor) -> torch.Tensor:
        """(n,) -> this rank's (n_local,)."""
        return v if self.mesh is None else v[self.lo:self.lo + self.n_local]

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's (n_local, ...) -> every cluster's (n, ...)."""
        import torch.distributed as dist
        for i in reversed(self.split):   # minor axis first
            g = self.mesh.get_group(i)
            parts = [torch.empty_like(v)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, v.contiguous(), group=g)
            v = torch.cat(parts)
        return v

    def mean0(self, xf: torch.Tensor) -> torch.Tensor:
        """f32 mean over every cluster, (1, ...)."""
        if self.mesh is None:
            return xf.mean(0, keepdim=True)
        return self.sum0(xf) / self.n

    def sum0(self, xf: torch.Tensor) -> torch.Tensor:
        """f32 sum over every cluster, (1, ...)."""
        import torch.distributed as dist
        s = xf.sum(0, keepdim=True)
        for i in self.split:
            dist.all_reduce(s, group=self.mesh.get_group(i))
        return s

    # -- a row-split cluster (ssm, hybrid): its batch over `model`
    def _model_ranks(self) -> tuple[int, int]:
        if self.sub is None:
            return 0, 1
        md = dt.model_dim(self.mesh)
        return self.mesh.get_local_rank(md), self.mesh.size(md)

    def batch_rows(self, batch: dict) -> tuple[dict, float]:
        """This `model` rank's rows of a cluster batch and their share of
        the batch (every row when the rows do not divide: each rank then
        takes 1/m of the whole)."""
        r, m = self._model_ranks()
        n = next(iter(batch.values())).shape[0]
        if m == 1 or n % m:
            return batch, 1.0 / m
        k = n // m
        return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}, \
            k / n

    def reduce(self, tree):
        """The sum over the `model` ranks of each leaf (f32 sums of the
        weighted shares, cast back)."""
        _, m = self._model_ranks()
        if m == 1:
            return tree
        import torch.distributed as dist
        g = self.mesh.get_group(dt.model_dim(self.mesh))

        def f(x):
            y = x.float().clone()
            dist.all_reduce(y, group=g)
            return y.to(x.dtype)
        return tree_map(f, tree)

    def whole_over_model(self, x):
        """A state leaf gathered over `model` (its cluster split kept):
        this rank's clusters, every channel."""
        from torch.distributed.tensor import Replicate
        if not dt.is_dt(x):
            return x
        md = dt.model_dim(self.mesh)
        return dt.local_as(x, [Replicate() if i == md else p
                               for i, p in enumerate(x.placements)])

    # -- one cluster's trees on the model sub-mesh
    def wrap(self, tree, like):
        """Cluster slices (plain, local) -> DTensors on the `model`
        sub-mesh, split over `model` as the matching cluster-leading leaf
        of ``like`` is (its dim ``d`` is the slice's ``d - 1``)."""
        if self.sub is None:
            return tree
        from torch.distributed.tensor import DTensor, Replicate, Shard
        md = dt.model_dim(self.mesh)

        def f(x, ref):
            if not dt.is_dt(ref):
                return x
            p = ref.placements[md]
            p = Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
            return DTensor.from_local(x, self.sub, [p], run_check=False)
        return tree_map(f, tree, like)

    def backbone(self, tree):
        """The backbone on the `model` sub-mesh: each leaf gathered over
        the other axes (its FSDP split), its `model` split kept (a mesh
        without a `model` axis, or a row-split cluster: whole, plain)."""
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import DTensor, Replicate
        md = dt.model_dim(self.mesh)

        def f(x):
            if not dt.is_dt(x):
                return x
            if self.rows:
                return dt.local_as(x, dt.replicated(self.mesh))
            pl = [x.placements[i] if i == md else Replicate()
                  for i in range(self.mesh.ndim)]
            loc = x.redistribute(self.mesh, pl).to_local()
            if self.sub is None:
                return loc
            return DTensor.from_local(loc, self.sub, [pl[md]],
                                      run_check=False)
        return tree_map(f, tree)

    @staticmethod
    def unwrap(out: tuple) -> tuple:
        """A cluster update's (adapters, opt, loss, aux) as local
        tensors."""
        return tuple(tree_map(lambda x: x.to_local() if dt.is_dt(x) else x,
                              t) for t in out)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_hfsl_state(seed: int, cfg, n_clusters: int, optimizer: Optimizer,
                    model_init_fn: Callable, *, device=None) -> dict:
    """``model_init_fn(cfg, seed, device=)`` params -> the train state; the
    cluster replicas start identical (edge model delivery, Fig 4 step 1)."""
    params = model_init_fn(cfg, seed, device=device)
    adapters_c = tree_map(
        lambda x: x[None].expand(n_clusters, *x.shape).clone(),
        params["adapters"])
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(adapters_c)[0].device)
    return {"backbone": params["backbone"], "adapters_c": adapters_c,
            "opt": init_opt_state(optimizer, adapters_c), "step": step}


def init_opt_state(optimizer: Optimizer, adapters_c):
    """Cluster-leading optimizer state of ``adapters_c`` (the reference's
    ``jax.vmap(optimizer.init)``): one ``init`` per cluster, stacked."""
    n = tree_leaves(adapters_c)[0].shape[0]
    return _stack_clusters([optimizer.init(_cluster(adapters_c, c))
                            for c in range(n)])


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def fedavg(adapters_c, clusters: Optional[_Clusters] = None):
    """FedAvg over the cluster dim: f32 mean, broadcast back to every
    cluster in the leaf dtype (on a mesh, the mean over every rank's
    clusters)."""
    c = clusters or _Clusters()
    return tree_map(
        lambda x: c.mean0(x.float()).expand_as(x).to(x.dtype)
        .contiguous(), adapters_c)


def _make_cluster_update(cfg, optimizer: Optimizer, loss_fn: Callable,
                         clip_norm: float, microbatches: int,
                         clusters: Optional[_Clusters] = None) -> Callable:
    """Per-cluster local step: grads (optionally accumulated over
    ``microbatches`` splits of the cluster batch) -> one optimizer update.
    On a mesh, the cluster's adapters and moments run as DTensors on the
    `model` sub-mesh and come back as local tensors."""
    c = clusters or _Clusters()

    def one_cluster(backbone, adapters, opt_state, batch):
        if c.rows:
            batch, share = c.batch_rows(batch)
            return _update(backbone, adapters, opt_state, batch, share)
        if c.sub is not None:
            adapters = c.wrap(adapters, c.like["adapters_c"])
            opt_state = c.wrap(opt_state, c.like["opt"])
            with use_rules(c.sub, c.rules):
                out = _update(backbone, adapters, opt_state, batch)
            return c.unwrap(out)
        return _update(backbone, adapters, opt_state, batch)

    def _update(backbone, adapters, opt_state, batch, share=None):
        def inner(a, mb):
            return loss_fn({"backbone": backbone, "adapters": a}, mb, cfg)

        if microbatches <= 1:
            (loss, aux), grads = value_and_grad(inner, adapters, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(
                    f"cluster batch {rows} not divisible by "
                    f"microbatches={microbatches}")
            size = rows // microbatches
            grads = loss = aux = None
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                (l, ax), g = value_and_grad(inner, adapters, mb)
                if grads is None:               # the reference adds to zeros
                    grads, loss, aux = g, l, ax
                else:
                    grads = tree_map(torch.add, grads, g)
                    loss = loss + l
                    aux = tree_map(torch.add, aux, ax)
            inv = 1.0 / microbatches
            # mean-of-means == full-batch mean for equal splits
            grads = tree_map(lambda g: (g * inv).to(g.dtype), grads)
            loss = loss * inv
            aux = tree_map(lambda v: v * inv, aux)
        if share is not None:         # a row-split cluster: the whole batch
            grads, loss, aux = c.reduce(tree_map(
                lambda v: v * share, [grads, loss, aux]))
        with torch.no_grad():
            if clip_norm:
                grads, _ = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = optimizer.update(grads, opt_state, adapters)
            adapters = apply_updates(adapters, updates)
        return adapters, opt_state, loss, aux

    return one_cluster


def fedavg_masked(adapters_c, mask, clusters: Optional[_Clusters] = None):
    """Partial-participation FedAvg: mean over the clusters ``mask`` keeps,
    broadcast back to those clusters ONLY — a masked-out (dropped or
    straggling) cluster's replica passes through bit-unchanged. With an
    all-ones mask the plain-mean result is selected, so the full-
    participation case equals :func:`fedavg` bit for bit. ``mask`` has
    one entry per cluster of every rank."""
    c = clusters or _Clusters()
    m_all = mask.float()
    cnt = m_all.sum().clamp_min(1.0)         # 0 survivors -> no-op round
    full = (m_all > 0).all()
    m = c.local(m_all)

    def f(x):
        mm = _bcast(m, x)
        xf = x.float()
        plain = c.mean0(xf)
        masked = c.sum0(xf * mm) / cnt
        avg = torch.where(full, plain, masked).expand_as(x).to(x.dtype)
        return torch.where(mm > 0, avg, x)

    return tree_map(f, adapters_c)


def _clusters_finite(tree) -> torch.Tensor:
    """Per-cluster all-leaves-finite flag (n_clusters,) of a
    cluster-leading tree."""
    oks = [torch.isfinite(x.float()).reshape(x.shape[0], -1).all(1)
           for x in tree_leaves(tree)]
    return functools.reduce(torch.logical_and, oks)


def _sync_at_boundary(adapters_c, new_step, *, sync_every: int,
                      always_sync: bool, mask=None, clusters=None):
    """FedAvg at ``sync_every`` multiples of the step counter (a device
    tensor: the choice is a select, not a host branch). With ``mask``
    (participation, (n,)) only surviving clusters are averaged."""
    avg = functools.partial(fedavg, clusters=clusters) if mask is None \
        else functools.partial(fedavg_masked, mask=mask, clusters=clusters)
    if always_sync or sync_every == 1:
        return avg(adapters_c)
    do_sync = (new_step % sync_every) == 0
    return tree_map(lambda s, a: torch.where(do_sync, s, a), avg(adapters_c),
                    adapters_c)


def _make_step_body(cfg, optimizer: Optimizer, loss_fn: Callable, *,
                    sync_every: int, clip_norm: float, always_sync: bool,
                    microbatches: int, faulted: bool = False,
                    clusters: Optional[_Clusters] = None) -> Callable:
    """``step(state, batch) -> (state, metrics)``; batch leaves carry a
    leading cluster dim.

    ``faulted=True`` returns the fault-tolerant body
    ``step(state, batch, mask, corrupt)``: a per-cluster participation
    ``mask`` (float (n,), >0 = present) gates both the local update and the
    FedAvg, a per-cluster ``corrupt`` flag NaN-poisons that cluster's
    computed update and loss, and a non-finite guard keeps the pre-step
    replica of any cluster whose update went NaN/inf (a select on the
    device, no host sync). The differentiated per-cluster step is the same
    as the plain body's, and every guard is a select, so with an all-ones
    mask and no corruption the outputs equal the plain body's bit for
    bit.

    ``clusters`` (a mesh round's :class:`_Clusters`) makes the state's
    cluster-leading leaves this rank's clusters, and the step's per-cluster
    metrics every cluster's."""
    cl = clusters or _Clusters()
    one_cluster = _make_cluster_update(cfg, optimizer, loss_fn, clip_norm,
                                       microbatches, cl)

    def vstep(state, batch):
        n = state["opt"]["step"].shape[0]
        outs = [one_cluster(state["backbone"],
                            _cluster(state["adapters_c"], c),
                            _cluster(state["opt"], c), _cluster(batch, c))
                for c in range(n)]
        return (_stack_clusters([o[0] for o in outs]),
                _stack_clusters([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]),
                _stack_clusters([o[3] for o in outs]))

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        adapters_c, opt_c, loss_c, aux_c = vstep(state, batch)
        new_step = state["step"] + 1
        adapters_c = _sync_at_boundary(adapters_c, new_step,
                                       sync_every=sync_every,
                                       always_sync=always_sync, clusters=cl)
        loss_c = cl.gather(loss_c)
        metrics = {"loss": loss_c.mean(), "loss_per_cluster": loss_c}
        for k in (aux_c or {}):
            metrics[k] = cl.gather(aux_c[k]).mean()
        return {**state, "adapters_c": adapters_c, "opt": opt_c,
                "step": new_step}, metrics

    def step_faulted(state: dict, batch: dict, mask, corrupt
                     ) -> tuple[dict, dict]:
        new_a, new_opt, loss_c, aux_c = vstep(state, batch)
        # corruption is injected AFTER the differentiated step, so the
        # unflagged clusters run the plain body's exact arithmetic while the
        # guard below sees a genuinely non-finite update
        corrupt_l = cl.local(corrupt)
        new_a = tree_map(
            lambda x: torch.where(_bcast(corrupt_l, x),
                                  torch.full_like(x, float("nan")), x)
            if x.is_floating_point() else x, new_a)
        loss_c = torch.where(corrupt_l,
                             torch.full_like(loss_c, float("nan")), loss_c)
        part = mask > 0
        ok = (_clusters_finite(new_a) & _clusters_finite(new_opt)
              & torch.isfinite(loss_c))
        eff = cl.local(part) & ok

        def sel(new, old):
            return tree_map(lambda n_, o: torch.where(_bcast(eff, n_), n_, o),
                            new, old)

        adapters_c = sel(new_a, state["adapters_c"])
        opt_c = sel(new_opt, state["opt"])
        new_step = state["step"] + 1
        adapters_c = _sync_at_boundary(adapters_c, new_step,
                                       sync_every=sync_every,
                                       always_sync=always_sync,
                                       mask=part.float(), clusters=cl)
        loss_c, ok, eff = cl.gather(loss_c), cl.gather(ok), cl.gather(eff)
        # where-masked means (a guarded cluster's loss is NaN, and NaN * 0
        # would poison the mean); the all-effective case selects the plain
        # mean, so fault-free metrics equal the plain body's
        denom = eff.float().sum().clamp_min(1.0)
        all_eff = eff.all()

        def mmean(v):
            return torch.where(all_eff, v.mean(),
                               torch.where(eff, v, 0.0).sum() / denom)

        n = part.shape[0]
        npart = part.to(torch.int32).sum()
        metrics = {"loss": mmean(loss_c),
                   "loss_per_cluster": loss_c,
                   "participating": npart,
                   "skipped": (part & ~ok).to(torch.int32).sum(),
                   "dropped": n - npart}
        for k in (aux_c or {}):
            metrics[k] = mmean(cl.gather(aux_c[k]))
        return {**state, "adapters_c": adapters_c, "opt": opt_c,
                "step": new_step}, metrics

    return step_faulted if faulted else step


def make_hfsl_step(cfg, optimizer: Optimizer, loss_fn: Callable, *,
                   sync_every: int = 1, clip_norm: float = 0.0,
                   always_sync: bool = False,
                   microbatches: int = 1) -> Callable:
    """One HFSL step per call: ``step(state, batch) -> (state, metrics)``.

    loss_fn(params, batch, cfg) -> (loss, aux). Batch leaves carry a
    leading cluster dim (see data/pipeline.cluster_batches)."""
    return _make_step_body(cfg, optimizer, loss_fn, sync_every=sync_every,
                           clip_norm=clip_norm, always_sync=always_sync,
                           microbatches=microbatches)


def _write_into(dst, src):
    """Copy ``src``'s leaves into ``dst``'s tensors in place."""
    tree_map(lambda d, s: d.copy_(s), dst, src)
    return dst


def make_hfsl_round(cfg, optimizer: Optimizer, loss_fn: Callable, *,
                    steps: int, sync_every: int = 1, clip_norm: float = 0.0,
                    always_sync: bool = False, microbatches: int = 1,
                    remat: Optional[bool] = None, donate: bool = False,
                    mesh=None, rules: Optional[dict] = None,
                    state_spec: Optional[dict] = None) -> Callable:
    """A fine-tuning round: ``steps`` HFSL steps per call.

    Returned ``round_fn(state, bank, offset=0, *, mask=None, corrupt=None)
    -> (state, metrics)``:

    - ``state`` — the :func:`init_hfsl_state` dict; the carried
      ``state['step']`` counter enters and leaves the round, so the FedAvg
      phase is preserved across rounds.
    - ``bank`` — device-resident batch bank: every leaf shaped
      ``(E, n_clusters, batch, ...)`` (data/pipeline.py::BatchBank.arrays).
      Step ``i`` trains on row ``(offset + i) % E``, gathered on the
      device.
    - ``metrics`` — the per-step metrics stacked to leading ``(steps,)``.
    - ``mask`` / ``corrupt`` — per-cluster participation and corruption
      flags (host arrays, e.g. a fault plan's schedule). A round where no
      fault fires runs the plain body; otherwise the faulted body.

    ``microbatches`` accumulates gradients over that many equal splits of
    each cluster batch before the update. ``remat`` is forwarded to
    ``loss_fn`` (``model.lm_loss`` re-materialises each layer in the
    backward); None leaves the loss untouched. Without ``donate`` the
    caller's state is left as it was; with ``donate=True`` the round's
    results are written into the input state's adapter, optimizer and step
    tensors (never the backbone's), which the returned state then holds.

    Numerics equal ``steps`` sequential :func:`make_hfsl_step` calls on the
    same batches: the two share one step body.

    ``mesh`` makes the round mesh-native (every family): ``state`` and
    ``bank`` are DTensors placed per :func:`hfsl_state_shardings` and
    ``BatchBank.pack(mesh=...)`` (``state_spec``, the
    :func:`hfsl_state_spec` tree, is required with it); each rank runs its
    own clusters under ``rules`` (default ``hfsl_round_rules``) on the
    `model` sub-mesh, FedAvg all-reduces over the cluster axes, and the
    output state has the input's placements. Metrics come back whole on
    every rank."""
    if mesh is not None and state_spec is None:
        raise ValueError("make_hfsl_round(mesh=...) requires state_spec= "
                         "(the hfsl_state_spec tree) to place the round's "
                         "train state")
    rules = rules or (hfsl_round_rules(cfg.family) if mesh is not None
                      else None)
    if remat is not None:
        loss_fn = functools.partial(loss_fn, remat=remat)
    def bodies(clusters):
        return {f: _make_step_body(cfg, optimizer, loss_fn,
                                   sync_every=sync_every,
                                   clip_norm=clip_norm,
                                   always_sync=always_sync,
                                   microbatches=microbatches, faulted=f,
                                   clusters=clusters)
                for f in (False, True)}

    plain_bodies = bodies(None) if mesh is None else None

    def round_core(train: dict, backbone, bank: dict, offset, faulted: bool,
                   mask=None, corrupt=None,
                   steps_fns=None) -> tuple[dict, dict]:
        step = (steps_fns or plain_bodies)[faulted]
        lead = next(iter(bank.values()))
        rows = (torch.as_tensor(offset, device=lead.device)
                + torch.arange(steps, device=lead.device)) % lead.shape[0]
        carry, per_step = train, []
        for i in range(steps):
            batch = {k: x.index_select(0, rows[i:i + 1])[0]
                     for k, x in bank.items()}
            state = {**carry, "backbone": backbone}
            out, metrics = (step(state, batch, mask, corrupt) if faulted
                            else step(state, batch))
            carry = {k: out[k] for k in _TRAIN_KEYS}
            per_step.append(metrics)
        return carry, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    def round_fn(state: dict, bank: dict, offset=0, *, mask=None,
                 corrupt=None) -> tuple[dict, dict]:
        # clean-round fast path, decided on the host from the fault plan's
        # host-side schedule
        clean = ((mask is None or bool((np.asarray(mask) > 0).all()))
                 and (corrupt is None or not bool(np.asarray(corrupt).any())))
        train = {k: state[k] for k in _TRAIN_KEYS}
        # the span covers the host's enqueue of the round's work (the device
        # may still be running when it closes); the end-to-end round time
        # is the caller's clock around a synchronize
        tel = telemetry.get()
        with tel.span("hfsl.round_dispatch", steps=steps, clean=clean):
            if mesh is not None:
                out, metrics = _mesh_round(state, bank, offset, clean, mask,
                                           corrupt)
            elif clean:
                out, metrics = round_core(train, state["backbone"], bank,
                                          offset, False)
            else:
                dev = state["step"].device
                n = state["opt"]["step"].shape[0]
                mask = (torch.ones((n,), dtype=torch.float32, device=dev)
                        if mask is None else torch.as_tensor(
                            np.asarray(mask), dtype=torch.float32,
                            device=dev))
                corrupt = (torch.zeros((n,), dtype=torch.bool, device=dev)
                           if corrupt is None else torch.as_tensor(
                               np.asarray(corrupt), dtype=torch.bool,
                               device=dev))
                out, metrics = round_core(train, state["backbone"], bank,
                                          offset, True, mask, corrupt)
            if donate and mesh is None:
                out = {k: _write_into(state[k], out[k]) for k in _TRAIN_KEYS}
        tel.count("hfsl.rounds")
        tel.count("hfsl.steps", steps)
        if not clean:
            tel.count("hfsl.faulted_rounds")
        return {**out, "backbone": state["backbone"]}, metrics

    def _mesh_round(state, bank, offset, clean, mask, corrupt):
        """One round on the mesh: this rank's clusters of the local
        shards, the output wrapped back into the input's placements."""
        from torch.distributed.tensor import DTensor
        train = {k: state[k] for k in _TRAIN_KEYS}
        cl = _Clusters(mesh, rules, train)
        for leaf in bank.values():
            if dt.is_dt(leaf) and dt.local_rows(leaf, 1)[1] != cl.lo:
                raise ValueError("the batch bank's cluster dim is not "
                                 "split like the train state's: pack it "
                                 "with BatchBank.pack(mesh=, rules=)")
        gather = cl.whole_over_model if cl.rows else \
            (lambda x: x.to_local() if dt.is_dt(x) else x)
        local = {k: tree_map(gather, v) for k, v in train.items()}
        bank_l = {k: v.to_local() if dt.is_dt(v) else v
                  for k, v in bank.items()}
        dev = local["step"].device
        n = state["opt"]["step"].shape[0]
        if not clean:
            mask = (torch.ones((n,), dtype=torch.float32, device=dev)
                    if mask is None else torch.as_tensor(
                        np.asarray(mask), dtype=torch.float32, device=dev))
            corrupt = (torch.zeros((n,), dtype=torch.bool, device=dev)
                       if corrupt is None else torch.as_tensor(
                           np.asarray(corrupt), dtype=torch.bool,
                           device=dev))
        out_l, metrics = round_core(local, cl.backbone(state["backbone"]),
                                    bank_l, offset, not clean, mask,
                                    corrupt, steps_fns=bodies(cl))

        def part(x, ref):               # this rank's part of ref's layout
            if not cl.rows or not dt.is_dt(ref):
                return x
            from torch.distributed.tensor import Replicate
            md = dt.model_dim(mesh)
            whole = [Replicate() if i == md else p
                     for i, p in enumerate(ref.placements)]
            return dt.local_as(dt.wrap(x, mesh, whole), ref.placements)

        def back(x, ref):
            if not dt.is_dt(ref):
                return x
            return DTensor.from_local(part(x, ref), ref.device_mesh,
                                      ref.placements, run_check=False)

        def write(d, s):
            (d.to_local() if dt.is_dt(d) else d).copy_(part(s, d))
            return d
        fn = write if donate else (lambda d, s: back(s, d))
        return {k: tree_map(fn, train[k], out_l[k])
                for k in _TRAIN_KEYS}, metrics

    return round_fn


def consensus_params(state: dict) -> dict:
    """Aggregated model (edge view after FedAvg): cluster-mean adapters."""
    return {"backbone": state["backbone"],
            "adapters": tree_map(lambda x: x.float().mean(0).to(x.dtype),
                                 state["adapters_c"])}


# ---------------------------------------------------------------------------
# Communication accounting (per §III-C.2)
# ---------------------------------------------------------------------------

def sync_bytes(adapters_c) -> int:
    """Bytes moved per FedAvg round: each cluster uploads + downloads its
    adapter replica (the parameter-efficient flow)."""
    leaves = tree_leaves(adapters_c)
    per_replica = sum(math.prod(x.shape[1:]) * x.element_size()
                      for x in leaves)
    return 2 * leaves[0].shape[0] * per_replica
