"""Mixture-of-Experts FFN with sort-based capacity dispatch (counterpart of
``repro/models/moe.py``).

The token -> expert assignments are sorted by expert, the tokens are
written into a per-expert capacity buffer ``(E, C, d)`` (assignments past
an expert's capacity are dropped), the expert FFNs run as three batched
products against the stacked expert weights, and each token sums its
kept experts' outputs weighted by its renormalised router probabilities.
Experts and router stay frozen under the paper's PEFT regime; adapters
only touch attention and the head.

The reference computes all of it in XLA. The port follows it step for
step, and keeps it deterministic on the card: the top-k breaks ties by
the lower expert index (``jax.lax.top_k``'s rule; ``torch.topk`` promises
no order among equals on CUDA), both sorts are stable, and no step, in
the forward or the backward, accumulates through an atomic scatter. The
row moves are :class:`_Take`, a gather whose indices hit each source row
at most once, so its backward is a write to unique rows; the sum over a
token's k experts and the gradient's sum over its k copies are fixed-order
reductions of a ``(T, k, d)`` tensor.

On a device mesh every rank routes the whole batch: the rows are
gathered over the batch axes, so the capacity ``C`` and every buffer
position are the global ones and a rank drops exactly the assignments
the whole batch drops. The layout comes from the placements of the
expert weights:

- training and engine serving (``experts`` on `model`, the reference's
  ``act_experts`` on `model`): each `model` rank runs only its own
  experts' FFN (the expert weights gathered over their ``moe_fsdp``
  split) on its rows of the buffer;
- ``moe_serving_rules`` (``experts`` on `data`, ``moe_fsdp``, the expert
  d_model dim, on `model`): each `data` rank runs its ``E / d`` experts
  on its ``d / m`` columns. The gate and up products contract over the
  split d_model, so their partial sums are added over `model` before
  ``silu(gate) * up``; ``down`` gives a d_model slice, which the combine
  keeps until the end and gathers over `model`.

Either way the combine takes each assignment from the one rank that
holds its expert: a sum over the expert ranks in which every term but
one is zero, so it is exact, and the fixed-order sum over a token's k
experts follows. Each rank keeps its own rows of the result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.models.attention import param_dtype
from repro_torch.models.layers import mlp, mlp_spec
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import dtensor as dt


def moe_spec(cfg: ModelConfig) -> dict:
    d, m, dt = cfg.d_model, cfg.moe, param_dtype(cfg)
    s = {
        "router": ParamSpec((d, m.n_experts), torch.float32,
                            ("moe_fsdp", "experts"), init="scaled"),
        "gate": ParamSpec((m.n_experts, d, m.d_ff_expert), dt,
                          ("experts", "moe_fsdp", None), init="scaled"),
        "up": ParamSpec((m.n_experts, d, m.d_ff_expert), dt,
                        ("experts", "moe_fsdp", None), init="scaled"),
        "down": ParamSpec((m.n_experts, m.d_ff_expert, d), dt,
                          ("experts", None, "moe_fsdp"), init="scaled"),
    }
    if m.n_shared_experts:
        s["shared"] = mlp_spec(d, m.n_shared_experts * m.d_ff_expert, dt)
    return s


def capacity(n_tokens: int, cfg: ModelConfig, factor=None) -> int:
    """Slots per expert. ``factor <= 0`` drops nothing (C = T k); else
    ``ceil(T k / E * factor)`` rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    f = m.capacity_factor if factor is None else factor
    if f <= 0:
        return n_tokens * m.top_k
    c = math.ceil(n_tokens * m.top_k / m.n_experts * f)
    return max(8, c + (-c) % 8)


class _Take(torch.autograd.Function):
    """``x[idx]`` along dim 0, where ``idx`` names each row of x at most
    once and ``idx == len(x)`` gives a zero row. The backward writes the
    gradient rows back to their unique source rows (plain stores, no
    accumulation); the rows of ``idx == len(x)`` land in a spare row that
    is dropped."""

    @staticmethod
    def forward(ctx, x, idx):
        n = x.shape[0]
        ctx.save_for_backward(idx)
        ctx.n = n
        rows = x.index_select(0, idx.clamp(max=n - 1))
        return torch.where((idx < n)[:, None], rows, rows.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gx = g.new_zeros((ctx.n + 1, *g.shape[1:]))
        gx[idx] = g
        return gx[:ctx.n], None


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, ties to the
    lower index, as ``jax.lax.top_k``: a stable descending sort, whose
    backward writes each value's gradient to its unique source."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _SumGrads(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the gradient summed over the
    ranks of ``groups`` (each rank's experts see their part of the
    buffer)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _GatherCols(torch.autograd.Function):
    """Forward: the ranks' column slices of ``x`` (T, n) concatenated over
    ``group`` in rank order, (T, n * ranks); backward: this rank's
    columns of the gradient (every rank's consumers hold the same
    gathered values)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.lo = dist.get_rank(group) * x.shape[-1]
        ctx.n = x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) or (B, d). Returns (y of x's shape and dtype, the f32
    load-balance aux loss)."""
    if dt.mesh_of(x, params["gate"]) is not None:
        return _moe_mesh(params, x, cfg, capacity_factor)
    y, aux = _moe(params, x.reshape(-1, x.shape[-1]), cfg, capacity_factor)
    return y.reshape(x.shape), aux


def _moe(params: dict, xt: torch.Tensor, cfg: ModelConfig, capacity_factor,
         experts: tuple = (0, None), reduce: tuple = (), cols=None):
    """The moe FFN of (T, d) tokens. ``experts`` (first, count) names the
    experts whose weights ``params`` holds (all of them by default);
    ``reduce``, process groups (none without a mesh), sums the combine's
    per-assignment rows over the ranks that hold the other experts, and
    the buffer's gradient back over them. ``cols`` (first, count, group)
    names the d_model columns that the expert weights hold
    (``moe_serving_rules``): the gate and up products are summed over
    ``group`` and the result's columns gathered over it. The routing, the
    experts' FFN and the combine are spans ``moe.route``,
    ``moe.experts`` and ``moe.combine``."""
    m = cfg.moe
    T, d = xt.shape
    E, k = m.n_experts, m.top_k
    C = capacity(T, cfg, capacity_factor)
    dev = xt.device
    e0, n_e = experts[0], E if experts[1] is None else experts[1]

    tel = telemetry.current()
    with tel.span("moe.route"):
        probs = torch.softmax(xt.float() @ params["router"],
                              dim=-1)                       # (T, E)
        top_w, top_e = top_k(probs, k)                      # (T, k)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

        # ---- sort-based dispatch (flat index f = t * k + slot) ---------
        e_flat = top_e.reshape(-1)                          # (T*k,)
        order = torch.argsort(e_flat, stable=True)
        se = e_flat[order]
        starts = torch.searchsorted(se, torch.arange(E, device=dev))
        pos = torch.arange(T * k, device=dev) - starts[se]
        dest = torch.where(pos < C, se * C + pos, E * C)    # E*C: dropped
        # the buffer row each assignment lands in, by flat index, and the
        # flat index each buffer row holds (T*k: an empty row)
        dest_flat = torch.empty_like(dest)
        dest_flat[order] = dest
        src = torch.full((E * C + 1,), T * k, dtype=order.dtype,
                         device=dev)
        src[dest] = order

    with tel.span("moe.experts"):
        sums = tuple(reduce) + ((cols[2],) if cols is not None else ())
        xe = _SumGrads.apply(xt, sums) if sums else xt
        c0, n_c = (0, d) if cols is None else cols[:2]
        x_rep = xe[:, None].expand(T, k, d).reshape(T * k, d)[
            :, c0:c0 + n_c]
        # this rank's experts' rows of the (E, C, d) buffer (its columns)
        buf = _Take.apply(x_rep, src[e0 * C:(e0 + n_e) * C]).reshape(
            n_e, C, n_c)

        # ---- expert FFN (stacked) --------------------------------------
        gate = torch.bmm(buf, params["gate"])
        up = torch.bmm(buf, params["up"])
        if cols is not None:         # the partial sums over split d_model
            gate, up = (dt.SumRanks.apply(t, (cols[2],))
                        for t in (gate, up))
        h = F.silu(gate) * up
        out = torch.bmm(h, params["down"]).reshape(n_e * C, n_c)

    with tel.span("moe.combine"):
        # ---- combine, token-major, a fixed-order sum over k ------------
        if n_e != E:          # assignments of other ranks' experts: zero
            mine = (dest_flat >= e0 * C) & (dest_flat < (e0 + n_e) * C)
            dest_flat = torch.where(mine, dest_flat - e0 * C, n_e * C)
        yc = _Take.apply(out, dest_flat)                    # (T*k, n_c)
        if reduce:
            yc = dt.SumRanks.apply(yc, tuple(reduce))
        y = (top_w.reshape(-1, 1) * yc.float()).reshape(T, k, n_c).sum(1)
        y = y.to(xt.dtype)
        if cols is not None:
            y = _GatherCols.apply(y, cols[2])
        if m.n_shared_experts:
            y = y + mlp(params["shared"], xt)

    # ---- load-balance aux loss (Switch-style) --------------------------
    # assignments per expert, dropped ones included (``bincount(e_flat)``)
    counts = torch.diff(starts, append=starts.new_full((1,), T * k))
    route_frac = counts.float() / (T * k)
    aux = E * torch.sum(route_frac * probs.mean(0)) * m.router_aux_loss
    return y, aux


def _moe_mesh(params: dict, x, cfg: ModelConfig, capacity_factor):
    """:func:`moe_apply` on a mesh (see the module note): the whole batch
    routed on every rank, this rank's experts run (on its d_model columns
    under ``moe_serving_rules``), the combine summed over the expert
    ranks, this rank's rows kept."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dt.mesh_of(x, params["gate"])
    rep = dt.replicated(mesh)
    md = dt.model_dim(mesh)
    p = {"router": dt.local_as(params["router"], rep)}
    if "shared" in params:
        p["shared"] = {n: dt.local_as(w, rep)
                       for n, w in params["shared"].items()}
    on = [i for i in dt.split_dims(params["gate"], 0) if i != md]
    cols = None
    if on:                           # moe_serving_rules: experts on `data`
        dsplit = md in dt.split_dims(params["gate"], 1)

        def pl(dim):                 # experts on `on`, d_model on `model`
            return dt.with_model(dt.with_dims(rep, on, Shard(0)), mesh,
                                 Shard(dim) if dsplit else Replicate())
        p.update(gate=dt.local_as(params["gate"], pl(1)),
                 up=dt.local_as(params["up"], pl(1)),
                 down=dt.local_as(params["down"], pl(2)))
        n_e = p["gate"].shape[0]
        first = dt.local_rows(params["gate"], 0)[1]   # split on `on`
        groups = tuple(mesh.get_group(i) for i in on)
        if dsplit:
            n_c = p["gate"].shape[1]
            cols = (mesh.get_local_rank(md) * n_c, n_c, mesh.get_group(md))
    else:                            # experts on `model`
        E, m = cfg.moe.n_experts, dt.model_size(mesh)
        split = m > 1 and E % m == 0
        ep = dt.with_model(rep, mesh, Shard(0) if split else Replicate())
        p.update({n: dt.local_as(params[n], ep)
                  for n in ("gate", "up", "down")})
        n_e = E // m if split else E
        first = mesh.get_local_rank(md) * n_e if split else 0
        groups = (mesh.get_group(md),) if split else ()
    xw = dt.local_as(x, rep)                         # every row, every rank
    y, aux = _moe(p, xw.reshape(-1, xw.shape[-1]), cfg, capacity_factor,
                  (first, n_e), groups, cols)
    y = dt.wrap(y.reshape(xw.shape), mesh, rep)
    keep = tuple(p if isinstance(p, Shard) else Replicate()
                 for p in (x.placements if dt.is_dt(x) else rep))
    if keep != tuple(rep):
        y = y.redistribute(mesh, keep)              # this rank's rows
    return y, dt.wrap(aux, mesh, rep)
