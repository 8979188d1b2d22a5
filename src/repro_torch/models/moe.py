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

On a device mesh (the reference's ``act_experts`` on `model`) every rank
routes the whole batch: the rows are gathered over the batch axes, so
the capacity ``C`` and every buffer position are the global ones and a
rank drops exactly the assignments the whole batch drops. Each `model`
rank then runs only its own experts' FFN (``experts`` on `model`, the
expert weights gathered over their ``moe_fsdp`` split) on its rows of
the buffer, and the combine takes each assignment from the one rank that
holds its expert: a sum over the `model` ranks in which every term but
one is zero, so it is exact. Each rank keeps its own rows of the result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


class _SumRanks(torch.autograd.Function):
    """Forward: the sum of ``x`` over ``group``'s ranks; backward: the
    gradient as it is (every rank's consumers of the sum hold the same
    replicated values, so each already has the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """Forward: ``x`` as it is; backward: the gradient summed over
    ``group``'s ranks (each rank's experts see their part of the
    buffer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) or (B, d). Returns (y of x's shape and dtype, the f32
    load-balance aux loss)."""
    if dt.mesh_of(x, params["gate"]) is not None:
        return _moe_mesh(params, x, cfg, capacity_factor)
    y, aux = _moe(params, x.reshape(-1, x.shape[-1]), cfg, capacity_factor)
    return y.reshape(x.shape), aux


def _moe(params: dict, xt: torch.Tensor, cfg: ModelConfig, capacity_factor,
         experts: tuple = (0, None), reduce=None):
    """The moe FFN of (T, d) tokens. ``experts`` (first, count) names the
    experts whose weights ``params`` holds (all of them by default);
    ``reduce``, a process group (None without a mesh), sums the combine's
    per-assignment rows over the ranks that hold the other experts, and
    the buffer's gradient back over them."""
    m = cfg.moe
    T, d = xt.shape
    E, k = m.n_experts, m.top_k
    C = capacity(T, cfg, capacity_factor)
    dev = xt.device
    e0, n_e = experts[0], E if experts[1] is None else experts[1]

    probs = torch.softmax(xt.float() @ params["router"], dim=-1)  # (T, E)
    top_w, top_e = top_k(probs, k)                          # (T, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- sort-based dispatch (flat index f = t * k + slot) -------------
    e_flat = top_e.reshape(-1)                              # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[se]
    dest = torch.where(pos < C, se * C + pos, E * C)        # E*C: dropped
    # the buffer row each assignment lands in, by flat index, and the
    # flat index each buffer row holds (T*k: an empty row)
    dest_flat = torch.empty_like(dest)
    dest_flat[order] = dest
    src = torch.full((E * C + 1,), T * k, dtype=order.dtype, device=dev)
    src[dest] = order
    xe = xt if reduce is None else _SumGrads.apply(xt, reduce)
    x_rep = xe[:, None].expand(T, k, d).reshape(T * k, d)
    # this rank's experts' rows of the (E, C, d) buffer
    buf = _Take.apply(x_rep, src[e0 * C:(e0 + n_e) * C]).reshape(n_e, C, d)

    # ---- expert FFN (stacked) ------------------------------------------
    h = F.silu(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    out = torch.bmm(h, params["down"]).reshape(n_e * C, d)

    # ---- combine, token-major, a fixed-order sum over k ----------------
    if n_e != E:              # assignments of other ranks' experts: zero
        mine = (dest_flat >= e0 * C) & (dest_flat < (e0 + n_e) * C)
        dest_flat = torch.where(mine, dest_flat - e0 * C, n_e * C)
    yc = _Take.apply(out, dest_flat)                        # (T*k, d)
    if reduce is not None:
        yc = _SumRanks.apply(yc, reduce)
    y = (top_w.reshape(-1, 1) * yc.float()).reshape(T, k, d).sum(1)
    y = y.to(xt.dtype)
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
    routed on every rank, this rank's experts run, the combine summed
    over `model`, this rank's rows kept."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dt.mesh_of(x, params["gate"])
    rep = dt.replicated(mesh)
    E, m = cfg.moe.n_experts, dt.model_size(mesh)
    split = m > 1 and E % m == 0
    ep = dt.with_model(rep, mesh, Shard(0) if split else Replicate())
    p = {"router": dt.local_as(params["router"], rep),
         **{n: dt.local_as(params[n], ep) for n in ("gate", "up", "down")}}
    if "shared" in params:
        p["shared"] = {n: dt.local_as(w, rep)
                       for n, w in params["shared"].items()}
    n_e = E // m if split else E
    first = mesh.get_local_rank(dt.model_dim(mesh)) * n_e if split else 0
    xw = dt.local_as(x, rep)                         # every row, every rank
    y, aux = _moe(p, xw.reshape(-1, xw.shape[-1]), cfg, capacity_factor,
                  (first, n_e),
                  mesh.get_group(dt.model_dim(mesh)) if split else None)
    y = dt.wrap(y.reshape(xw.shape), mesh, rep)
    keep = tuple(p if isinstance(p, Shard) else Replicate()
                 for p in (x.placements if dt.is_dt(x) else rep))
    if keep != tuple(rep):
        y = y.redistribute(mesh, keep)              # this rank's rows
    return y, dt.wrap(aux, mesh, rep)
