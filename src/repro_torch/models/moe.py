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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import param_dtype
from repro_torch.models.layers import mlp, mlp_spec
from repro_torch.models.params import ParamSpec


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


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) or (B, d). Returns (y of x's shape and dtype, the f32
    load-balance aux loss)."""
    m = cfg.moe
    d = x.shape[-1]
    xt = x.reshape(-1, d)                                   # (T, d)
    T, E, k = xt.shape[0], m.n_experts, m.top_k
    C = capacity(T, cfg, capacity_factor)
    dev = x.device

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
    x_rep = xt[:, None].expand(T, k, d).reshape(T * k, d)
    buf = _Take.apply(x_rep, src[:E * C]).reshape(E, C, d)

    # ---- expert FFN (stacked) ------------------------------------------
    h = F.silu(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    out = torch.bmm(h, params["down"]).reshape(E * C, d)

    # ---- combine, token-major, a fixed-order sum over k ----------------
    yc = _Take.apply(out, dest_flat)                        # (T*k, d)
    y = (top_w.reshape(-1, 1) * yc.float()).reshape(T, k, d).sum(1)
    y = y.to(x.dtype)
    if m.n_shared_experts:
        y = y + mlp(params["shared"], xt)

    # ---- load-balance aux loss (Switch-style) --------------------------
    # assignments per expert, dropped ones included (``bincount(e_flat)``)
    counts = torch.diff(starts, append=starts.new_full((1,), T * k))
    route_frac = counts.float() / (T * k)
    aux = E * torch.sum(route_frac * probs.mean(0)) * m.router_aux_loss
    return y.reshape(x.shape), aux
