"""RecurrentGemma recurrent block, RG-LRU plus a temporal conv branch (the
hybrid family's ``rglru`` sub-layer; counterpart of
``repro/models/rglru.py``).

The PEFT adaptation mirrors the ssm case: a learned initial recurrent
state per layer (``adapters['state0']``, shape (W,)) is the prompt module.
The recurrence over a sequence goes through the ``rglru_scan`` kernel
(``kernels/ops.py``); a decode step is torch operations, as the
reference's is plain XLA.

The dtype flow is the reference's: ``a_param`` is f32, the causal conv sums
its taps in f32 and casts once, the state ``h`` stays f32, the conv tail is
stored in the config dtype, and the gelu of the ``in_y`` branch is the tanh
approximation (``jax.nn.gelu``'s default).

On a device mesh (serving) each rank runs its rows and its channels
(``lru`` on `model`, where they divide), as the ssm mixer does: the conv
and the scan keep the channels apart; the gate products (``w_r``, ``w_i``:
(lru, None)) contract them, so they are summed over the `model` ranks and
cut to this rank's channels again, and ``out`` is summed likewise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import (_conv1d_causal, _dtype, _identity,
                                    _ragged_conv_tail, _verify, local_state,
                                    mesh_rows)
from repro_torch.sharding import dtensor as dt


def rglru_spec(cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    dc = cfg.hybrid.conv_width
    dt = _dtype(cfg)
    return {
        "in_x": ParamSpec((d, w), dt, ("fsdp", "lru"), init="scaled"),
        "in_y": ParamSpec((d, w), dt, ("fsdp", "lru"), init="scaled"),
        "conv_w": ParamSpec((dc, w), dt, ("conv", "lru"), init="scaled"),
        "conv_b": ParamSpec((w,), dt, ("lru",), init="zeros"),
        "w_r": ParamSpec((w, w), dt, ("lru", None), init="scaled"),
        "w_i": ParamSpec((w, w), dt, ("lru", None), init="scaled"),
        "a_param": ParamSpec((w,), torch.float32, ("lru",), init="ones"),
        "out": ParamSpec((w, d), dt, ("lru", "fsdp"), init="scaled"),
    }


def rglru_state0_spec(cfg: ModelConfig, layers: int) -> ParamSpec:
    return ParamSpec((layers, cfg.lru_width), torch.float32, (None, "lru"),
                     init="zeros")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rglru_seq(params: dict, adapters: Optional[dict], x: torch.Tensor,
              cfg: ModelConfig, *, make_cache: bool = False,
              lengths: Optional[torch.Tensor] = None):
    """Full-sequence recurrent block. x: (B, S, d). Returns (out, cache or
    None).

    ``lengths`` (B,) marks ragged right-padded rows: padded columns get
    ``r_gate = -1e9``, so ``a_t = exp(sigmoid(-1e9) log_a) = 1`` exactly
    and the input term ``sqrt(1 - a_t²) ... = 0``: the recurrence is the
    identity there and the final state is bitwise the state after row b's
    last valid token. The conv cache tail is gathered per row."""
    if dt.mesh_of(x, params["in_x"]) is not None:
        return _seq_mesh(params, adapters, x, cfg, make_cache, lengths)
    return _seq(params, (adapters or {}).get("state0"), x, cfg,
                make_cache=make_cache, lengths=lengths)


def _gates(params: dict, xc: torch.Tensor, psum, cut):
    """(r_gate, i_gate) of the conv output; on a mesh rank ``psum`` sums
    the products over the channels and ``cut`` keeps this rank's."""
    return cut(psum(xc @ params["w_r"])), cut(psum(xc @ params["w_i"]))


def _seq(params: dict, s0, x: torch.Tensor, cfg: ModelConfig, *,
         make_cache: bool, lengths, psum=_identity, cut=_identity,
         scan=None):
    """:func:`rglru_seq` on plain tensors (a mesh rank's channels)."""
    B, S, _ = x.shape
    xb = x @ params["in_x"]
    yb = _gelu(x @ params["in_y"])
    xc = _conv1d_causal(xb, params["conv_w"], params["conv_b"])
    r_gate, i_gate = _gates(params, xc, psum, cut)
    if lengths is not None:
        valid = torch.arange(S, device=x.device)[None, :, None] \
            < lengths.to(x.device)[:, None, None]
        r_gate = torch.where(valid, r_gate, torch.full(
            (), -1e9, dtype=r_gate.dtype, device=r_gate.device))
    h0 = None
    if s0 is not None:
        # (W,) shared prompt, or (B, W) per-row (multi-tenant gather). An
        # ungathered (n_slots, W) bank leaf with n_slots == B would pass
        # this guard undetected: serving stacked bank params without
        # adapter_ids is the caller's contract (the engine enforces it at
        # submit time).
        if s0.dim() == 2 and s0.shape[0] != B:
            raise ValueError(
                f"state0 {tuple(s0.shape)} is neither a shared (W,) prompt "
                f"nor a per-row (B={B}, W) gather: stacked bank leaves must "
                "be gathered by adapter_ids before reaching the layer")
        h0 = s0
    hs, hT = (scan or kops.rglru)(xc, r_gate, i_gate, params["a_param"],
                                  h0)
    out = psum((hs * yb) @ params["out"])
    cache = None
    if make_cache:
        K = cfg.hybrid.conv_width
        if lengths is None:
            conv_tail = xb[:, -(K - 1):] if S >= K - 1 else \
                F.pad(xb, (0, 0, K - 1 - S, 0))
        else:
            conv_tail = _ragged_conv_tail(xb, lengths, K)
        cache = {"h": hT, "conv": conv_tail.contiguous()}
    return out, cache


def rglru_decode(params: dict, adapters: Optional[dict], x: torch.Tensor,
                 cache: dict, cfg: ModelConfig):
    """Single-token step. x: (B, 1, d); cache: {'h': (B, W) f32, 'conv':
    (B, K-1, W)}. Returns (out, new cache); the cache passed in is not
    modified."""
    if dt.mesh_of(x, params["in_x"]) is not None:
        return _steps_mesh(params, x, cache, cfg, verify=False)
    return _decode(params, x, cache)


def _decode(params: dict, x: torch.Tensor, cache: dict, psum=_identity,
            cut=_identity):
    """:func:`rglru_decode` on plain tensors (a mesh rank's channels)."""
    xb = x @ params["in_x"]                                # (B, 1, W)
    yb = _gelu(x @ params["in_y"])
    conv_in = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_in.float(),
                      params["conv_w"].float()) + params["conv_b"].float()
    xc = xc.to(x.dtype)
    r_gate, i_gate = _gates(params, xc, psum, cut)
    y, h = kops.rglru_step(xc, r_gate, i_gate, params["a_param"],
                           cache["h"])
    out = psum((y[:, None] * yb) @ params["out"])
    return out, {"h": h, "conv": conv_in[:, 1:]}


def rglru_verify(params: dict, adapters: Optional[dict], x: torch.Tensor,
                 cache: dict, cfg: ModelConfig):
    """T chained single-token steps (the ``rglru_decode`` math) with a
    state snapshot per step, for speculative rollback. x: (B, T, d).
    Returns (y (B, T, d), snaps {'h': (B, T, W), 'conv': (B, T, K-1, W)});
    ``snaps[:, t]`` is the state after chunk offset t. The cache passed
    in is not modified."""
    if dt.mesh_of(x, params["in_x"]) is not None:
        return _steps_mesh(params, x, cache, cfg, verify=True)
    return _verify(lambda xt, c: _decode(params, xt, c), x, cache)


def rglru_cache_spec(cfg: ModelConfig, batch: int,
                     layers: Optional[int] = None) -> dict:
    L = layers if layers is not None else cfg.n_layers
    w, K = cfg.lru_width, cfg.hybrid.conv_width
    return {
        "h": ParamSpec((L, batch, w), torch.float32, (None, "batch", "lru"),
                       init="zeros"),
        "conv": ParamSpec((L, batch, K - 1, w), _dtype(cfg),
                          (None, "batch", "conv", "lru"), init="zeros"),
    }


# ---------------------------------------------------------------------------
# On a device mesh (serving): this rank's rows and channels
# ---------------------------------------------------------------------------

def _local_params(params: dict, cfg: ModelConfig, mesh):
    """This rank's channels of every weight (the gates' whole columns),
    gathered over the batch axes, and the channel split with its cut."""
    ch = dt.Channels(mesh, cfg.lru_width)
    w = ch.weight
    p = {"in_x": w(params["in_x"], 1), "in_y": w(params["in_y"], 1),
         "conv_w": w(params["conv_w"], 1), "conv_b": w(params["conv_b"], 0),
         "w_r": w(params["w_r"], 0), "w_i": w(params["w_i"], 0),
         "a_param": w(params["a_param"], 0), "out": w(params["out"], 0)}

    def cut(t):
        return t.narrow(-1, ch.lo, ch.n) if ch.split else t
    return p, ch, cut


def _seq_mesh(params, adapters, x, cfg, make_cache, lengths):
    mesh, rows, xl = mesh_rows(x)
    p, ch, cut = _local_params(params, cfg, mesh)
    s0 = local_state((adapters or {}).get("state0"), x, ch, 2)
    lens = None if lengths is None else dt.rows_of(lengths, x)

    def pl(cdim):
        return dt.with_model(rows, mesh, ch.placement(cdim))

    def scan(xc, r, i, a, h0):
        args = [dt.wrap(xc, mesh, pl(2)), dt.wrap(r, mesh, pl(2)),
                dt.wrap(i, mesh, pl(2)),
                dt.wrap(a, mesh, dt.with_model(dt.replicated(mesh), mesh,
                                               ch.placement(0)))]
        if h0 is not None:
            args.append(dt.wrap(h0, mesh, pl(1) if h0.dim() == 2 else
                                dt.with_model(dt.replicated(mesh), mesh,
                                              ch.placement(0))))
        hs, hT = kops.rglru(*args)
        return hs.to_local(), hT.to_local()

    out, cache = _seq(p, s0, xl, cfg, make_cache=make_cache, lengths=lens,
                      psum=ch.psum, cut=cut, scan=scan)
    if cache is not None:
        cache = {"h": dt.wrap(cache["h"], mesh, pl(1)),
                 "conv": dt.wrap(cache["conv"], mesh, pl(2))}
    return dt.wrap(out, mesh, rows), cache


def _steps_mesh(params, x, cache, cfg, *, verify: bool):
    """:func:`rglru_decode` or :func:`rglru_verify` on this rank's rows
    and channels (as ``ssm._steps_mesh``)."""
    mesh, rows, xl = mesh_rows(x)
    p, ch, cut = _local_params(params, cfg, mesh)

    def pl(cdim):
        return dt.with_model(rows, mesh, ch.placement(cdim))
    c = {"h": dt.local_as(cache["h"], pl(1)),
         "conv": dt.local_as(cache["conv"], pl(2))}

    def step(xt, c_):
        return _decode(p, xt, c_, ch.psum, cut)
    if not verify:
        out, new = step(xl, c)
        return dt.wrap(out, mesh, rows), {
            "h": dt.wrap(new["h"], mesh, pl(1)),
            "conv": dt.wrap(new["conv"], mesh, pl(2))}
    out, snaps = _verify(step, xl, c)
    return dt.wrap(out, mesh, rows), {
        "h": dt.wrap(snaps["h"], mesh, pl(2)),
        "conv": dt.wrap(snaps["conv"], mesh, pl(3))}
