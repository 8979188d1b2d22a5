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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import _conv1d_causal, _dtype, _ragged_conv_tail


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
    B, S, _ = x.shape
    xb = x @ params["in_x"]
    yb = _gelu(x @ params["in_y"])
    xc = _conv1d_causal(xb, params["conv_w"], params["conv_b"])
    r_gate = xc @ params["w_r"]
    i_gate = xc @ params["w_i"]
    if lengths is not None:
        valid = torch.arange(S, device=x.device)[None, :, None] \
            < lengths.to(x.device)[:, None, None]
        r_gate = torch.where(valid, r_gate, torch.full(
            (), -1e9, dtype=r_gate.dtype, device=r_gate.device))
    h0 = None
    s0 = (adapters or {}).get("state0")
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
    hs, hT = kops.rglru(xc, r_gate, i_gate, params["a_param"], h0)
    out = (hs * yb) @ params["out"]
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
    xb = x @ params["in_x"]                                # (B, 1, W)
    yb = _gelu(x @ params["in_y"])
    conv_in = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_in.float(),
                      params["conv_w"].float()) + params["conv_b"].float()
    xc = xc.to(x.dtype)
    r_gate = xc @ params["w_r"]
    i_gate = xc @ params["w_i"]
    y, h = kops.rglru_step(xc, r_gate, i_gate, params["a_param"],
                           cache["h"])
    out = (y[:, None] * yb) @ params["out"]
    return out, {"h": h, "conv": conv_in[:, 1:]}


def rglru_verify(params: dict, adapters: Optional[dict], x: torch.Tensor,
                 cache: dict, cfg: ModelConfig):
    """T chained single-token steps (the ``rglru_decode`` math) with a
    state snapshot per step, for speculative rollback. x: (B, T, d).
    Returns (y (B, T, d), snaps {'h': (B, T, W), 'conv': (B, T, K-1, W)});
    ``snaps[:, t]`` is the state after chunk offset t. The cache passed
    in is not modified."""
    ys, hs, convs = [], [], []
    c = cache
    for t in range(x.shape[1]):
        y, c = rglru_decode(params, adapters, x[:, t:t + 1], c, cfg)
        ys.append(y)
        hs.append(c["h"])
        convs.append(c["conv"])
    return torch.cat(ys, 1), {"h": torch.stack(hs, 1),
                              "conv": torch.stack(convs, 1)}


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
