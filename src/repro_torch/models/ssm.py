"""Mamba-1 SSM block, the falcon-mamba family (counterpart of
``repro/models/ssm.py``).

The paper's per-layer prompt module has no attention analogue here: the
PEFT adaptation of an ssm layer is a learned initial state per layer
(``adapters['state0']``). The scan over a sequence goes through the
``selective_scan`` kernel (``kernels/ops.py``); a decode step is torch
operations, as the reference's is plain XLA.

The dtype flow is the reference's: ``dt_proj_b`` is f32 and is cast to the
activation dtype before the add, ``A = -exp(A_log)`` is f32, the causal
conv sums its taps in f32 and casts once, the state ``h`` stays f32 and the
conv tail is stored in the config dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def ssm_spec(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    ds, dc, dr = cfg.ssm.d_state, cfg.ssm.d_conv, cfg.dt_rank
    dt = _dtype(cfg)
    return {
        "in_proj": ParamSpec((d, 2 * di), dt, ("fsdp", "d_inner"),
                             init="scaled"),
        "conv_w": ParamSpec((dc, di), dt, ("conv", "d_inner"),
                            init="scaled"),
        "conv_b": ParamSpec((di,), dt, ("d_inner",), init="zeros"),
        "x_proj": ParamSpec((di, dr + 2 * ds), dt, ("d_inner", None),
                            init="scaled"),
        "dt_proj_w": ParamSpec((dr, di), dt, (None, "d_inner"),
                               init="scaled"),
        "dt_proj_b": ParamSpec((di,), torch.float32, ("d_inner",),
                               init="ones"),
        "A_log": ParamSpec((di, ds), torch.float32, ("d_inner", "state"),
                           init="ones"),
        "D": ParamSpec((di,), torch.float32, ("d_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), dt, ("d_inner", "fsdp"),
                              init="scaled"),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv from a zero state. x: (B, S, Di); w: (K, Di).
    The taps are summed in f32, then cast to x.dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):                                    # K = 4: unrolled
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """dt (softplus, x.dtype), A (f32), and B, C as views of the x_proj
    output."""
    dr, ds = cfg.dt_rank, cfg.ssm.d_state
    xdbc = x @ params["x_proj"]
    dt_r, Bm, C = xdbc[..., :dr], xdbc[..., dr:dr + ds], xdbc[..., dr + ds:]
    dt = F.softplus(dt_r @ params["dt_proj_w"]
                    + params["dt_proj_b"].to(dt_r.dtype))
    A = -torch.exp(params["A_log"])
    return dt, A, Bm, C


def _state0(adapters: Optional[dict], B: int):
    """The layer's initial state: None, a shared (Di, N) prompt, or a
    per-row (B, Di, N) gather of a bank's state prompts."""
    s0 = (adapters or {}).get("state0")
    if s0 is None:
        return None
    if s0.dim() == 3 and s0.shape[0] != B:
        raise ValueError(
            f"state0 {tuple(s0.shape)} is neither a shared (Di, N) prompt "
            f"nor a per-row (B={B}, Di, N) gather: stacked bank leaves must "
            "be gathered by adapter_ids before reaching the layer")
    return s0


def ssm_seq(params: dict, adapters: Optional[dict], x: torch.Tensor,
            cfg: ModelConfig, *, make_cache: bool = False,
            lengths: Optional[torch.Tensor] = None):
    """Full-sequence Mamba block. x: (B, S, d). Returns (y, cache or None).

    ``lengths`` (B,) marks ragged right-padded rows: padded columns get
    ``dt = 0``, so the recurrence is the identity there
    (``h = exp(0·A)·h + 0``) and the final state is bitwise the state after
    row b's last valid token. The conv cache tail is gathered per row from
    the last valid columns."""
    B, S, _ = x.shape
    di = cfg.d_inner
    xz = x @ params["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_conv1d_causal(xin, params["conv_w"], params["conv_b"]))
    dt, A, Bm, C = _ssm_inputs(params, xc, cfg)
    if lengths is not None:
        valid = torch.arange(S, device=x.device)[None, :] \
            < lengths.to(x.device)[:, None]
        dt = torch.where(valid[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                           device=dt.device))
    s0 = _state0(adapters, B)
    h0 = None if s0 is None else \
        (s0 if s0.dim() == 3 else s0[None].expand(B, *s0.shape))
    y, hT = kops.selective_scan(xc, dt, A, Bm, C, params["D"], h0)
    y = y * F.silu(z)
    out = y @ params["out_proj"]
    cache = None
    if make_cache:
        K = cfg.ssm.d_conv
        if lengths is None:
            conv_tail = xin[:, -(K - 1):] if S >= K - 1 else \
                F.pad(xin, (0, 0, K - 1 - S, 0))
        else:
            conv_tail = _ragged_conv_tail(xin, lengths, K)
        cache = {"h": hT, "conv": conv_tail.contiguous()}
    return out, cache


def _ragged_conv_tail(xin: torch.Tensor, lengths: torch.Tensor,
                      K: int) -> torch.Tensor:
    """Each row's last K-1 valid columns (zeros where the row is shorter).
    xin: (B, S, D); lengths: (B,). Returns (B, K-1, D), the conv state a
    solo run of row b would have cached."""
    S = xin.shape[1]
    idx = lengths.to(xin.device).long()[:, None] - (K - 1) \
        + torch.arange(K - 1, device=xin.device)[None]        # (B, K-1)
    tail = torch.gather(xin, 1, idx.clamp(0, S - 1)[..., None].expand(
        -1, -1, xin.shape[2]))
    return torch.where((idx >= 0)[..., None], tail,
                       torch.zeros((), dtype=xin.dtype, device=xin.device))


def ssm_decode(params: dict, adapters: Optional[dict], x: torch.Tensor,
               cache: dict, cfg: ModelConfig):
    """Single-token step. x: (B, 1, d); cache: {'h': (B, Di, N) f32,
    'conv': (B, K-1, Di)}. Returns (out, new cache); the cache passed in
    is not modified."""
    di = cfg.d_inner
    xz = x @ params["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]                   # (B, 1, Di)
    conv_in = torch.cat([cache["conv"].to(xin.dtype), xin], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_in.float(),
                      params["conv_w"].float()) \
        + params["conv_b"].float()
    xc = F.silu(xc).to(x.dtype)[:, None]                  # (B, 1, Di)
    dt, A, Bm, C = _ssm_inputs(params, xc, cfg)
    y, h = kops.selective_scan_step(xc[:, 0], dt[:, 0], A, Bm[:, 0],
                                    C[:, 0], params["D"], cache["h"])
    y = y[:, None] * F.silu(z)
    out = y @ params["out_proj"]
    return out, {"h": h, "conv": conv_in[:, 1:]}


def ssm_verify(params: dict, adapters: Optional[dict], x: torch.Tensor,
               cache: dict, cfg: ModelConfig):
    """T chained single-token steps (the ``ssm_decode`` math) with a state
    snapshot per step, for speculative rollback. x: (B, T, d). Returns
    (y (B, T, d), snaps {'h': (B, T, Di, N), 'conv': (B, T, K-1, Di)});
    ``snaps[:, t]`` is the state after chunk offset t. The cache passed
    in is not modified."""
    ys, hs, convs = [], [], []
    c = cache
    for t in range(x.shape[1]):
        y, c = ssm_decode(params, adapters, x[:, t:t + 1], c, cfg)
        ys.append(y)
        hs.append(c["h"])
        convs.append(c["conv"])
    return torch.cat(ys, 1), {"h": torch.stack(hs, 1),
                              "conv": torch.stack(convs, 1)}


def ssm_cache_spec(cfg: ModelConfig, batch: int,
                   layers: Optional[int] = None) -> dict:
    L = layers if layers is not None else cfg.n_layers
    di, ds, K = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    return {
        "h": ParamSpec((L, batch, di, ds), torch.float32,
                       (None, "batch", "d_inner", "state"), init="zeros"),
        "conv": ParamSpec((L, batch, K - 1, di), _dtype(cfg),
                          (None, "batch", "conv", "d_inner"), init="zeros"),
    }
