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

On a device mesh (serving) each rank runs its rows (`batch` on `data`)
and its channels (``d_inner`` on `model`, where they divide): the conv,
the ``dt`` projection and the scan keep the channels apart, while
``x_proj`` and ``out_proj`` contract them, so their products are summed
over the `model` ranks (:class:`~repro_torch.sharding.dtensor.Channels`).
``in_proj``'s columns are ``[x | z]``, so its `model` split is not a
channel split: it is gathered whole and sliced. The caches keep
``cache_spec``'s placements: ``h`` (batch, d_inner, state) and ``conv``
(batch, conv, d_inner).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import dtensor as dt


def _identity(t):
    return t


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


def _ssm_inputs(params: dict, x: torch.Tensor, cfg: ModelConfig,
                psum=_identity):
    """dt (softplus, x.dtype), A (f32), and B, C as views of the x_proj
    output (``psum`` sums it over the ranks that hold the other
    channels)."""
    dr, ds = cfg.dt_rank, cfg.ssm.d_state
    xdbc = psum(x @ params["x_proj"])
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


def _in_proj(params: dict, x: torch.Tensor, di: int):
    """(xin, z): ``x @ in_proj`` split into its two halves (on a mesh
    rank, the halves' columns of this rank's channels)."""
    if "in_proj" in params:
        xz = x @ params["in_proj"]
        return xz[..., :di], xz[..., di:]
    return x @ params["in_x"], x @ params["in_z"]


def ssm_seq(params: dict, adapters: Optional[dict], x: torch.Tensor,
            cfg: ModelConfig, *, make_cache: bool = False,
            lengths: Optional[torch.Tensor] = None):
    """Full-sequence Mamba block. x: (B, S, d). Returns (y, cache or None).

    ``lengths`` (B,) marks ragged right-padded rows: padded columns get
    ``dt = 0``, so the recurrence is the identity there
    (``h = exp(0·A)·h + 0``) and the final state is bitwise the state after
    row b's last valid token. The conv cache tail is gathered per row from
    the last valid columns."""
    if dt.mesh_of(x, params["in_proj"]) is not None:
        return _seq_mesh(params, adapters, x, cfg, make_cache, lengths)
    return _seq(params, _state0(adapters, x.shape[0]), x, cfg, cfg.d_inner,
                make_cache=make_cache, lengths=lengths)


def _seq(params: dict, s0, x: torch.Tensor, cfg: ModelConfig, di: int, *,
         make_cache: bool, lengths, psum=_identity, scan=None):
    """:func:`ssm_seq` over ``di`` channels of plain tensors."""
    B, S, _ = x.shape
    xin, z = _in_proj(params, x, di)
    xc = F.silu(_conv1d_causal(xin, params["conv_w"], params["conv_b"]))
    dt_, A, Bm, C = _ssm_inputs(params, xc, cfg, psum)
    if lengths is not None:
        valid = torch.arange(S, device=x.device)[None, :] \
            < lengths.to(x.device)[:, None]
        dt_ = torch.where(valid[..., None], dt_, torch.zeros(
            (), dtype=dt_.dtype, device=dt_.device))
    h0 = None if s0 is None else \
        (s0 if s0.dim() == 3 else s0[None].expand(B, *s0.shape))
    y, hT = (scan or kops.selective_scan)(xc, dt_, A, Bm, C, params["D"],
                                          h0)
    y = y * F.silu(z)
    out = psum(y @ params["out_proj"])
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
    if dt.mesh_of(x, params["in_proj"]) is not None:
        return _steps_mesh(params, x, cache, cfg, verify=False)
    return _decode(params, x, cache, cfg, cfg.d_inner)


def _decode(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
            di: int, psum=_identity):
    """:func:`ssm_decode` over ``di`` channels of plain tensors."""
    xin, z = _in_proj(params, x, di)                      # (B, 1, Di)
    conv_in = torch.cat([cache["conv"].to(xin.dtype), xin], dim=1)
    xc = torch.einsum("bkd,kd->bd", conv_in.float(),
                      params["conv_w"].float()) \
        + params["conv_b"].float()
    xc = F.silu(xc).to(x.dtype)[:, None]                  # (B, 1, Di)
    dt_, A, Bm, C = _ssm_inputs(params, xc, cfg, psum)
    y, h = kops.selective_scan_step(xc[:, 0], dt_[:, 0], A, Bm[:, 0],
                                    C[:, 0], params["D"], cache["h"])
    y = y[:, None] * F.silu(z)
    out = psum(y @ params["out_proj"])
    return out, {"h": h, "conv": conv_in[:, 1:]}


def ssm_verify(params: dict, adapters: Optional[dict], x: torch.Tensor,
               cache: dict, cfg: ModelConfig):
    """T chained single-token steps (the ``ssm_decode`` math) with a state
    snapshot per step, for speculative rollback. x: (B, T, d). Returns
    (y (B, T, d), snaps {'h': (B, T, Di, N), 'conv': (B, T, K-1, Di)});
    ``snaps[:, t]`` is the state after chunk offset t. The cache passed
    in is not modified."""
    if dt.mesh_of(x, params["in_proj"]) is not None:
        return _steps_mesh(params, x, cache, cfg, verify=True)
    return _verify(lambda xt, c: _decode(params, xt, c, cfg, cfg.d_inner),
                   x, cache)


def _verify(step, x: torch.Tensor, cache: dict):
    """Chain ``step(x_t, cache) -> (y, cache)`` over x's T tokens; the
    outputs and every step's state stacked at dim 1."""
    ys, hs, convs = [], [], []
    c = cache
    for t in range(x.shape[1]):
        y, c = step(x[:, t:t + 1], c)
        ys.append(y)
        hs.append(c["h"])
        convs.append(c["conv"])
    return torch.cat(ys, 1), {"h": torch.stack(hs, 1),
                              "conv": torch.stack(convs, 1)}


# ---------------------------------------------------------------------------
# On a device mesh (serving): this rank's rows and channels
# ---------------------------------------------------------------------------

def _local_params(params: dict, cfg: ModelConfig, mesh):
    """This rank's channels of every weight, gathered over the batch axes
    (their FSDP split), and the :class:`~dt.Channels` split."""
    ch = dt.Channels(mesh, cfg.d_inner)
    w = ch.weight
    p = {"conv_w": w(params["conv_w"], 1), "conv_b": w(params["conv_b"], 0),
         "x_proj": w(params["x_proj"], 0),
         "dt_proj_w": w(params["dt_proj_w"], 1),
         "dt_proj_b": w(params["dt_proj_b"], 0),
         "A_log": w(params["A_log"], 0), "D": w(params["D"], 0),
         "out_proj": w(params["out_proj"], 0)}
    whole = dt.local_as(params["in_proj"], dt.replicated(mesh))
    if ch.split:
        di, lo, n = cfg.d_inner, ch.lo, ch.n
        p["in_x"], p["in_z"] = whole[:, lo:lo + n], \
            whole[:, di + lo:di + lo + n]
    else:
        p["in_proj"] = whole
    return p, ch


def local_state(s0, x, ch, per_row_dims: int):
    """This rank's part of a state prompt ``s0`` (a shared prompt, or
    per-row with ``per_row_dims`` dims, rows like ``x``'s), channels at
    its last dim but one (ssm) or last (hybrid)."""
    if s0 is None:
        return None
    per_row = s0.dim() == per_row_dims
    cdim = 1 if per_row else 0
    if dt.is_dt(s0):
        rows = dt.row_placements(x, ch.mesh) if per_row \
            else dt.replicated(ch.mesh)
        return dt.local_as(s0, dt.with_model(rows, ch.mesh,
                                             ch.placement(cdim)))
    s = dt.rows_of(s0, x) if per_row else s0
    return s.narrow(cdim, ch.lo, ch.n)


def mesh_rows(x):
    """(mesh, placements of x's rows with `model` replicated, local x)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    rows = dt.with_model(dt.row_placements(x, mesh), mesh, Replicate())
    return mesh, rows, dt.local_as(x, rows)


def _seq_mesh(params, adapters, x, cfg, make_cache, lengths):
    mesh, rows, xl = mesh_rows(x)
    p, ch = _local_params(params, cfg, mesh)
    s0 = local_state(_state0(adapters, x.shape[0]), x, ch, 3)
    lens = None if lengths is None else dt.rows_of(lengths, x)

    def pl(cdim):                     # rows as x's, channels at cdim
        return dt.with_model(rows, mesh, ch.placement(cdim))

    def scan(xc, dt_, A, Bm, C, D, h0):
        rep = dt.replicated(mesh)
        args = [dt.wrap(xc, mesh, pl(2)), dt.wrap(dt_, mesh, pl(2)),
                dt.wrap(A, mesh, dt.with_model(rep, mesh, ch.placement(0))),
                dt.wrap(Bm, mesh, rows), dt.wrap(C, mesh, rows),
                dt.wrap(D, mesh, dt.with_model(rep, mesh, ch.placement(0)))]
        if h0 is not None:
            args.append(dt.wrap(h0, mesh, pl(1)))
        y, hT = kops.selective_scan(*args)
        return y.to_local(), hT.to_local()

    out, cache = _seq(p, s0, xl, cfg, ch.n, make_cache=make_cache,
                      lengths=lens, psum=ch.psum, scan=scan)
    if cache is not None:
        cache = {"h": dt.wrap(cache["h"], mesh, pl(1)),
                 "conv": dt.wrap(cache["conv"], mesh, pl(2))}
    return dt.wrap(out, mesh, rows), cache


def _steps_mesh(params, x, cache, cfg, *, verify: bool):
    """:func:`ssm_decode` (one token) or :func:`ssm_verify` (a chunk) on
    this rank's rows and channels; the new state keeps the cache's
    placements, a step axis at dim 1 for verify's snapshots."""
    mesh, rows, xl = mesh_rows(x)
    p, ch = _local_params(params, cfg, mesh)

    def pl(cdim):
        return dt.with_model(rows, mesh, ch.placement(cdim))
    c = {"h": dt.local_as(cache["h"], pl(1)),
         "conv": dt.local_as(cache["conv"], pl(2))}

    def step(xt, c_):
        return _decode(p, xt, c_, cfg, ch.n, ch.psum)
    if not verify:
        out, new = step(xl, c)
        return dt.wrap(out, mesh, rows), {
            "h": dt.wrap(new["h"], mesh, pl(1)),
            "conv": dt.wrap(new["conv"], mesh, pl(2))}
    out, snaps = _verify(step, xl, c)
    return dt.wrap(out, mesh, rows), {
        "h": dt.wrap(snaps["h"], mesh, pl(2)),
        "conv": dt.wrap(snaps["conv"], mesh, pl(3))}


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
