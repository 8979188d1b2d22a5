"""Common layers (counterpart of ``repro/models/layers.py``): RMS norm,
rotary embeddings, SwiGLU MLP, token embedding, the f32 LM head and the
cross-entropy loss.

Each module has ``<mod>_spec(...) -> ParamSpec tree`` and a plain
``<mod>(params, x, ...)`` function on tensors. Math accumulates in f32;
weights stay in the config dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec

# vocab rows per chunk of the f32 LM head: the f32 copy of one chunk is
# UNEMBED_CHUNK * d_model * 4 bytes (235 MB at qwen2-7b's d_model 3584)
UNEMBED_CHUNK = 16384


def rmsnorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding in f32, cast back. x: (..., S, H, D); positions:
    broadcastable (..., S)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_spec(d: int, ff: int, dtype=torch.bfloat16) -> dict:
    return {
        "gate": ParamSpec((d, ff), dtype, init="scaled"),
        "up": ParamSpec((d, ff), dtype, init="scaled"),
        "down": ParamSpec((ff, d), dtype, init="scaled"),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def embed_spec(vocab: int, d: int, dtype=torch.bfloat16) -> dict:
    return {"table": ParamSpec((vocab, d), dtype)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 against a (vocab, d) table. The table is widened to
    f32 one chunk of ``UNEMBED_CHUNK`` rows at a time, so the f32 product
    never holds an f32 copy of the whole table (2.18 GB at qwen2-7b).
    Under autograd each chunk's f32 copy is kept for the backward of
    ``x``, so a training forward does hold the whole f32 table."""
    xf = x.float()
    table = params["table"]
    out = xf.new_empty((*x.shape[:-1], table.shape[0]))
    for c0 in range(0, table.shape[0], UNEMBED_CHUNK):
        c1 = min(c0 + UNEMBED_CHUNK, table.shape[0])
        out[..., c0:c1] = xf @ table[c0:c1].float().T
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL (``logsumexp - logit[label]``); with ``mask`` the
    masked mean over at least one token."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
