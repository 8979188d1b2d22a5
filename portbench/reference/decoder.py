"""Plain reference of a decoder-only transformer, dense or mixture of
experts, with per-tenant adapters (prefix key/value slots, LoRA on the
query and value projections): the forward pass of one sequence, in
float32 with TF32 off, layer by layer, no cache, no batching, no kernel.

It follows the published descriptions of the configurations it runs
(Qwen2, arXiv:2407.10671: GQA with bias on q, k and v, rotary embeddings
(the rotate-half form, frequencies ``theta^(-i / (D/2))``), RMS norm
before attention and before the SwiGLU MLP, an untied output head;
Granite 3.0 MoE: the same attention, a router softmax over all experts,
the top k kept and renormalised, dropless, each a SwiGLU expert, tied
embeddings) and the paper's adapters (prefix slots at position -1, seen
by every query, without a rotary phase; LoRA ``x A B alpha / r``).
Departure, as in the program: Granite's four scaling multipliers
(embedding, attention, residual, logits) are not applied.

``sizes`` is the ``sizes`` block of a configuration file. ``params`` is
the weight tree the benchmark made (names as the program takes them:
``embed``, ``final_norm``, ``layers`` / ``g0`` / [layer] / ``s0`` /
``ln1`` ``attn`` ``ln2`` ``mlp`` | ``moe``, ``lm_head``); ``adapters`` a
domain's tree (``stack`` / ``g0`` / [layer] / ``s0`` / ``prefix``,
``lora``).

``precision="fp8"`` is the control: every product's weight (per output
column) and input (per row) rounded to float8 e4m3 first, the router
kept in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (f32) rounded to e4m3 with one scale per slice along
    ``dim`` reduced (its amax mapped to the format's largest value)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) f32 times w (K, N), widened to f32."""
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions pos (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos.double()[:, None] * freq)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _proj(x, p, w, b, lora, alpha_r, precision):
    y = _mm(x, p[w], precision)
    if b is not None and b in p:
        y = y + p[b].float()
    if lora is not None:
        y = y + alpha_r * _mm(_mm(x, lora["a"], precision), lora["b"],
                              precision)
    return y


def attention(x, p, a, sz, precision):
    """One attention block over a whole sequence x (S, d)."""
    S = x.shape[0]
    nh, nkv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    lora = (a or {}).get("lora", {})
    ar = sz["lora_alpha"] / sz["lora_rank"]
    q = _proj(x, p, "wq", "bq", lora.get("q"), ar, precision)
    k = _proj(x, p, "wk", "bk", lora.get("k"), ar, precision)
    v = _proj(x, p, "wv", "bv", lora.get("v"), ar, precision)
    pos = torch.arange(S, device=x.device)
    q = rope(q.view(S, nh, hd), pos, sz["rope_theta"])
    k = rope(k.view(S, nkv, hd), pos, sz["rope_theta"])
    v = v.view(S, nkv, hd)
    pre = (a or {}).get("prefix")
    n_p = 0
    if pre is not None:
        n_p = pre["k"].shape[0]
        k = torch.cat([pre["k"].float(), k], 0)
        v = torch.cat([pre["v"].float(), v], 0)
    g = nh // nkv
    k = k.repeat_interleave(g, dim=1)                  # (T, nh, hd)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) * hd ** -0.5
    kpos = torch.cat([torch.full((n_p,), -1, device=x.device), pos])
    vis = (kpos[None, :] <= pos[:, None]) | (kpos[None, :] < 0)
    scores = scores.masked_fill(~vis[None], float("-inf"))
    o = torch.einsum("hst,thd->shd", torch.softmax(scores, -1), v)
    return _proj(o.reshape(S, nh * hd), p, "wo", None, lora.get("o"), ar,
                 precision)


def mlp(x, p, precision):
    h = F.silu(_mm(x, p["gate"], precision)) * _mm(x, p["up"], precision)
    return _mm(h, p["down"], precision)


def moe(x, p, sz, precision):
    """Dropless top-k routing: every token's k experts run."""
    E, k = sz["n_experts"], sz["top_k"]
    probs = torch.softmax(x @ p["router"].float(), -1)             # (S, E)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :k], e[:, :k]
    w = w / w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for j in range(E):
        rows, slot = torch.nonzero(e == j, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(_mm(xe, p["gate"][j], precision)) \
            * _mm(xe, p["up"][j], precision)
        y.index_add_(0, rows, w[rows, slot][:, None]
                     * _mm(h, p["down"][j], precision))
    return y


def logits(params: dict, adapters: dict, sz: dict, tokens: torch.Tensor,
           first: int, precision: str = "f32") -> torch.Tensor:
    """Float32 logits (S - first, vocab) at positions ``first`` .. S-1 of
    the sequence ``tokens`` (S,), with one domain's ``adapters``."""
    no_tf32()
    eps = sz["rms_norm_eps"]
    x = params["embed"]["table"][tokens.long()].float()
    stack = adapters.get("stack", {})
    for name, layers in params["layers"].items():
        for li, lp in enumerate(layers):
            la = stack.get(name, [{}] * len(layers))[li]
            for key, p in lp.items():
                a = la.get(key, {})
                x = x + attention(rmsnorm(x, p["ln1"]["scale"], eps),
                                  p["attn"], a, sz, precision)
                h = rmsnorm(x, p["ln2"]["scale"], eps)
                x = x + (moe(h, p["moe"], sz, precision) if "moe" in p
                         else mlp(h, p["mlp"], precision))
    x = rmsnorm(x[first:], params["final_norm"]["scale"], eps)
    head = params.get("lm_head", params["embed"])["table"]
    return _mm(x, head.t(), precision)
