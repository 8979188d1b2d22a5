"""Model FLOPs from a configuration's ``sizes``, the same whatever
implements them: two a multiply-accumulate of every product a token
needs (the active experts' only, the adapters' included, biases and
norms left out), attention's two products over the keys the token sees
(its prefix slots included), the output head once for every token whose
logits are used. No recomputation, no padded row, no expert row beyond
the routed ones."""
from __future__ import annotations

PEAK_BF16 = 989e12          # NVIDIA H100 SXM, dense bf16 (lib/costs.py)


def layer_params(sz: dict) -> int:
    """Weights one token multiplies through in one layer."""
    d, nh, nkv, hd = sz["d_model"], sz["n_heads"], sz["n_kv_heads"], \
        sz["head_dim"]
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    out = {"q": nh * hd, "k": nkv * hd, "v": nkv * hd, "o": d}
    lora = sum(sz["lora_rank"] * ((nh * hd if t == "o" else d) + out[t])
               for t in sz["lora_targets"])
    if sz.get("n_experts"):
        ffn = sz["top_k"] * 3 * d * sz["d_ff_expert"] + d * sz["n_experts"]
    else:
        ffn = 3 * d * sz["d_ff"]
    return attn + lora + ffn


def token_flops(sz: dict, keys: int, head: bool) -> float:
    """One token's forward FLOPs through every layer, seeing ``keys``
    keys in each (its prefix slots included), with the output head if its
    logits are used."""
    L = sz["n_layers"]
    f = 2.0 * L * layer_params(sz) \
        + 4.0 * L * sz["head_dim"] * sz["n_heads"] * keys
    return f + (2.0 * sz["d_model"] * sz["vocab_size"] if head else 0.0)


def prefill_flops(sz: dict, prompt: int) -> float:
    """A prompt of ``prompt`` tokens: each sees itself, those before it
    and the prefix slots; the head on the last only."""
    L, n_p = sz["n_layers"], sz["n_prefix"]
    keys = prompt * (prompt + 1) // 2 + prompt * n_p
    return 2.0 * L * layer_params(sz) * prompt \
        + 4.0 * L * sz["head_dim"] * sz["n_heads"] * keys \
        + 2.0 * sz["d_model"] * sz["vocab_size"]


def decode_flops(sz: dict, prompt: int, n_out: int) -> float:
    """The decode steps that produced tokens 2..n_out of a request whose
    first token came from its prefill: token j (from 0) at position
    ``prompt + j`` sees ``prompt + j + 1`` keys and the prefix."""
    steps = max(n_out - 1, 0)
    if not steps:
        return 0.0
    L, n_p = sz["n_layers"], sz["n_prefix"]
    keys = steps * (prompt + 1 + n_p) + steps * (steps - 1) // 2
    return (2.0 * L * layer_params(sz) + 2.0 * sz["d_model"]
            * sz["vocab_size"]) * steps \
        + 4.0 * L * sz["head_dim"] * sz["n_heads"] * keys
