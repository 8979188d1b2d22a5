"""Public model API, dense family (counterpart of ``repro/models/model.py``):
spec, init, forward, the training losses (``lm_loss``, ``classify_loss``),
classify, prefill, decode and the serving primitives the engine drives.

Params split at the top level into ``backbone`` (frozen under the paper's
PEFT regime) and ``adapters`` (prefix-KV prompts, LoRA, classification
head), as in the reference; a layer group is a list of per-layer dicts.
Every entry point takes ``adapter_ids`` (B,) for multi-tenant serving from
AdapterBank params (``core/adapter_bank.py``), whose adapter leaves carry
a leading ``n_slots`` dim.
The reference's jitted fused functions (``_wave_prefill_fn``,
``_refill_fn``, ``_segment_fn``, ``_generate_fn``) are plain functions
here (:func:`wave_prefill`, :func:`refill`, :func:`segment`,
:func:`generate`): PyTorch runs eagerly. Decode updates the caches in
place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device, unported
from repro_torch.models.attention import param_dtype
from repro_torch.models.layers import (cross_entropy, embed, embed_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.models.params import ParamSpec, init_from_spec
from repro_torch.models.transformer import (adapter_stack_spec,
                                            cache_group_spec, stack_decode,
                                            stack_seq, stack_spec)


def backbone_spec(cfg: ModelConfig) -> dict:
    dt = param_dtype(cfg)
    s: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
               "final_norm": rmsnorm_spec(cfg.d_model),
               "layers": stack_spec(cfg)}
    if not cfg.tie_embeddings:
        s["lm_head"] = embed_spec(cfg.vocab_size, cfg.d_model, dt)
    return s


def adapter_spec(cfg: ModelConfig) -> dict:
    a: dict = {"stack": adapter_stack_spec(cfg)}
    if cfg.peft.head_dim_out:
        a["head"] = {
            "w": ParamSpec((cfg.d_model, cfg.peft.head_dim_out),
                           torch.float32, init="scaled"),
            "b": ParamSpec((cfg.peft.head_dim_out,), torch.float32,
                           init="zeros"),
        }
    return a


def model_spec(cfg: ModelConfig) -> dict:
    return {"backbone": backbone_spec(cfg), "adapters": adapter_spec(cfg)}


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random params from ``torch.Generator(device).manual_seed(seed)``,
    made on ``device`` (``cuda`` unless the caller passes ``"cpu"``) one
    leaf at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return init_from_spec(gen, model_spec(cfg), dev)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    return cache_group_spec(cfg, batch, seq_len)


def _head(params: dict) -> dict:
    return params["backbone"].get("lm_head", params["backbone"]["embed"])


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token embedding. Returns (x, positions)."""
    extra = set(batch) - {"tokens", "labels"}
    if extra:
        raise unported(f"modality extras {sorted(extra)}",
                       "later, remaining families")
    tokens = batch["tokens"]
    x = embed(params["backbone"]["embed"], tokens.long())
    return x, torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)


def _hidden(params: dict, batch: dict, cfg: ModelConfig, adapter_ids,
            remat: bool = False):
    """Final-normed hidden states (B, S, d) and the aux loss."""
    adapters = params.get("adapters", {}).get("stack", {})
    x, positions = _embed_inputs(params, batch, cfg)
    x, _, aux = stack_seq(params["backbone"]["layers"], adapters, x, cfg,
                          positions=positions, remat=remat,
                          adapter_ids=adapter_ids)
    return rmsnorm(params["backbone"]["final_norm"], x), aux


def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "train", remat: Optional[bool] = None,
            adapter_ids: Optional[torch.Tensor] = None) -> dict:
    """Full-sequence forward. Returns {'hidden', 'logits', 'aux'}.

    ``remat`` (default: ``mode == "train"``, as in the reference)
    re-materialises each layer's forward in the backward. ``adapter_ids``
    (B,) enables multi-tenant serving: the adapter leaves carry a leading
    ``n_slots`` dim (the AdapterBank layout) and each batch row computes
    with its own domain's adapters."""
    remat = (mode == "train") if remat is None else remat
    x, aux = _hidden(params, batch, cfg, adapter_ids, remat)
    return {"hidden": x, "logits": unembed(_head(params), x), "aux": aux}


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            remat: Optional[bool] = None) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (+ the aux loss); batch {'tokens',
    'labels'} (B, S)."""
    out = forward(params, {"tokens": batch["tokens"]}, cfg, mode="train",
                  remat=remat)
    loss = cross_entropy(out["logits"], batch["labels"]) + out["aux"]
    return loss, {"aux": out["aux"]}


def classify(params: dict, batch: dict, cfg: ModelConfig, *,
             adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper case-study head: mean-pooled hidden states (f32) -> adapter
    head logits (B, out). With ``adapter_ids`` the head is the bank's
    slot-leading (n_slots, d, out) stack and each row is scored by its own
    domain's head (mixed-domain accuracy in one call)."""
    x, _ = _hidden(params, {"tokens": batch["tokens"]}, cfg, adapter_ids)
    pooled = x.float().mean(dim=1)
    h = params["adapters"]["head"]
    if adapter_ids is not None:
        ids = adapter_ids.to(device=pooled.device, dtype=torch.long)
        w = h["w"].index_select(0, ids)                # (B, d, out)
        b = h["b"].index_select(0, ids)                # (B, out)
        return torch.einsum("bd,bdo->bo", pooled, w) + b
    return pooled @ h["w"] + h["b"]


def classify_loss(params: dict, batch: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, dict]:
    """Cross entropy of :func:`classify` against batch['label'] (B,), and
    the batch accuracy."""
    logits = classify(params, batch, cfg)
    label = batch["label"].long()
    loss = cross_entropy(logits, label)
    acc = (logits.argmax(-1) == label).float().mean()
    return loss, {"acc": acc}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            max_len: Optional[int] = None,
            prompt_lens: Optional[torch.Tensor] = None,
            adapter_ids: Optional[torch.Tensor] = None):
    """Run the prompt and build caches padded to ``max_len``.

    ``prompt_lens`` (B,) serves a ragged wave: row b's valid tokens are
    ``tokens[b, :prompt_lens[b]]``, its cache positions past that carry the
    sentinel, and its logits are those of its own last valid token.
    ``adapter_ids`` (B,) serves a multi-tenant wave (see :func:`forward`).
    Returns ((B, 1, vocab) f32 last-token logits, caches)."""
    adapters = params.get("adapters", {}).get("stack", {})
    x, positions = _embed_inputs(params, batch, cfg)
    x, caches, _ = stack_seq(params["backbone"]["layers"], adapters, x, cfg,
                             positions=positions, make_cache=True,
                             cache_len=max_len, lengths=prompt_lens,
                             adapter_ids=adapter_ids)
    if prompt_lens is None:
        x = x[:, -1:]
    else:                                  # per-row last VALID token
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, prompt_lens.long() - 1][:, None]
    x = rmsnorm(params["backbone"]["final_norm"], x)
    return unembed(_head(params), x), caches


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                pos: torch.Tensor, cfg: ModelConfig,
                active: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None):
    """One token. token: (B, 1) int; pos: scalar or (B,) int (current
    position); ``active`` (B,) bool freezes retired rows' caches;
    ``adapter_ids`` (B,) picks each row's bank slot. The caches are
    updated in place. Returns ((B, 1, vocab) logits, caches)."""
    adapters = params.get("adapters", {}).get("stack", {})
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).to(torch.int64).expand(B)
    x = embed(params["backbone"]["embed"], token.long())
    x, caches = stack_decode(params["backbone"]["layers"], adapters, x,
                             caches, cfg, pos=pos, active=active,
                             adapter_ids=adapter_ids)
    x = rmsnorm(params["backbone"]["final_norm"], x)
    return unembed(_head(params), x), caches


def _next_token(logits: torch.Tensor, greedy: bool,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, 1) int32 next tokens from (B, vocab) logits."""
    if greedy:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def _decode_steps(params: dict, cfg: ModelConfig, steps: int, greedy: bool,
                  tok, caches, pos, remaining,
                  gen: Optional[torch.Generator] = None, adapter_ids=None):
    """``steps`` decode steps with per-row positions and retirement (the
    reference's ``_scan_steps``). Each step emits the carried token, then
    computes the next. Rows with ``remaining <= 0`` are retired: their
    cache writes are dropped and their position and carried token freeze.
    Returns (toks (B, steps), (tok, caches, pos, remaining))."""
    out = []
    for _ in range(steps):
        active = remaining > 0
        logits, caches = decode_step(params, tok, caches, pos, cfg,
                                     active=active, adapter_ids=adapter_ids)
        nxt = _next_token(logits[:, -1], greedy, gen)
        out.append(tok)
        tok = torch.where(active[:, None], nxt, tok)
        pos = pos + active.to(pos.dtype)
        remaining = remaining - active.to(remaining.dtype)
    return torch.cat(out, dim=1), (tok, caches, pos, remaining)


def _prefill_state(params: dict, batch: dict, cfg: ModelConfig, cap: int,
                   prompt_lens, adapter_ids=None):
    """Prefill -> (tok0 (B, 1) int32, caches, pos0 (B,) int32)."""
    tokens = batch["tokens"]
    logits, caches = prefill(params, batch, cfg, max_len=cap,
                             prompt_lens=prompt_lens,
                             adapter_ids=adapter_ids)
    tok0 = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
    B, S = tokens.shape
    if prompt_lens is None:
        pos0 = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    else:
        pos0 = prompt_lens.to(torch.int32)
    return tok0, caches, pos0


@torch.no_grad()
def wave_prefill(params: dict, cfg: ModelConfig, cap: int, batch: dict,
                 prompt_lens: torch.Tensor, adapter_ids=None):
    """Ragged wave prefill: batch + prompt_lens -> decode state (the
    reference's ``_wave_prefill_fn``); ``adapter_ids`` (B,) one bank slot
    per row."""
    return _prefill_state(params, batch, cfg, cap, prompt_lens, adapter_ids)


@torch.no_grad()
def refill(params: dict, cfg: ModelConfig, cap: int, batch: dict,
           prompt_lens: torch.Tensor, row_idx, tok, caches: dict, pos,
           adapter_ids=None):
    """In-wave slot refill (the reference's ``_refill_fn``): prefill only
    the admitted rows and write them into the live wave at their slots.

    ``row_idx`` (host ints) maps each batch row to its wave slot; a pad row
    carries an index >= the wave width and is dropped. Every cache leaf has
    batch at dim 1, so the merge is one row write per leaf; the other
    rows' state is untouched. ``adapter_ids`` (one per batch row, pad rows
    included) picks the admitted rows' bank slots. ``tok``, ``caches`` and
    ``pos`` are updated in place and returned."""
    tok_n, caches_n, pos_n = _prefill_state(params, batch, cfg, cap,
                                            prompt_lens, adapter_ids)
    B = tok.shape[0]
    pairs = [(r, int(i)) for r, i in enumerate(np.asarray(row_idx)) if i < B]
    src = torch.tensor([r for r, _ in pairs], device=tok.device)
    dst = torch.tensor([i for _, i in pairs], device=tok.device)
    for g, grp in caches.items():
        for s, sub in grp.items():
            for leaf, old in sub.items():
                old[:, dst] = caches_n[g][s][leaf][:, src].to(old.dtype)
    tok[dst] = tok_n[src]
    pos[dst] = pos_n[src]
    return tok, caches, pos


@torch.no_grad()
def segment(params: dict, cfg: ModelConfig, steps: int, greedy: bool, tok,
            caches: dict, pos, remaining,
            gen: Optional[torch.Generator] = None, adapter_ids=None):
    """A decode segment of ``steps`` steps of a ragged wave (the
    reference's ``_segment_fn``); ``adapter_ids`` (B,) one bank slot per
    wave row. Returns (toks, tok, caches, pos, remaining)."""
    toks, (tok, caches, pos, remaining) = _decode_steps(
        params, cfg, steps, greedy, tok, caches, pos, remaining, gen,
        adapter_ids)
    return toks, tok, caches, pos, remaining


@torch.no_grad()
def generate(params: dict, cfg: ModelConfig, prompts: torch.Tensor, *,
             gen: int, greedy: bool = True,
             generator: Optional[torch.Generator] = None,
             prompt_lens: Optional[torch.Tensor] = None,
             adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill + ``gen`` decode steps (the reference's ``generate_scan``).

    prompts: (B, S) int. Returns (B, gen) int32 tokens; the first is the
    prefill argmax. ``prompt_lens`` (B,) serves a ragged wave: prompts are
    right-padded and row b generates from position ``prompt_lens[b]``,
    token for token as if served alone. ``adapter_ids`` (B,) serves a
    multi-tenant wave from AdapterBank params: row b generates with slot
    ``adapter_ids[b]``, token for token as if served alone with that
    slot's adapters. Sampling (``greedy=False``) draws from
    ``generator``."""
    S = prompts.shape[1]
    lens = None if prompt_lens is None else \
        torch.as_tensor(prompt_lens, device=prompts.device).to(torch.int32)
    ids = None if adapter_ids is None else \
        torch.as_tensor(adapter_ids, device=prompts.device).to(torch.int32)
    tok0, caches, pos0 = _prefill_state(params, {"tokens": prompts}, cfg,
                                        S + gen, lens, ids)
    remaining = torch.full((prompts.shape[0],), gen, dtype=torch.int32,
                           device=prompts.device)
    toks, _ = _decode_steps(params, cfg, gen, greedy, tok0, caches, pos0,
                            remaining, generator, ids)
    return toks
