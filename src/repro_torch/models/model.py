"""Public model API, every family (counterpart of
``repro/models/model.py``): spec, init, forward, the training losses
(``lm_loss``, ``classify_loss``), classify, prefill, decode, the
speculative verify pass and the serving primitives the engine drives.

Modality inputs ride the batch beside ``tokens``, as in the reference: a
vlm batch carries ``vision_embeds`` (B, n_vis, d_model), the (stubbed)
vision tower's rows, which prefix the text embeddings (positions 0 to
n_vis - 1; the text and the decode steps follow); an audio batch carries
``frames`` (B, n_frames, d_model), which the encoder of
``models/encdec.py`` consumes, and the decoder cross-attends its states.

Params split at the top level into ``backbone`` (frozen under the paper's
PEFT regime) and ``adapters`` (prefix-KV prompts, LoRA, classification
head), as in the reference; a layer group is a list of per-layer dicts.
Every entry point takes ``adapter_ids`` (B,) for multi-tenant serving from
AdapterBank params (``core/adapter_bank.py``), whose adapter leaves carry
a leading ``n_slots`` dim.
The reference's jitted fused functions (``_wave_prefill_fn``,
``_refill_fn``, ``_segment_fn``, ``_generate_fn``, the paged
``_paged_prefill_fn``, ``_paged_refill_fn``, ``_paged_suffix_fn`` and the
speculative ``_draft_fn``, ``_verify_fn``, ``_spec_segment_fn``) are plain
functions here (:func:`wave_prefill`, :func:`refill`, :func:`segment`,
:func:`generate`, :func:`paged_wave_prefill`, :func:`paged_refill`,
:func:`paged_suffix`, :func:`draft`, :func:`verify`,
:func:`spec_segment`): PyTorch runs eagerly. Decode and verify update the
caches in place, and a paged cache's block pool is the engine's persistent
pool itself.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import telemetry
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.attention import paged_write, param_dtype
from repro_torch.models.layers import (cross_entropy, embed, embed_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.models.params import ParamSpec, init_from_spec
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.rules import shard
from repro_torch.models.transformer import (adapter_stack_spec,
                                            cache_group_spec, paged_subs,
                                            rec_cache_part, stack_chunk,
                                            stack_decode, stack_seq,
                                            stack_spec, stack_verify)


def backbone_spec(cfg: ModelConfig) -> dict:
    dt = param_dtype(cfg)
    s: dict = {"embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
               "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.family == "audio":
        s["encdec"] = encdec.encdec_stack_spec(cfg)
    else:
        s["layers"] = stack_spec(cfg)
    if not cfg.tie_embeddings:
        s["lm_head"] = embed_spec(cfg.vocab_size, cfg.d_model, dt)
    return s


def adapter_spec(cfg: ModelConfig) -> dict:
    a: dict = {"stack": encdec.encdec_adapter_spec(cfg)
               if cfg.family == "audio" else adapter_stack_spec(cfg)}
    if cfg.peft.head_dim_out:
        a["head"] = {
            "w": ParamSpec((cfg.d_model, cfg.peft.head_dim_out),
                           torch.float32, ("fsdp", None), init="scaled"),
            "b": ParamSpec((cfg.peft.head_dim_out,), torch.float32,
                           (None,), init="zeros"),
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


def place_params(params: dict, cfg: ModelConfig, mesh,
                 rules: Optional[dict] = None) -> dict:
    """Lay a {backbone, adapters} tree out on ``mesh`` as DTensors per the
    rule set (default ``serving_rules``): weight dims split where they
    divide, the rest replicate. Every rank passes the same whole tree;
    each keeps its own shards."""
    from repro_torch.sharding import rules as R
    spec = model_spec(cfg)
    spec = {k: spec[k] for k in params if k in spec}
    specs = R.partition_specs(spec, mesh, rules or R.serving_rules())
    return {**params, **{k: R.distribute_tree(params[k], specs[k], mesh)
                         for k in specs}}


def place_caches(caches: dict, cfg: ModelConfig, batch: int,
                 seq_len: int) -> dict:
    """Lay a dense decode-cache tree (a prefill's) out per the active
    mesh and rules of ``use_rules``, as the reference's dry-run takes its
    cache: an input sharded by :func:`cache_spec`'s axes. Under
    ``long_decode_rules`` each rank keeps its own ``T / d`` slots of every
    attention cache (kv_seq over `pod`, `data`; slicing, no
    communication) and the recurrent states as they are. ``batch`` and
    ``seq_len`` are :func:`cache_spec`'s; outside ``use_rules`` the tree
    comes back as it is."""
    from repro_torch.sharding import rules as R
    mesh, rules = R.active()
    if mesh is None:
        return caches
    specs = R.partition_specs(cache_spec(cfg, batch, seq_len), mesh, rules)
    return R.distribute_tree(caches, specs, mesh)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int, *,
               paged=None) -> dict:
    """``paged=(n_blocks, block_size)`` gives the paged layout of the
    eligible sub-layers (transformer.cache_group_spec); the audio family's
    caches are ``encdec.encdec_cache_spec``'s."""
    if cfg.family == "audio":
        return encdec.encdec_cache_spec(cfg, batch, seq_len)
    return cache_group_spec(cfg, batch, seq_len, paged=paged)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-ins for every model input of ``shape``: ``meta`` tensors of
    the inputs' shapes and dtypes (the reference's ShapeDtypeStructs). A
    vlm batch's ``seq_len`` counts its vision rows."""
    B, S = shape.global_batch, shape.seq_len
    dt = param_dtype(cfg)

    def spec(*shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        batch: dict = {"token": spec(B, 1)}
    elif cfg.family == "vlm":
        n_vis = cfg.vlm.n_vis_tokens
        batch = {"tokens": spec(B, S - n_vis),
                 "vision_embeds": spec(B, n_vis, cfg.d_model, dtype=dt)}
    elif cfg.family == "audio":
        batch = {"tokens": spec(B, S),
                 "frames": spec(B, cfg.audio.n_audio_frames, cfg.d_model,
                                dtype=dt)}
    else:
        batch = {"tokens": spec(B, S)}
    if shape.kind == "train" and "tokens" in batch:
        batch["labels"] = spec(*batch["tokens"].shape)
    return batch


def _head(params: dict) -> dict:
    return params["backbone"].get("lm_head", params["backbone"]["embed"])


def _n_vis(cfg: ModelConfig) -> int:
    """The vision rows in front of a vlm prompt (0 for other families)."""
    return cfg.vlm.n_vis_tokens if cfg.family == "vlm" else 0


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    """Token (+ vision) embedding. Returns (x, positions, n_vis): a vlm
    batch's ``vision_embeds`` (B, n_vis, d) go in front of the text."""
    tokens = batch["tokens"]
    x = embed(params["backbone"]["embed"], tokens.long())
    x = shard(x, "batch", "seq", "d_model")
    n_vis = 0
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([dt.split_like(vis, x), x], dim=1)   # rows as x's
        n_vis = vis.shape[1]
    return x, torch.arange(x.shape[1], dtype=torch.int32,
                           device=tokens.device), n_vis


def _no_tenants(adapter_ids) -> None:
    """The reference serves the encoder-decoder with one set of adapters."""
    if adapter_ids is not None:
        raise NotImplementedError(
            "multi-tenant adapter_ids not supported for the audio "
            "encoder-decoder family")


def _hidden(params: dict, batch: dict, cfg: ModelConfig, adapter_ids,
            remat: bool = False):
    """Final-normed hidden states (B, S, d) and the aux loss. An audio
    batch runs the encoder over its ``frames`` and the decoder over its
    tokens; a vlm batch's hidden states include its vision rows."""
    adapters = params.get("adapters", {}).get("stack", {})
    if cfg.family == "audio":
        _no_tenants(adapter_ids)
        ed = params["backbone"]["encdec"]
        enc_out = encdec.encode(ed, adapters, batch["frames"], cfg,
                                remat=remat)
        tok_emb = embed(params["backbone"]["embed"], batch["tokens"].long())
        x, _ = encdec.decode_seq(ed, adapters, tok_emb, enc_out, cfg,
                                 remat=remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, positions, _ = _embed_inputs(params, batch, cfg)
        x, _, aux = stack_seq(params["backbone"]["layers"], adapters, x,
                              cfg, positions=positions, remat=remat,
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
    logits = shard(unembed(_head(params), x), "batch", "seq", "vocab")
    return {"hidden": x, "logits": logits, "aux": aux}


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *,
            remat: Optional[bool] = None) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (+ the aux loss); batch {'tokens',
    'labels'} (B, S) and the family's modality input. A vlm's loss is
    taken on the text only (the logits of its last S positions)."""
    out = forward(params, _inputs(batch), cfg, mode="train", remat=remat)
    logits, labels = out["logits"], batch["labels"]
    if logits.shape[1] != labels.shape[1]:          # vlm: loss on text only
        logits = logits[:, -labels.shape[1]:]
    loss = cross_entropy(logits, labels) + out["aux"]
    return loss, {"aux": out["aux"]}


def _inputs(batch: dict) -> dict:
    """The model inputs of a batch: its tokens and modality rows, not its
    labels."""
    return {k: v for k, v in batch.items() if k not in ("labels", "label")}


def classify(params: dict, batch: dict, cfg: ModelConfig, *,
             adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper case-study head: mean-pooled hidden states (f32) -> adapter
    head logits (B, out). With ``adapter_ids`` the head is the bank's
    slot-leading (n_slots, d, out) stack and each row is scored by its own
    domain's head (mixed-domain accuracy in one call)."""
    x, _ = _hidden(params, _inputs(batch), cfg, adapter_ids)
    pooled = x.float().mean(dim=1)
    h = params["adapters"]["head"]
    if adapter_ids is not None:
        ids = adapter_ids.to(device=pooled.device, dtype=torch.long)
        if dt.is_dt(h["w"]):                           # a slot-sharded bank
            ids = dt.as_replicated(ids, h["w"].device_mesh)
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
    A vlm prompt's vision rows come first: its lengths are ``prompt_lens
    + n_vis`` and ``max_len`` counts them. Returns ((B, 1, vocab) f32
    last-token logits, caches)."""
    adapters = params.get("adapters", {}).get("stack", {})
    if cfg.family == "audio":
        _no_tenants(adapter_ids)
        ed = params["backbone"]["encdec"]
        enc_out = encdec.encode(ed, adapters, batch["frames"], cfg)
        tok_emb = embed(params["backbone"]["embed"], batch["tokens"].long())
        lengths = prompt_lens
        x, caches = encdec.decode_seq(ed, adapters, tok_emb, enc_out, cfg,
                                      make_cache=True, cache_len=max_len,
                                      lengths=lengths)
    else:
        x, positions, n_vis = _embed_inputs(params, batch, cfg)
        lengths = None if prompt_lens is None else prompt_lens + n_vis
        x, caches, _ = stack_seq(params["backbone"]["layers"], adapters, x,
                                 cfg, positions=positions, make_cache=True,
                                 cache_len=max_len, lengths=lengths,
                                 adapter_ids=adapter_ids)
    if lengths is None:
        x = x[:, -1:]
    else:                                  # per-row last VALID token
        x = dt.on_local(x, _last_valid, lengths)
    x = rmsnorm(params["backbone"]["final_norm"], x)
    return unembed(_head(params), x), caches


def _last_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, 1, d): row b's hidden state at column ``lengths[b] - 1``."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, lengths.long() - 1][:, None]


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                pos: torch.Tensor, cfg: ModelConfig,
                active: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None):
    """One token. token: (B, 1) int; pos: scalar or (B,) int (current
    position); ``active`` (B,) bool freezes retired rows' caches;
    ``adapter_ids`` (B,) picks each row's bank slot. The caches are
    updated in place. Returns ((B, 1, vocab) logits, caches). Spans
    ``model.decode_step`` and, inside it, ``model.head`` (and the layers'
    own, ``models/transformer.py``) go to ``telemetry.current()``."""
    tel = telemetry.current()
    B = token.shape[0]
    with tel.span("model.decode_step", rows=B):
        adapters = params.get("adapters", {}).get("stack", {})
        pos = torch.as_tensor(pos, device=token.device).to(
            torch.int64).expand(B)
        x = embed(params["backbone"]["embed"], token.long())
        x = shard(x, "batch", "seq", "d_model")
        if cfg.family == "audio":
            x, caches = encdec.decode_step(params["backbone"]["encdec"],
                                           adapters, x, caches, cfg,
                                           pos=pos, active=active)
        else:
            x, caches = stack_decode(params["backbone"]["layers"], adapters,
                                     x, caches, cfg, pos=pos, active=active,
                                     adapter_ids=adapter_ids)
        with tel.span("model.head"):
            x = rmsnorm(params["backbone"]["final_norm"], x)
            logits = unembed(_head(params), x)
    return logits, caches


def _slots_split() -> bool:
    """Whether the active rules put the KV cache's slot dim (kv_seq) on
    the batch axes (`pod`, `data`), as ``long_decode_rules`` does."""
    from repro_torch.sharding import rules as R
    mesh, rules = R.active()
    if mesh is None:
        return False
    spec = R.spec_for(("kv_seq",), mesh, rules)
    axes = spec[0] if spec else None
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return bool(axes) and set(axes) <= {"pod", "data"}


def _next_token(logits: torch.Tensor, greedy: bool,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, 1) int32 next tokens from (B, vocab) logits (every rank draws
    from the whole vocabulary of the whole batch)."""
    logits = dt.whole(logits)
    if greedy:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def _decode_steps(params: dict, cfg: ModelConfig, steps: int, greedy: bool,
                  tok, caches, pos, remaining,
                  gen: Optional[torch.Generator] = None, adapter_ids=None,
                  with_state: bool = False):
    """``steps`` decode steps with per-row positions and retirement (the
    reference's ``_scan_steps``). Each step emits the carried token, then
    computes the next. Rows with ``remaining <= 0`` are retired: their
    cache writes are dropped and their position and carried token freeze.
    ``with_state`` also returns a copy of the recurrent cache parts
    (:func:`transformer.rec_cache_part`) after every step, stacked at dim
    2 ((L, B, steps, ...)): the speculative drafter's rollback points.
    The next token and the carry updates are span ``model.sample``.
    Returns (toks (B, steps), (tok, caches, pos, remaining)[, snaps])."""
    tel = telemetry.current()
    out, snaps = [], []
    for _ in range(steps):
        active = remaining > 0
        logits, caches = decode_step(params, tok, caches, pos, cfg,
                                     active=active, adapter_ids=adapter_ids)
        if with_state:
            snaps.append(tree_map(torch.clone, rec_cache_part(caches)))
        with tel.span("model.sample"):
            nxt = _next_token(logits[:, -1], greedy, gen)
            out.append(tok)
            tok = torch.where(active[:, None], nxt, tok)
            pos = pos + active.to(pos.dtype)
            remaining = remaining - active.to(remaining.dtype)
    toks = torch.cat(out, dim=1)
    if not with_state:
        return toks, (tok, caches, pos, remaining)
    return toks, (tok, caches, pos, remaining), \
        tree_map(lambda *s: torch.stack(s, 2), *snaps)


def _prefill_state(params: dict, batch: dict, cfg: ModelConfig, cap,
                   prompt_lens, adapter_ids=None):
    """Prefill -> (tok0 (B, 1) int32, caches, pos0 (B,) int32); the dense
    caches hold ``cap`` prompt and generated positions (the prompt width
    when ``cap`` is None, as a paged commit needs no more), a vlm's vision
    rows on top."""
    tokens = batch["tokens"]
    n_vis = _n_vis(cfg)
    logits, caches = prefill(params, batch, cfg,
                             max_len=None if cap is None else cap + n_vis,
                             prompt_lens=prompt_lens,
                             adapter_ids=adapter_ids)
    tok0 = torch.argmax(dt.whole(logits)[:, -1], dim=-1, keepdim=True) \
        .to(torch.int32)
    B, S = tokens.shape
    if prompt_lens is None:
        pos0 = torch.full((B,), S + n_vis, dtype=torch.int32,
                          device=tokens.device)
    else:
        pos0 = prompt_lens.to(torch.int32) + n_vis
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
    src, dst = _pairs(row_idx, tok.shape[0], tok.device)
    for old, new in zip(tree_leaves(caches), tree_leaves(caches_n)):
        _write_rows(old, new, row_idx, src, dst)
    tok[dst] = tok_n[src]
    pos[dst] = pos_n[src]
    return tok, caches, pos


def _write_rows(old, new, row_idx, src, dst) -> None:
    """``old[:, dst] = new[:, src]`` for a cache leaf (batch at dim 1), in
    place; on a mesh this rank writes only the rows it holds."""
    if dt.is_dt(old):
        dt.write_rows(old, new, *_host_pairs(row_idx, old.shape[1]))
    else:
        old[:, dst] = new[:, src].to(old.dtype)


def _pairs(row_idx, B: int, device):
    """(src, dst) index tensors of the batch rows that land in a wave slot
    (``row_idx`` host ints; a pad row carries an index >= B)."""
    src, dst = _host_pairs(row_idx, B)
    return (torch.tensor(src, device=device),
            torch.tensor(dst, device=device))


def _host_pairs(row_idx, B: int) -> tuple[list, list]:
    """``_pairs`` as host lists."""
    pairs = [(r, int(i)) for r, i in enumerate(np.asarray(row_idx)) if i < B]
    return [r for r, _ in pairs], [i for _, i in pairs]


# -- paged KV cache (block pool + per-row tables) ---------------------------

def _pool_commit(pool_sub: dict, dense_k, dense_v, tables, lens) -> None:
    """Write dense prefill K/V of B rows into the block pool, in place.

    pool_sub: {'k', 'v'} pools (L, nb, bs, Hkv, D); dense_k/v: (L, B, S,
    Hkv, D); tables: (B, maxb) int; lens: (B,) valid lengths. Token ``t``
    of row ``b`` lands at ``pool[:, tables[b, t // bs], t % bs]``; tokens
    at or past ``lens[b]`` and sentinel table entries write nothing. The
    values written are exactly the dense prefill's, which keeps paged
    drains equal to dense ones."""
    nb, bs = pool_sub["k"].shape[1], pool_sub["k"].shape[2]
    L, B, S = dense_k.shape[:3]
    t = torch.arange(S, device=dense_k.device)
    blk = tables.long()[:, t // bs]                        # (B, S)
    keep = (t[None, :] < lens.long()[:, None]) & (blk < nb)
    off = (t % bs)[None, :].expand(B, S)
    for name, dense in (("k", dense_k), ("v", dense_v)):
        paged_write(pool_sub[name], blk.reshape(-1), off.reshape(-1),
                    dense, keep.reshape(-1))


@torch.no_grad()
def paged_wave_prefill(params: dict, cfg: ModelConfig, batch: dict,
                       prompt_lens: torch.Tensor, tables: torch.Tensor,
                       pool: dict, adapter_ids=None):
    """Paged wave prefill (the reference's ``_paged_prefill_fn``): the
    exact dense ragged prefill, then each eligible sub-layer's K/V commit
    into the persistent block ``pool`` ({group: {sub: {'k', 'v'}}})
    through the host-built ``tables`` (B, maxb); the paged sub-trees
    become {'k', 'v', 'table'} over that pool. Returns (tok, caches,
    pos)."""
    subs = set(paged_subs(cfg))
    tok0, dense, pos0 = _prefill_state(params, batch, cfg, None,
                                       prompt_lens, adapter_ids)
    caches: dict = {}
    for g, grp in dense.items():
        caches[g] = {}
        for s, c in grp.items():
            if (g, s) not in subs:
                caches[g][s] = c
                continue
            _pool_commit(pool[g][s], c["k"], c["v"], tables, prompt_lens)
            L = c["k"].shape[0]
            table = tables.to(torch.int32)[None].expand(
                L, *tables.shape).clone()
            caches[g][s] = {"k": pool[g][s]["k"], "v": pool[g][s]["v"],
                            # on a mesh: rows as the wave's (`batch`)
                            "table": dt.split_like(table, c["k"], 1, 1)}
    return tok0, caches, pos0


@torch.no_grad()
def paged_refill(params: dict, cfg: ModelConfig, batch: dict,
                 prompt_lens: torch.Tensor, row_idx, tables_rows, tok,
                 caches: dict, pos, adapter_ids=None):
    """Paged in-wave refill (the reference's ``_paged_refill_fn``): the
    admitted rows' K/V commit into the live pool through their fresh
    tables, the table rows land at ``row_idx`` (host ints, pad rows >=
    the wave width), and the other sub-layers merge rows as
    :func:`refill` does. Updated in place and returned."""
    subs = set(paged_subs(cfg))
    tok_n, dense_n, pos_n = _prefill_state(params, batch, cfg, None,
                                           prompt_lens, adapter_ids)
    src, dst = _pairs(row_idx, tok.shape[0], tok.device)
    for g, grp in caches.items():
        for s, old in grp.items():
            new = dense_n[g][s]
            if (g, s) in subs:
                _pool_commit(old, new["k"], new["v"], tables_rows,
                             prompt_lens)
                _write_rows(old["table"], tables_rows.to(torch.int32)[None]
                            .expand(old["table"].shape[0], -1, -1),
                            row_idx, src, dst)
            else:
                for leaf, t in old.items():
                    _write_rows(t, new[leaf], row_idx, src, dst)
    tok[dst] = tok_n[src]
    pos[dst] = pos_n[src]
    return tok, caches, pos


@torch.no_grad()
def paged_suffix(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 suffix_lens: torch.Tensor, start: torch.Tensor, row_idx,
                 tables_rows: torch.Tensor, tok, caches: dict, pos,
                 adapter_ids=None):
    """Prefix-hit admission (the reference's ``_paged_suffix_fn``): a row
    whose prompt prefix matched cached blocks runs only its private suffix
    (tokens (Br, W), right-padded to ``suffix_lens``, starting at
    ``start``) through :func:`stack_chunk`; its table already maps the
    shared blocks, which are read and never written. Writes the rows'
    first decode token, position and table at ``row_idx``, in place."""
    adapters = params.get("adapters", {}).get("stack", {})
    Br, W = tokens.shape
    suffix_lens = suffix_lens.long()
    valid = torch.arange(W, device=tokens.device)[None, :] \
        < suffix_lens[:, None]
    sub = {g: {s: {"k": c["k"], "v": c["v"],
                   "table": tables_rows.to(torch.int32)[None].expand(
                       c["k"].shape[0], *tables_rows.shape)}
               for s, c in grp.items()}
           for g, grp in caches.items()}
    x = embed(params["backbone"]["embed"], tokens.long())
    x = shard(x, "batch", "seq", "d_model")
    x, _ = stack_chunk(params["backbone"]["layers"], adapters, x, sub, cfg,
                       start=start, valid=valid, adapter_ids=adapter_ids)
    xl = dt.on_local(x, _last_valid, suffix_lens.clamp_min(1))
    xl = rmsnorm(params["backbone"]["final_norm"], xl)
    logits = unembed(_head(params), xl)
    tok_n = torch.argmax(dt.whole(logits)[:, -1], dim=-1, keepdim=True) \
        .to(torch.int32)
    pos_n = (start.long() + suffix_lens).to(pos.dtype)
    src, dst = _pairs(row_idx, tok.shape[0], tok.device)
    for g, grp in caches.items():
        for s, c in grp.items():
            _write_rows(c["table"], tables_rows.to(torch.int32)[None]
                        .expand(c["table"].shape[0], -1, -1),
                        row_idx, src, dst)
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
             gen: int, extra_batch: Optional[dict] = None,
             greedy: bool = True,
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
    slot's adapters. ``extra_batch`` holds the family's modality rows
    (``vision_embeds`` or ``frames``, leading dim B). Sampling
    (``greedy=False``) draws from ``generator``."""
    S = prompts.shape[1]
    lens = None if prompt_lens is None else \
        torch.as_tensor(prompt_lens, device=prompts.device).to(torch.int32)
    ids = None if adapter_ids is None else \
        torch.as_tensor(adapter_ids, device=prompts.device).to(torch.int32)
    batch = {"tokens": prompts, **(extra_batch or {})}
    tok0, caches, pos0 = _prefill_state(params, batch, cfg, S + gen, lens,
                                        ids)
    if _slots_split():             # long_decode_rules: each rank its slots
        caches = place_caches(caches, cfg, prompts.shape[0],
                              S + gen + _n_vis(cfg))
    remaining = torch.full((prompts.shape[0],), gen, dtype=torch.int32,
                           device=prompts.device)
    toks, _ = _decode_steps(params, cfg, gen, greedy, tok0, caches, pos0,
                            remaining, generator, ids)
    return toks


# -- speculative decoding ---------------------------------------------------

def verify_step(params: dict, tokens: torch.Tensor, caches: dict,
                pos: torch.Tensor, cfg: ModelConfig,
                adapter_ids: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None):
    """Speculative verify: the target model over a whole draft chunk in one
    pass against the live caches. tokens: (B, T) int, row b's chunk at
    positions ``pos[b] .. pos[b]+T-1``. Returns (logits (B, T, vocab),
    caches, rec_snaps); ``logits[:, j]`` is the distribution after chunk
    offset j. The attention caches hold the whole chunk afterwards and the
    recurrent ones are unchanged (:func:`transformer.stack_verify`):
    ``core/spec_decode.py::rollback_caches`` is mandatory before the next
    chunk. The vlm and audio families have no verify pass, as in the
    reference."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"speculative verify not supported for family={cfg.family!r}")
    adapters = params.get("adapters", {}).get("stack", {})
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).to(torch.int64) \
        .expand(B)
    x = embed(params["backbone"]["embed"], tokens.long())
    x = shard(x, "batch", "seq", "d_model")
    x, caches, snaps = stack_verify(params["backbone"]["layers"], adapters,
                                    x, caches, cfg, pos=pos,
                                    adapter_ids=adapter_ids, active=active)
    x = rmsnorm(params["backbone"]["final_norm"], x)
    return unembed(_head(params), x), caches, snaps


@torch.no_grad()
def draft(dparams: dict, dcfg: ModelConfig, k: int, tok, dcaches: dict,
          pos, active):
    """k+1 greedy drafter steps (the reference's ``_draft_fn``); see
    ``core/spec_decode.py::draft_chunk``."""
    from repro_torch.core import spec_decode as sd          # lazy: no cycle
    return sd.draft_chunk(dparams, dcfg, k, tok, dcaches, pos, active)


@torch.no_grad()
def verify(params: dict, cfg: ModelConfig, tokens, caches: dict, pos,
           active, adapter_ids=None):
    """One-pass chunk verify with its rollback points (the reference's
    ``_verify_fn``); see ``core/spec_decode.py::verify_chunk``."""
    from repro_torch.core import spec_decode as sd          # lazy: no cycle
    return sd.verify_chunk(params, cfg, tokens, caches, pos, active,
                           adapter_ids)


@torch.no_grad()
def spec_segment(params: dict, dparams: dict, cfg: ModelConfig,
                 dcfg: ModelConfig, chunks: int, k: int, tok, caches: dict,
                 dcaches: dict, pos, remaining, spec_rows, adapter_ids=None):
    """A speculative decode segment of ``chunks`` draft-verify chunks of a
    ragged wave (the reference's ``_spec_segment_fn``); see
    ``core/spec_decode.py::spec_segment``."""
    from repro_torch.core import spec_decode as sd          # lazy: no cycle
    return sd.spec_segment(params, dparams, cfg, dcfg, chunks, k, tok,
                           caches, dcaches, pos, remaining, spec_rows,
                           adapter_ids)
