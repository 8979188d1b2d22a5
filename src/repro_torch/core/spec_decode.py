"""Edge-drafted speculative decoding: a recurrent drafter and one batched
verify pass (counterpart of ``repro/core/spec_decode.py``).

One speculative **chunk** per row:

1. **Draft**: a tiny recurrent drafter (ssm by default: O(1) state, no
   draft KV cache) runs ``k+1`` greedy steps over ``[carry, d1..dk]``,
   proposing k tokens and keeping its state after every step, one copy
   per possible rollback point.
2. **Verify**: one pass of the target over all k+1 chunk positions against
   the live caches (``model.verify_step``); the greedy targets are the
   argmax at every offset.
3. **Accept**: greedy exact match, the longest draft prefix that agrees
   with the targets. ``commit = min(accepted + 1, remaining)`` tokens land
   (the "+1" is the verify pass's own next token, so a chunk always makes
   progress).
4. **Rollback**, per row: attention caches get back the values the chunk
   overwrote at rejected offsets, recurrent caches take the state kept at
   the last committed offset. Inactive (retired) rows keep their caches
   as they were, so one ragged wave mixes speculative rows, plain rows
   (``spec_rows`` False forces commit 1: plain decoding through the verify
   pass) and retired rows.

Greedy speculative output is token for token the output of plain greedy
decoding; acceptance changes how fast tokens commit, never which.

The port updates caches in place (the reference builds new ones), so what
a rollback needs is kept before it is overwritten: the attention slots a
draft or a verify pass will write (:func:`save_attn_slots`) and the
recurrent state after each step. The rollback points of one chunk, both
kinds, travel in one ``snaps`` tree that mirrors the cache tree.

On a device mesh the drafter is replicated (``drafter_rules``: every
weight whole, the rows on the batch axes) and drafts under those rules,
the target verifies under the engine's ``serving_rules``, and the
rollback bookkeeping (saved slots, restores) runs on each rank's local
shards with the per-row vectors cut to the rows it holds.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.attention import chunk_slots, write_slots
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import (ATTN_KINDS, attn_window,
                                           groups_for)
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.rules import drafter_rules, use_rules


def _pow2floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


# ---------------------------------------------------------------------------
# Drafter
# ---------------------------------------------------------------------------

def drafter_config(cfg: ModelConfig, *, d_model: int = 64,
                   n_layers: int = 2) -> ModelConfig:
    """A tiny recurrent drafter config for ``cfg``: the ssm family (O(1)
    state, no draft KV cache), the target's vocab, no PEFT modules. The
    mechanism is exact for any drafter weights; acceptance varies."""
    return cfg.with_(
        name=f"{cfg.name}-drafter", family="ssm", n_layers=n_layers,
        d_model=d_model, n_heads=1, n_kv_heads=1, head_dim=0,
        d_ff=2 * d_model, attn_variant="full",
        peft=dataclasses.replace(cfg.peft, n_prefix=0, lora_rank=0,
                                 state_prompt=False, head_dim_out=0))


def _min_window(cfg: ModelConfig) -> int:
    """Smallest nonzero attention window in the stack (0: unwindowed)."""
    ws = [attn_window(cfg, kind) for _, kinds, _ in groups_for(cfg)
          for kind in kinds if kind in ATTN_KINDS]
    ws = [w for w in ws if w and w > 0]
    return min(ws) if ws else 0


@dataclasses.dataclass
class SpecDecoder:
    """The drafter bundle the engine and :func:`spec_generate` consume:
    ``cfg``/``params`` are the drafter model (:func:`drafter_config` builds
    the recommended recurrent one), ``k`` the tokens proposed per
    chunk."""
    cfg: ModelConfig
    params: dict
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecDecoder.k={self.k} must be >= 1")

    @classmethod
    def init(cls, target: ModelConfig, seed: int = 0, *, device=None,
             k: int = 4, d_model: int = 64,
             n_layers: int = 2) -> "SpecDecoder":
        """A random drafter for ``target`` from ``torch.Generator`` seed
        ``seed`` on ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
        dcfg = drafter_config(target, d_model=d_model, n_layers=n_layers)
        return cls(dcfg, M.init(dcfg, seed, device=device), k=k)

    def validate_target(self, cfg: ModelConfig) -> None:
        """Static compatibility checks, raised at construction or submit
        time rather than as silent corruption in a wave."""
        for c, role in ((cfg, "target"), (self.cfg, "drafter")):
            if c.family in ("audio", "vlm"):
                raise NotImplementedError(
                    f"speculative decoding: {role} family {c.family!r} "
                    "not supported")
            w = _min_window(c)
            if w and self.k + 1 > w:
                raise ValueError(
                    f"speculative chunk k+1={self.k + 1} exceeds the "
                    f"{role}'s sliding window {w}: a chunk would wrap the "
                    "rolling cache buffer and rollback could not restore "
                    "the overwritten slots")
        if self.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"drafter vocab {self.cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}")

    def place(self, mesh) -> "SpecDecoder":
        """The drafter replicated on ``mesh`` (``drafter_rules``: a tiny
        model whole on every rank beats a collective per draft step)."""
        if mesh is None:
            return self
        params = M.place_params(self.params, self.cfg, mesh,
                                rules=drafter_rules())
        return dataclasses.replace(self, params=params)


# ---------------------------------------------------------------------------
# Rollback points
# ---------------------------------------------------------------------------

def _chunk_qpos(pos, T: int) -> torch.Tensor:
    pos = torch.as_tensor(pos).to(torch.int64)
    return pos[:, None] + torch.arange(T, device=pos.device)[None, :]


def save_attn_slots(cfg: ModelConfig, caches: dict, pos, T: int) -> dict:
    """Copies of the attention cache values a length-T chunk at ``pos``
    will overwrite: {group: {sub: {'k', 'v', 'pos'}}} with (L, B, T, ...)
    leaves (a slot past the cache reads its last slot, and is never
    restored)."""
    qpos_all = _chunk_qpos(pos, T)
    out: dict = {}
    for name, kinds, _ in groups_for(cfg):
        for i, kind in enumerate(kinds):
            if kind not in ATTN_KINDS:
                continue
            c = caches[name][f"s{i}"]
            qpos = _rows(qpos_all, c)
            c = _local(c)
            rows = torch.arange(qpos.shape[0], device=qpos.device)[:, None]
            S = c["pos"].shape[-1]
            sl = chunk_slots(qpos, attn_window(cfg, kind), S).clamp(max=S - 1)
            out.setdefault(name, {})[f"s{i}"] = {
                leaf: c[leaf][:, rows, sl] for leaf in ("k", "v", "pos")}
    return out


def _local(cache: dict) -> dict:
    """A cache sub-tree as this rank's local shards (views: writes land in
    the DTensors); plain leaves as they are."""
    return {k: v.to_local() if dt.is_dt(v) else v for k, v in cache.items()}


def _rows(v: torch.Tensor, cache: dict) -> torch.Tensor:
    """The rows of per-row vector ``v`` that this rank holds of
    ``cache``'s (L, B, ...) leaves."""
    return dt.rows_of(v, next(iter(cache.values())), 1)


def _merge(a: dict, b: dict) -> dict:
    return {g: {**a.get(g, {}), **b.get(g, {})} for g in {*a, *b}}


def draft_chunk(dparams: dict, dcfg: ModelConfig, k: int, tok, dcaches,
                pos, active):
    """k+1 greedy drafter steps over ``[tok, d1..dk]``.

    One step more than the k proposals, so that the kept states cover
    every rollback point a chunk can commit to (the state after offset
    c-1 for any commit c in 1..k+1). The drafter caches are advanced in
    place. Returns (drafts (B, k), the caches, snaps: per-step recurrent
    states (L, B, k+1, ...) and the saved attention slots)."""
    mesh = dt.mesh_of(*tree_leaves(dparams))
    with (use_rules(mesh, drafter_rules()) if mesh is not None
          else contextlib.nullcontext()):
        saved = save_attn_slots(dcfg, dcaches, pos, k + 1)
        remaining = torch.where(active, k + 2, 0).to(torch.int32)
        toks, (_, dcaches, _, _), snaps = M._decode_steps(
            dparams, dcfg, k + 1, True, tok, dcaches, pos, remaining,
            with_state=True)
    return toks[:, 1:], dcaches, _merge(snaps, saved)


def _restore_attn(cache: dict, saved: dict, *, qpos, commit, active,
                  window: int) -> None:
    """Exact attention rollback: write back the saved values of every slot
    the chunk wrote at a rejected offset (>= commit). A full cache gets
    its empty slots (the +1e9 sentinel) back; a sliding-window buffer gets
    back the older entries the chunk overwrote, which later queries can
    still see."""
    qpos, commit, active = (_rows(v, cache) for v in (qpos, commit, active))
    cache = _local(cache)
    S = cache["pos"].shape[-1]
    T = qpos.shape[1]
    stale = torch.arange(T, device=qpos.device)[None, :] >= commit[:, None]
    slot = chunk_slots(qpos, window, S)
    slot = torch.where(stale & active[:, None], slot,
                       torch.full_like(slot, S))
    write_slots(cache, slot, saved)


def _restore_rec(cache: dict, snaps: dict, *, commit, active) -> None:
    """Recurrent rollback: the state kept at the last committed offset
    (commit-1); inactive rows keep theirs."""
    commit, active = _rows(commit, cache), _rows(active, cache)
    cache, snaps = _local(cache), _local(snaps)
    idx = (commit.long() - 1).clamp_min(0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for leaf, o in cache.items():
        g = snaps[leaf][:, rows, idx]                      # (L, B, ...)
        m = active.reshape((1, -1) + (1,) * (g.dim() - 2))
        o.copy_(torch.where(m, g.to(o.dtype), o))


def rollback_caches(cfg: ModelConfig, caches: dict, snaps: dict, *, pos,
                    commit, active, k: int) -> dict:
    """Per-row cache rollback after a chunk, in place: row b keeps exactly
    the state of having decoded its first ``commit[b]`` chunk tokens
    plainly (inactive rows keep theirs). ``snaps`` holds the chunk's
    rollback points (:func:`draft_chunk`, :func:`verify_chunk`)."""
    qpos = _chunk_qpos(pos, k + 1)
    for name, kinds, _ in groups_for(cfg):
        for i, kind in enumerate(kinds):
            key = f"s{i}"
            if kind in ATTN_KINDS:
                _restore_attn(caches[name][key], snaps[name][key], qpos=qpos,
                              commit=commit, active=active,
                              window=attn_window(cfg, kind))
            else:
                _restore_rec(caches[name][key], snaps[name][key],
                             commit=commit, active=active)
    return caches


def verify_chunk(params: dict, cfg: ModelConfig, tokens, caches: dict, pos,
                 active, adapter_ids=None):
    """The target's verify pass with its rollback points: the attention
    slots the chunk overwrites are saved first. Returns (logits (B, T,
    vocab), caches, snaps)."""
    saved = save_attn_slots(cfg, caches, pos, tokens.shape[1])
    logits, caches, rec = M.verify_step(params, tokens, caches, pos, cfg,
                                        adapter_ids=adapter_ids,
                                        active=active)
    return logits, caches, _merge(rec, saved)


# ---------------------------------------------------------------------------
# Chunk and segment
# ---------------------------------------------------------------------------

def spec_chunk(params, dparams, cfg: ModelConfig, dcfg: ModelConfig, k: int,
               tok, caches, dcaches, pos, remaining, spec_rows, adapter_ids):
    """One draft, verify, accept, rollback chunk of a ragged wave.

    ``tok`` (B, 1) is the committed-but-unemitted next token at position
    ``pos``. The chunk emits ``commit`` tokens ``[tok, t1..t_{commit-1}]``
    and carries the verify target at the last committed offset. Rows with
    ``spec_rows`` False decode plainly through the verify pass (commit
    1, drafts never counted)."""
    active = remaining > 0
    drafts, dcaches, dsnaps = draft_chunk(dparams, dcfg, k, tok, dcaches,
                                          pos, active)
    tks = torch.cat([tok, drafts.to(tok.dtype)], dim=1)     # (B, k+1)
    logits, caches, vsnaps = verify_chunk(params, cfg, tks, caches, pos,
                                          active, adapter_ids)
    tgt = torch.argmax(dt.whole(logits), dim=-1).to(torch.int32)
    match = (drafts.to(torch.int32) == tgt[:, :k]) & spec_rows[:, None]
    acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    commit = torch.where(active, torch.minimum(acc.to(remaining.dtype) + 1,
                                               remaining),
                         torch.zeros_like(remaining))
    vals = torch.cat([tok.to(torch.int32), tgt[:, :k]], dim=1)
    carry = torch.gather(tgt, 1, (commit.long() - 1).clamp_min(0)[:, None])
    tok = torch.where(active[:, None], carry, tok.to(torch.int32))
    rollback_caches(cfg, caches, vsnaps, pos=pos, commit=commit,
                    active=active, k=k)
    rollback_caches(dcfg, dcaches, dsnaps, pos=pos, commit=commit,
                    active=active, k=k)
    pos = pos + commit.to(pos.dtype)
    remaining = remaining - commit
    drafted = torch.where(active & spec_rows, k, 0)
    accepted = (commit - 1).clamp_min(0)
    return (tok, caches, dcaches, pos, remaining, vals, commit, drafted,
            accepted)


def spec_segment(params, dparams, cfg: ModelConfig, dcfg: ModelConfig,
                 chunks: int, k: int, tok, caches, dcaches, pos, remaining,
                 spec_rows, adapter_ids):
    """``chunks`` speculative chunks (the engine's counterpart of a plain
    decode segment).

    Emitted tokens land in a (B, chunks*(k+1)) buffer at per-row offsets
    (rows commit at different rates); ``counts`` (B,) says how many of
    each row's entries are real (the entries past them are not zeroed, as
    the reference's are: nothing reads them). Returns (buffer, counts,
    drafted, accepted, tok, caches, dcaches, pos, remaining)."""
    B, T = tok.shape[0], k + 1
    dev = tok.device
    # T spare columns: a chunk writes all T of its values at the row's
    # offset and the next chunk overwrites the uncommitted ones
    out = torch.zeros((B, chunks * T + T), dtype=torch.int32, device=dev)
    off = torch.zeros((B,), dtype=torch.int64, device=dev)
    ar = torch.arange(T, device=dev)[None, :]
    drafted = torch.zeros((), dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(chunks):
        (tok, caches, dcaches, pos, remaining, vals, commit, dr,
         ac) = spec_chunk(params, dparams, cfg, dcfg, k, tok, caches,
                          dcaches, pos, remaining, spec_rows, adapter_ids)
        out.scatter_(1, off[:, None] + ar, vals)
        off = off + commit.long()
        drafted = drafted + dr.sum()
        accepted = accepted + ac.sum()
    return (out[:, :chunks * T], off, drafted, accepted, tok, caches,
            dcaches, pos, remaining)


# ---------------------------------------------------------------------------
# One-call generation (generate's speculative twin)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecStats:
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


@torch.no_grad()
def spec_generate(params: dict, cfg: ModelConfig, spec: SpecDecoder,
                  prompts: torch.Tensor, *, gen: int, prompt_lens=None,
                  adapter_ids=None, spec_rows=None):
    """Greedy speculative generation: token for token
    ``model.generate(..., greedy=True)``, with fewer reads of the target's
    caches. prompts: (B, S) int. Returns ((B, gen) int32 tokens,
    SpecStats). The drafter prefills beside the target (its own next-token
    guess is discarded: the carry is always the target's token), then
    pow2-bucketed speculative segments drain the per-row budgets."""
    spec.validate_target(cfg)
    dev = prompts.device
    B, S = prompts.shape
    lens = None if prompt_lens is None else \
        torch.as_tensor(prompt_lens, device=dev).to(torch.int32)
    ids = None if adapter_ids is None else \
        torch.as_tensor(adapter_ids, device=dev).to(torch.int32)
    batch = {"tokens": prompts}
    tok, caches, pos = M.wave_prefill(params, cfg, S + gen, batch, lens, ids)
    _, dcaches, _ = M.wave_prefill(spec.params, spec.cfg, S + gen, batch,
                                   lens, None)
    remaining = torch.full((B,), gen, dtype=torch.int32, device=dev)
    rows = torch.ones((B,), dtype=torch.bool, device=dev) \
        if spec_rows is None else \
        torch.as_tensor(spec_rows, device=dev).to(torch.bool)
    T = spec.k + 1
    out_np = np.zeros((B, gen), np.int32)
    write = np.zeros((B,), np.int64)
    rem_np = np.full((B,), gen, np.int64)
    stats = SpecStats()
    while rem_np.max() > 0:
        chunks = max(1, _pow2floor(max(1, int(rem_np.max()) // T)))
        (buf, counts, dr, ac, tok, caches, dcaches, pos, remaining) = \
            M.spec_segment(params, spec.params, cfg, spec.cfg, chunks,
                           spec.k, tok, caches, dcaches, pos, remaining,
                           rows, ids)
        counts_np = counts.cpu().numpy()
        buf_np = buf.cpu().numpy()
        for b in range(B):
            c = int(counts_np[b])
            out_np[b, write[b]:write[b] + c] = buf_np[b, :c]
            write[b] += c
        rem_np -= counts_np
        stats.drafted += int(dr)
        stats.accepted += int(ac)
    return torch.as_tensor(out_np, device=dev), stats
