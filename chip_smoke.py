#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--json-out PATH]

Phases, each of which exits nonzero on a failed check:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serving path from ``kernels/csrc``;
3. kernels: at the main path's shapes, each kernel against its plain
   PyTorch version on the same inputs, with its time (CUDA events, median,
   L2 flushed between launches), the plain version's time, one PyTorch
   library call's time as a yardstick and the card's least time (bound);
   the two multi-LoRA kernels also row by row against ``lora_matmul`` run
   with that row's adapter, which must give the same bits;
4. main path: qwen2-7b at its full published size (28 layers, d_model
   3584, bf16, random weights from the seed) serves 16 ragged requests
   through ``DecodeEngine(slots=8)``, with in-wave refill; lora_matmul,
   flash_attention and flash_decode must launch during the drain, and the
   full-size prefill logits through the kernels must agree with the plain
   path's;
5. bank path, on the same backbone: an ``AdapterBank`` of 4 domains
   (seeded prefix slots, seeded nonzero LoRA b) serves 16 ragged requests
   of mixed domains through ``DecodeEngine(slots=8, bank=...)``; the
   multi-LoRA kernels, flash_attention and flash_decode must launch and
   lora_matmul must not; a mixed 4-domain prefill must agree with each
   domain's own prefill (cosine > 0.999, same top-1), and the domains must
   not all give the same tokens;
6. end to end: a 2-layer, full-width f32 qwen2-7b drains the same kind of
   queue through the kernels and through ``backend="torch"``; the greedy
   tokens must be identical, and equal to solo generation; a mixed-domain
   bank drain must give identical tokens through the kernels, through
   ``backend="torch"`` and through per-domain single-tenant drains;
7. classify: vit-edge at its configured size (12 layers, d_model 768)
   scores a mixed-domain batch through the bank's per-row heads, within
   bf16 tolerance of each domain's own ``classify``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2,
       # f32: sums of up to 3584 terms taken in another order than cuBLAS
       torch.float32: 1e-4}
REPLACES = {
    "lora_matmul": "src/repro/kernels/lora_matmul.py:75",
    "flash_attention": "src/repro/kernels/flash_attention.py:87",
    "flash_decode": "src/repro/kernels/flash_decode.py:207",
    "lora_bgmv_rows": "src/repro/kernels/lora_bgmv.py:91",
    "lora_bgmv_seq": "src/repro/kernels/lora_bgmv.py:168",
}
N_DOMAINS = 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch
    (the main path reads weights and caches far larger than the 50 MB L2)."""

    def __init__(self, reps: int = 15):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate or
    operations over the peak rate of the dtype, whichever is larger."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def compare(name: str, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    check(bool(ok) and np.isfinite(err),
          f"{name}: kernel vs plain max_abs_err {err} beyond tol {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(gen: torch.Generator, timer: Timer) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_bgmv as bg
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    def randn(*shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)

    cases = {"lora_matmul": [], "flash_attention": [], "flash_decode": [],
             "lora_bgmv_rows": [], "lora_bgmv_seq": []}

    # lora_matmul: q (N 3584) and v (N 512) projections of qwen2-7b, at
    # decode (M = 8 rows) and prefill (M = 8 x 512); r = 8, bias
    K, r, scale = 3584, 8, 16.0 / 8
    for dtype, shapes in ((torch.bfloat16, [(8, 3584), (8, 512),
                                            (4096, 3584), (4096, 512)]),
                          (torch.float32, [(4096, 3584)])):
        for M, N in shapes:
            x = randn(M, K, dtype=dtype)
            w, a = randn(K, N, dtype=dtype, s=K ** -0.5), \
                randn(K, r, dtype=dtype, s=K ** -0.5)
            b, bias = randn(r, N, dtype=dtype, s=0.1), \
                randn(N, dtype=dtype, s=0.1)
            got = lm.lora_matmul(x, w, a, b, scale, bias, backend="cuda")
            want = lm.lora_matmul(x, w, a, b, scale, bias, backend="torch")
            torch.cuda.synchronize()
            err = compare(f"lora_matmul M={M} N={N} {dtype}", got, want,
                          dtype)
            elt = x.element_size()
            bms, by = bound(elt * (M * K + K * N + K * r + r * N + N + M * N),
                            2 * M * N * K + 2 * M * r * (K + N), dtype)
            cases["lora_matmul"].append(dict(
                shape=f"M={M} K={K} N={N} r={r} bias {str(dtype)[6:]}",
                max_abs_err=err, tol=TOL[dtype],
                ms=timer(lambda: lm.lora_matmul(x, w, a, b, scale, bias,
                                                backend="cuda")),
                plain_ms=timer(lambda: lm.lora_matmul(
                    x, w, a, b, scale, bias, backend="torch")),
                library_ms=timer(lambda: torch.addmm(bias, x, w)
                                 + scale * ((x @ a) @ b)),
                bound_ms=bms, bound_by=by))
            log(f"kernel lora_matmul {cases['lora_matmul'][-1]}")

    # flash_attention: prefill of 8 rows x 512 tokens behind 16 prefix
    # slots, Hq 28 / Hkv 4 (g = 7), D 128; plus a case whose last 64 keys
    # carry the +1e9 sentinel
    B, S, n_p, Hq, Hkv, D = 8, 512, 16, 28, 4, 128
    T = n_p + S
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    for dtype, label in ((torch.bfloat16, "causal"),
                         (torch.bfloat16, "sentinel"),
                         (torch.float32, "causal")):
        kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                       device="cuda"), q_pos])
        if label == "sentinel":
            kv_pos[-64:] = 10 ** 9
        q = randn(B, S, Hq, D, dtype=dtype)
        k, v = randn(B, T, Hkv, D, dtype=dtype), randn(B, T, Hkv, D,
                                                       dtype=dtype)
        kw = dict(q_pos=q_pos, kv_pos=kv_pos)
        got = fa.flash_attention(q, k, v, backend="cuda", **kw)
        want = fa.flash_attention(q, k, v, backend="torch", **kw)
        torch.cuda.synchronize()
        err = compare(f"flash_attention {label} {dtype}", got, want, dtype)
        vis = ref.visibility_mask(q_pos, kv_pos)
        pairs = int(vis.sum().item()) * B * Hq
        elt = q.element_size()
        bms, by = bound(elt * (2 * q.numel() + 2 * k.numel()) + 4 * (S + T),
                        4 * D * pairs, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cases["flash_attention"].append(dict(
            shape=f"B={B} S={S} prefix={n_p} Hq={Hq} Hkv={Hkv} D={D} "
                  f"{label} {str(dtype)[6:]}",
            max_abs_err=err, tol=TOL[dtype],
            ms=timer(lambda: fa.flash_attention(q, k, v, backend="cuda",
                                                **kw)),
            plain_ms=timer(lambda: fa.flash_attention(q, k, v,
                                                      backend="torch", **kw)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=vis, enable_gqa=True)),
            bound_ms=bms, bound_by=by))
        log(f"kernel flash_attention {cases['flash_attention'][-1]}")

    # flash_decode: 8 rows against a 1024-slot cache behind 16 prefix slots
    # (concatenated in front at position -1), per-row q_pos, sentinels past
    # each row's position
    Tc = 1024
    T = n_p + Tc
    for dtype in (torch.bfloat16, torch.float32):
        q = randn(B, Hq, D, dtype=dtype)
        k, v = randn(B, T, Hkv, D, dtype=dtype), randn(B, T, Hkv, D,
                                                       dtype=dtype)
        qp = torch.randint(32, Tc, (B,), generator=gen, device="cuda",
                           dtype=torch.int32)
        slots = torch.arange(Tc, dtype=torch.int32, device="cuda")[None]
        kp = torch.cat([torch.full((B, n_p), -1, dtype=torch.int32,
                                   device="cuda"),
                        torch.where(slots <= qp[:, None], slots,
                                    torch.full_like(slots, 10 ** 9))], 1)
        kw = dict(q_pos=qp, kv_pos=kp)
        got = fd.flash_decode(q, k, v, backend="cuda", **kw)
        want = fd.flash_decode(q, k, v, backend="torch", **kw)
        torch.cuda.synchronize()
        err = compare(f"flash_decode {dtype}", got, want, dtype)
        vis = (kp <= qp[:, None]) | (kp < 0)                   # (B, T)
        pairs = int(vis.sum().item()) * Hq
        elt = q.element_size()
        bms, by = bound(elt * (2 * q.numel() + 2 * k.numel())
                        + 4 * (B + B * T), 4 * D * pairs, dtype)
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = vis[:, None, None, :]
        cases["flash_decode"].append(dict(
            shape=f"B={B} T={Tc}+{n_p} prefix Hq={Hq} Hkv={Hkv} D={D} "
                  f"per-row q_pos {str(dtype)[6:]}",
            max_abs_err=err, tol=TOL[dtype],
            ms=timer(lambda: fd.flash_decode(q, k, v, backend="cuda", **kw)),
            plain_ms=timer(lambda: fd.flash_decode(q, k, v, backend="torch",
                                                   **kw)),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            bound_ms=bms, bound_by=by))
        log(f"kernel flash_decode {cases['flash_decode'][-1]}")

    # multi-LoRA: the q (N 3584) and v (N 512) projections of a 4-domain
    # bank wave; rows at decode (M = 8 rows, ids repeating), seq at
    # prefill (8 sequences x 512 tokens); r = 8, bias
    K, r, scale, n_slots = 3584, 8, 16.0 / 8, N_DOMAINS
    for name, dtype, lead, N in (
            ("lora_bgmv_rows", torch.bfloat16, (8,), 3584),
            ("lora_bgmv_rows", torch.bfloat16, (8,), 512),
            ("lora_bgmv_rows", torch.float32, (8,), 3584),
            ("lora_bgmv_seq", torch.bfloat16, (8, 512), 3584),
            ("lora_bgmv_seq", torch.bfloat16, (8, 512), 512),
            ("lora_bgmv_seq", torch.float32, (8, 512), 3584)):
        x = randn(*lead, K, dtype=dtype)
        w = randn(K, N, dtype=dtype, s=K ** -0.5)
        a = randn(n_slots, K, r, dtype=dtype, s=K ** -0.5)
        b = randn(n_slots, r, N, dtype=dtype, s=0.1)
        bias = randn(N, dtype=dtype, s=0.1)
        ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0], dtype=torch.int32,
                           device="cuda")
        fn = bg.lora_bgmv_rows if name == "lora_bgmv_rows" \
            else bg.lora_bgmv_seq
        got = fn(x, w, a, b, ids, scale, bias, backend="cuda")
        want = fn(x, w, a, b, ids, scale, bias, backend="torch")
        torch.cuda.synchronize()
        err = compare(f"{name} N={N} {dtype}", got, want, dtype)
        # per row (sequence): the same bits as lora_matmul alone with its
        # own adapter
        bit_err = 0.0
        for i, sl in enumerate(ids.tolist()):
            xi = x[i:i + 1] if x.dim() == 2 else x[i]
            gi = got[i:i + 1] if x.dim() == 2 else got[i]
            one = lm.lora_matmul(xi, w, a[sl], b[sl], scale, bias,
                                 backend="cuda")
            bit_err = max(bit_err, (gi.float() - one.float()).abs()
                          .max().item())
            check(torch.equal(gi, one),
                  f"{name} N={N} {dtype}: row {i} differs from lora_matmul "
                  f"with its adapter by {bit_err}")
        M_ = x.numel() // K
        used = len(set(ids.tolist()))
        elt = x.element_size()
        bms, by = bound(elt * (M_ * K + K * N + used * (K * r + r * N) + N
                               + M_ * N) + 4 * ids.numel(),
                        2 * M_ * N * K + 2 * M_ * r * (K + N), dtype)
        x2 = x.reshape(M_, K)

        def library():
            # addmm for x W + bias, a gathered bmm for the low-rank term
            if x.dim() == 2:
                lo = torch.bmm(torch.bmm(x[:, None], a[ids]), b[ids])[:, 0]
            else:
                lo = torch.bmm(torch.bmm(x, a[ids]), b[ids]).reshape(M_, N)
            return torch.addmm(bias, x2, w) + scale * lo

        cases[name].append(dict(
            shape=f"{'M' if x.dim() == 2 else 'B x S'}="
                  f"{' x '.join(map(str, lead))} K={K} N={N} r={r} "
                  f"slots={n_slots} bias {str(dtype)[6:]}",
            max_abs_err=err, tol=TOL[dtype], bits_vs_lora_matmul=bit_err,
            ms=timer(lambda: fn(x, w, a, b, ids, scale, bias,
                                backend="cuda")),
            plain_ms=timer(lambda: fn(x, w, a, b, ids, scale, bias,
                                      backend="torch")),
            library_ms=timer(library), bound_ms=bms, bound_by=by))
        log(f"kernel {name} {cases[name][-1]}")
    return cases


# ---------------------------------------------------------------------------
# phases 4 to 7: the serving paths
# ---------------------------------------------------------------------------

def queue(rng, n, lens, gens, vocab):
    return [(rng.integers(0, vocab, int(rng.integers(*lens))).astype(np.int32),
             int(rng.integers(*gens))) for _ in range(n)]


def drain(cfg, params, reqs, slots, bank=None, domains=None):
    from repro_torch.launch.engine import DecodeEngine
    eng = DecodeEngine(cfg, slots=slots, bank=bank, device="cuda")
    uids = [eng.submit(p, g, domain=None if domains is None else domains[i])
            for i, (p, g) in enumerate(reqs)]
    comps, stats = eng.run(params)
    torch.cuda.synchronize()
    by = {c.uid: c for c in comps}
    check(sorted(by) == sorted(uids), "engine lost a request")
    return [by[u] for u in uids], stats


def domain_adapters(cfg, seed: int) -> dict:
    """N_DOMAINS adapter sets from the spec alone (no backbone is built):
    seeded prefix slots and LoRA a, and seeded nonzero LoRA b (the spec
    inits b to zeros, which would make every domain serve alike)."""
    from repro_torch.models.model import adapter_spec
    from repro_torch.models.params import init_from_spec
    out = {}
    for i in range(N_DOMAINS):
        gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        ad = init_from_spec(gen, adapter_spec(cfg), torch.device("cuda"))
        for layer in ad["stack"]["g0"]:
            for t in layer["s0"]["lora"].values():
                t["b"] = (torch.randn(t["b"].shape, generator=gen,
                                      device="cuda") * 0.1).to(t["b"].dtype)
        out[f"domain{i}"] = ad
    return out


def served_ok(cfg, comps, reqs, what):
    for c, (p, g) in zip(comps, reqs):
        check(len(c.tokens) == g and not c.timed_out,
              f"{what}: request {c.uid}: {len(c.tokens)} tokens, budget {g}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"{what}: request {c.uid}: token out of vocab")


def drain_record(stats, launches, peak) -> dict:
    h = stats.ttft_hist
    return dict(launches=launches, requests=stats.requests,
                tokens=stats.tokens, wall_s=stats.wall_s,
                tok_per_s=stats.tok_per_s, waves=stats.waves,
                segments=stats.segments, padded_tokens=stats.padded_tokens,
                ttft_p50_s=h["p50"], ttft_p99_s=h["p99"],
                tok_latency_p50_s=stats.tok_latency_hist["p50"],
                peak_mem_gib=peak / 2 ** 30)


def drain_line(r: dict) -> str:
    return (f"{r['requests']} requests, {r['tokens']} tokens in "
            f"{r['wall_s']:.3f}s = {r['tok_per_s']:.2f} tok/s; waves "
            f"{r['waves']}, segments {r['segments']}, padded_tokens "
            f"{r['padded_tokens']}; ttft p50 {r['ttft_p50_s']:.4f}s p99 "
            f"{r['ttft_p99_s']:.4f}s; peak memory {r['peak_mem_gib']:.2f} "
            f"GiB; launches {r['launches']}")


def main_path(seed: int) -> tuple[dict, dict]:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b")
    check((cfg.n_layers, cfg.d_model, cfg.dtype) == (28, 3584, "bfloat16"),
          "qwen2-7b is not at its published size")
    t0 = time.perf_counter()
    params = M.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"main: qwen2-7b init {n_params / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = queue(rng, 16, (32, 513), (16, 65), cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comps, stats = drain(cfg, params, reqs, slots=8)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "main")
    check(all(launches[k] > 0 for k in ("lora_matmul", "flash_attention",
                                        "flash_decode")),
          f"a kernel of the single-tenant path never launched: {launches}")
    check(stats.waves > 1, "no in-wave refill happened")
    log(f"main: {drain_line(rec)}")

    # full-size reference check: one prompt's prefill logits through the
    # kernels against the plain path (bf16 through 28 layers: cosine)
    toks = torch.as_tensor(reqs[0][0][None], device="cuda")
    kl, _ = M.prefill(params, {"tokens": toks}, cfg)
    with ops.backend("torch"):
        pl, _ = M.prefill(params, {"tokens": toks}, cfg)
    cos = F.cosine_similarity(kl.flatten(), pl.flatten(), dim=0).item()
    check(bool(torch.isfinite(kl).all()) and cos > 0.99,
          f"full-size prefill logits: kernels vs plain cosine {cos}")
    log(f"main: full-size prefill logits kernels vs plain: cosine {cos:.6f},"
        f" max_abs_err {(kl - pl).abs().max().item():.4f}, top-1 "
        f"{int(kl.argmax())} vs {int(pl.argmax())}")
    rec["prefill_logits_cosine"] = cos
    bank_rec = bank_path(cfg, params["backbone"], reqs, seed)
    del params
    torch.cuda.empty_cache()
    return rec, bank_rec


def bank_path(cfg, backbone: dict, reqs: list, seed: int) -> dict:
    """The multi-tenant path on the main path's backbone, serving the main
    path's queue with a seeded domain per request."""
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    bank = AdapterBank.create(domain_adapters(cfg, seed + 1))
    sp = bank.serving_params(backbone)
    rng = np.random.default_rng(seed + 10)
    doms = [bank.domains[int(i)]
            for i in rng.integers(0, N_DOMAINS, len(reqs))]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    comps, stats = drain(cfg, sp, reqs, slots=8, bank=bank, domains=doms)
    launches = ops.launch_counts()
    rec = drain_record(stats, launches, torch.cuda.max_memory_allocated())
    served_ok(cfg, comps, reqs, "bank")
    check(all(launches[k] > 0 for k in ("lora_bgmv_rows", "lora_bgmv_seq",
                                        "flash_attention", "flash_decode"))
          and launches["lora_matmul"] == 0,
          f"bank path: every LoRA projection must go through the "
          f"multi-LoRA kernels: {launches}")
    check(stats.waves > 1, "bank: no in-wave refill happened")
    log(f"bank: {N_DOMAINS} domains, mix "
        f"{[doms.count(d) for d in bank.domains]}: {drain_line(rec)}")

    # full-size check: one prompt per domain in one mixed prefill through
    # the multi-LoRA kernels, against each domain's own single-tenant
    # prefill through lora_matmul
    S = 256
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (N_DOMAINS, S)),
                           device="cuda")
    ids = bank.adapter_ids(bank.domains)
    ops.reset_launch_counts()
    mixed, _ = M.prefill(sp, {"tokens": toks}, cfg, adapter_ids=ids)
    n = ops.launch_counts()
    check(n["lora_bgmv_seq"] > 0 and n["lora_matmul"] == 0,
          f"mixed prefill did not take the seq kernel: {n}")
    coss, errs, same = [], [], []
    for i, d in enumerate(bank.domains):
        one, _ = M.prefill({"backbone": backbone,
                            "adapters": bank.snapshot(d)},
                           {"tokens": toks[i:i + 1]}, cfg)
        cos = F.cosine_similarity(mixed[i].flatten(), one[0].flatten(),
                                  dim=0).item()
        top = (int(mixed[i].argmax()), int(one[0].argmax()))
        coss.append(cos)
        errs.append((mixed[i] - one[0]).abs().max().item())
        same.append(bool(torch.equal(mixed[i], one[0])))
        check(bool(torch.isfinite(mixed[i]).all()) and cos > 0.999
              and top[0] == top[1],
              f"bank: mixed vs {d} prefill logits cosine {cos}, top-1 {top}")
    log(f"bank: mixed vs per-domain prefill logits at full size: cosine "
        f"{['%.6f' % c for c in coss]}, max_abs_err "
        f"{['%.4f' % e for e in errs]}, bit-equal {same}")
    # adapter selection is visible: one prompt, every domain
    gen = M.generate(sp, cfg, toks[:1].expand(N_DOMAINS, S), gen=8,
                     adapter_ids=ids).cpu().numpy()
    distinct = len({tuple(r) for r in gen})
    check(distinct >= 2, f"bank: all {N_DOMAINS} domains gave the same "
                         f"tokens {gen[0]}")
    log(f"bank: one prompt through {N_DOMAINS} domains: {distinct} distinct "
        f"token rows")
    rec.update(mixed_prefill_cosine=coss, mixed_prefill_max_abs_err=errs,
               mixed_prefill_bit_equal=same, distinct_domain_rows=distinct)
    return rec


def end_to_end(seed: int) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("qwen2-7b").with_(n_layers=2, dtype="float32")
    params = M.init(cfg, seed, device="cuda")
    reqs = queue(np.random.default_rng(seed + 1), 8, (32, 513), (4, 17),
                 cfg.vocab_size)
    kernel, st = drain(cfg, params, reqs, slots=4)
    with ops.backend("torch"):
        plain, _ = drain(cfg, params, reqs, slots=4)
    for a, b in zip(kernel, plain):
        check(np.array_equal(a.tokens, b.tokens),
              f"e2e f32: request {a.uid} kernel {a.tokens} vs plain "
              f"{b.tokens}")
    p, g = reqs[0]
    solo = M.generate(params, cfg, torch.as_tensor(p[None], device="cuda"),
                      gen=g)[0].cpu().numpy()
    check(np.array_equal(solo, kernel[0].tokens),
          "e2e f32: drain differs from solo generate")
    log(f"e2e: 2-layer f32 qwen2-7b, {len(reqs)} requests, {st.waves} waves:"
        f" kernel tokens == plain tokens == solo generate")

    # the bank path at the same size: one mixed-domain drain through the
    # kernels, through the plain versions, and per domain single-tenant
    backbone = params["backbone"]
    bank = AdapterBank.create(domain_adapters(cfg, seed + 2))
    sp = bank.serving_params(backbone)
    rng = np.random.default_rng(seed + 3)
    breqs = queue(rng, 8, (32, 513), (4, 17), cfg.vocab_size)
    doms = [bank.domains[int(i)] for i in rng.integers(0, N_DOMAINS, 8)]
    ops.reset_launch_counts()
    bk, bst = drain(cfg, sp, breqs, slots=4, bank=bank, domains=doms)
    n = ops.launch_counts()
    check(n["lora_bgmv_rows"] > 0 and n["lora_bgmv_seq"] > 0
          and n["lora_matmul"] == 0, f"e2e bank launches {n}")
    with ops.backend("torch"):
        bp, _ = drain(cfg, sp, breqs, slots=4, bank=bank, domains=doms)
    for a, b in zip(bk, bp):
        check(np.array_equal(a.tokens, b.tokens),
              f"e2e f32 bank: request {a.uid} kernel {a.tokens} vs plain "
              f"{b.tokens}")
    for d in sorted(set(doms)):
        idx = [i for i, x in enumerate(doms) if x == d]
        one, _ = drain(cfg, {"backbone": backbone,
                             "adapters": bank.snapshot(d)},
                       [breqs[i] for i in idx], slots=4)
        for i, c in zip(idx, one):
            check(np.array_equal(bk[i].tokens, c.tokens),
                  f"e2e f32 bank: request {i} ({d}) mixed {bk[i].tokens} vs "
                  f"per-domain {c.tokens}")
    log(f"e2e: 2-layer f32 bank of {N_DOMAINS} domains, {len(breqs)} "
        f"requests, {bst.waves} waves: kernel tokens == plain tokens == "
        f"per-domain drains")
    del params
    torch.cuda.empty_cache()
    return dict(requests=len(reqs), waves=st.waves, tokens_equal=True,
                bank_requests=len(breqs), bank_waves=bst.waves,
                bank_tokens_equal=True)


def classify_phase(seed: int) -> dict:
    """vit-edge (the paper's case-study backbone) at its configured size:
    mixed-domain classify through the bank's per-row heads."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = get_config("vit-edge")
    check((cfg.n_layers, cfg.d_model) == (12, 768),
          "vit-edge is not at its configured size")
    backbone = M.init(cfg, seed, device="cuda")["backbone"]
    adapters = domain_adapters(cfg, seed + 4)
    bank = AdapterBank.create(adapters)
    rng = np.random.default_rng(seed + 5)
    B, S = 8, 197
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device="cuda")
    doms = [bank.domains[int(i)] for i in rng.integers(0, N_DOMAINS, B)]
    dt = getattr(torch, cfg.dtype)
    with torch.no_grad():
        ops.reset_launch_counts()
        mixed = M.classify(bank.serving_params(backbone), {"tokens": toks},
                           cfg, adapter_ids=bank.adapter_ids(doms))
        n = ops.launch_counts()
        check(n["lora_bgmv_seq"] > 0 and n["lora_matmul"] == 0,
              f"classify did not take the seq kernel: {n}")
        want = torch.cat([M.classify({"backbone": backbone,
                                      "adapters": adapters[d]},
                                     {"tokens": toks[i:i + 1]}, cfg)
                          for i, d in enumerate(doms)])
    err = compare("classify mixed vs per-domain", mixed, want, dt)
    check(mixed.shape == (B, cfg.peft.head_dim_out), "classify shape")
    log(f"classify: vit-edge {B} x {S} tokens over {len(set(doms))} domains:"
        f" mixed vs per-domain max_abs_err {err:.3e} (tol {TOL[dt]})")
    return dict(batch=B, seq=S, max_abs_err=err, tol=TOL[dt])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the full record as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = time.perf_counter()
    nvcc = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(nvcc)} kernels in {build_s:.1f}s")
    for name, text in nvcc.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    rec = {"gpu": smi, "kind": kind, "build_s": build_s}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cases = kernel_cases(gen, Timer())
    rec["main"], rec["bank"] = main_path(args.seed)
    log(f"multi-tenancy: bank drain {rec['bank']['tok_per_s']:.2f} tok/s "
        f"beside single-tenant {rec['main']['tok_per_s']:.2f} tok/s")
    rec["e2e"] = end_to_end(args.seed)
    rec["classify"] = classify_phase(args.seed)

    kernels = []
    for name, cs in cases.items():
        head = cs[0]
        path = "bank" if name.startswith("lora_bgmv") else "main"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": rec[path]["launches"][name],
            "max_abs_err": head["max_abs_err"], "tol": head["tol"],
            "shape": head["shape"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": cs})
    rec["kernels"] = kernels
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
