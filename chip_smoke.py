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
4. main path: qwen2-7b at its full published size (28 layers, d_model
   3584, bf16, random weights from the seed) serves 16 ragged requests
   through ``DecodeEngine(slots=8)``, with in-wave refill; every kernel's
   launch counter must rise during the drain, and the full-size prefill
   logits through the kernels must agree with the plain path's;
5. end to end: a 2-layer, full-width f32 qwen2-7b drains the same kind of
   queue through the kernels and through ``backend="torch"``; the greedy
   tokens must be identical, and equal to solo generation.

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
}


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
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import ref

    def randn(*shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * s).to(dtype)

    cases = {"lora_matmul": [], "flash_attention": [], "flash_decode": []}

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
    return cases


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------

def queue(rng, n, lens, gens, vocab):
    return [(rng.integers(0, vocab, int(rng.integers(*lens))).astype(np.int32),
             int(rng.integers(*gens))) for _ in range(n)]


def drain(cfg, params, reqs, slots):
    from repro_torch.launch.engine import DecodeEngine
    eng = DecodeEngine(cfg, slots=slots, device="cuda")
    uids = [eng.submit(p, g) for p, g in reqs]
    comps, stats = eng.run(params)
    torch.cuda.synchronize()
    by = {c.uid: c for c in comps}
    check(sorted(by) == sorted(uids), "engine lost a request")
    return [by[u] for u in uids], stats


def main_path(seed: int) -> dict:
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
    peak = torch.cuda.max_memory_allocated()
    for c, (p, g) in zip(comps, reqs):
        check(len(c.tokens) == g and not c.timed_out,
              f"request {c.uid}: {len(c.tokens)} tokens, budget {g}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"request {c.uid}: token out of vocab")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(stats.waves > 1, "no in-wave refill happened")
    h = stats.ttft_hist
    log(f"main: {stats.requests} requests, {stats.tokens} tokens in "
        f"{stats.wall_s:.3f}s = {stats.tok_per_s:.2f} tok/s; waves "
        f"{stats.waves}, segments {stats.segments}, padded_tokens "
        f"{stats.padded_tokens}; ttft p50 {h['p50']:.4f}s p99 "
        f"{h['p99']:.4f}s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")

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
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, requests=stats.requests,
                tokens=stats.tokens, wall_s=stats.wall_s,
                tok_per_s=stats.tok_per_s, waves=stats.waves,
                segments=stats.segments, padded_tokens=stats.padded_tokens,
                ttft_p50_s=h["p50"], ttft_p99_s=h["p99"],
                tok_latency_p50_s=stats.tok_latency_hist["p50"],
                peak_mem_gib=peak / 2 ** 30, prefill_logits_cosine=cos)


def end_to_end(seed: int) -> dict:
    from repro_torch.configs.base import get_config
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
    del params
    torch.cuda.empty_cache()
    return dict(requests=len(reqs), waves=st.waves, tokens_equal=True)


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
    rec["main"] = main_path(args.seed)
    rec["e2e"] = end_to_end(args.seed)

    kernels = []
    for name, cs in cases.items():
        head = cs[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": rec["main"]["launches"][name],
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
