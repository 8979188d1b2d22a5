#!/usr/bin/env python3
"""Time the port's attention kernels of one source tree on the GPU.

    PYTHONPATH=<tree>/src python3 scripts/time_attention_kernels.py \\
        [--label NAME] [--reps 41]

Times ``flash_attention`` and ``flash_decode`` at ``chip_smoke.py``'s
phase 3 shapes (bf16: prefill of 8 x 512 tokens behind 16 prefix slots;
decode of 8 rows against 1024 slots behind 16 prefix slots), and
``flash_decode_paged`` at phase 12's where the tree has it, and the
head-dim-256 instances at phase 22's shapes where the tree has them, and
head dim 64 at vit-edge's classify shape (phase 3), with
``chip_smoke.Timer`` (median of CUDA-event timings, L2 flushed before each
launch) on inputs drawn from a fixed seed, so that runs of two trees see
the same inputs; then the ``flash_attention`` shapes' device time per
kernel (``torch.profiler`` over 10 calls, L2 flushed before each, as in
``scripts/time_lora_kernels.py``), which leaves out the host's time
between launches. Each decode shape is timed twice: ``<shape>_ms`` is
the kernel alone (``fd.flash_decode`` with the prefix bank in place
where the tree takes it, else on the cache with the bank concatenated
beforehand), ``<shape>_ops_ms`` the call as the models make it
(``ops.flash_decode`` with the bank; a tree that concatenates does so
inside it); ``device_us`` gives that call's kernels and ``host_us`` its
host time (``chip_smoke.host_us``: 1,000 calls timed with
``time.perf_counter`` in batches of 50, a synchronise (untimed) between
batches so that the launch queue never fills and blocks the host, the
median batch's time a call). The multi-tenant bank drains' layout is
timed too (``<shape>_bank_by_id``): a 4-domain bank's stacked prefix
slots and each row's domain id, passed as ``prefix_ids`` where the tree's
``ops`` takes them, else gathered per row with ``index_select`` inside
the timed call, as such a tree's ``models/attention.py`` gathers them
every layer and step; ``map_encodes`` counts the TMA maps the tree
encoded over those calls, where it counts them. ``repro_torch`` comes from
``PYTHONPATH``: run it once per tree, alternating trees (parent, change,
change, parent) within one call to the card. Prints the card's name and
power limit, then one JSON line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]



def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=41)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer, host_us
    from scripts.time_lora_kernels import device_us
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(reps=args.reps)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    B, S, n_p, Hq, Hkv, D, Tc = 8, 512, 16, 28, 4, 128, 1024
    out = {"label": args.label, "source": fa.__file__, "device_us": {},
           "host_us": {}}
    in_place = "prefix_k" in inspect.signature(fd.flash_decode).parameters
    by_id = "prefix_ids" in inspect.signature(ops.flash_decode).parameters
    out["map_encodes"] = {}
    ids = torch.tensor([1, 3, 0, 1, 2, 2, 3, 0], dtype=torch.int32,
                       device="cuda")

    def bank_call(fn, bk, bv, *args, **kw):
        """``fn`` with the stacked bank bk / bv read by ``ids``, as the
        tree's bank drains call it."""
        if by_id:
            return partial(fn, *args, prefix_k=bk, prefix_v=bv,
                           prefix_ids=ids, **kw)
        rows = ids.long()

        def gathered():
            return fn(*args, prefix_k=bk.index_select(0, rows),
                      prefix_v=bv.index_select(0, rows), **kw)
        return gathered

    def bank_times(label, call):
        """Device and host time of a bank call, and the maps it encodes
        over the host timing's 1,010 calls."""
        out["device_us"][label] = device_us(call, timer.flush)
        e0 = getattr(fd, "map_encodes", None)
        out["host_us"][label] = host_us(call)
        if e0 is not None:
            out["map_encodes"][label] = fd.map_encodes - e0

    def decode(label, q, kc, vc, qp, kpc, pk, pv, window=0):
        """``label``: the kernel alone and the models' call (see above);
        kc / vc / kpc the cache alone, pk / pv the prefix bank."""
        kw = dict(q_pos=qp, window=window)
        if in_place:
            kernel = partial(fd.flash_decode, q, kc, vc, kv_pos=kpc,
                             prefix_k=pk, prefix_v=pv, **kw)
        else:
            kk, vv, kp = (t.contiguous() for t in fd.with_prefix(
                kc, vc, kpc, pk, pv))
            kernel = partial(fd.flash_decode, q, kk, vv, kv_pos=kp, **kw)
        call = partial(ops.flash_decode, q, kc, vc, kv_pos=kpc, prefix_k=pk,
                       prefix_v=pv, **kw)
        out[f"{label}_ms"] = timer(kernel)
        out[f"{label}_ops_ms"] = timer(call)
        out["device_us"][label] = device_us(call, timer.flush)
        out["host_us"][label] = host_us(call)

    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"), q_pos])
    q, k, v = randn(B, S, Hq, D), randn(B, n_p + S, Hkv, D), \
        randn(B, n_p + S, Hkv, D)
    prefill = partial(fa.flash_attention, q, k, v, q_pos=q_pos,
                      kv_pos=kv_pos)
    out["flash_attention_ms"] = timer(prefill)
    out["device_us"]["flash_attention"] = device_us(prefill, timer.flush)

    # decode: the bank (16 slots, shared) and a 1024-slot cache with
    # sentinels past each row's position
    q, kc, vc = randn(B, Hq, D), randn(B, Tc, Hkv, D), randn(B, Tc, Hkv, D)
    pk, pv = randn(n_p, Hkv, D), randn(n_p, Hkv, D)
    qp = torch.randint(32, Tc, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    slots = torch.arange(Tc, dtype=torch.int32, device="cuda")[None]
    kpc = torch.where(slots <= qp[:, None], slots,
                      torch.full_like(slots, 10 ** 9)).contiguous()
    decode("flash_decode", q, kc, vc, qp, kpc, pk, pv)
    bk, bv = randn(4, n_p, Hkv, D), randn(4, n_p, Hkv, D)
    bank_times("flash_decode_bank_by_id",
               bank_call(ops.flash_decode, bk, bv, q, kc, vc, q_pos=qp,
                         kv_pos=kpc))

    if hasattr(fd, "flash_decode_paged"):
        bs, maxb, nb = 16, 64, 512
        k_pool, v_pool = randn(nb, bs, Hkv, D), randn(nb, bs, Hkv, D)
        pk, pv = randn(B, n_p, Hkv, D), randn(B, n_p, Hkv, D)
        perm = torch.randperm(nb, generator=gen, device="cuda")
        table = perm[:B * maxb].reshape(B, maxb).to(torch.int32)
        cols = torch.arange(maxb, device="cuda")[None]
        table = torch.where(cols <= qp[:, None] // bs, table,
                            torch.full_like(table, nb))
        paged = partial(fd.flash_decode_paged, q, k_pool, v_pool, table,
                        q_pos=qp, prefix_k=pk, prefix_v=pv)
        out["flash_decode_paged_ms"] = timer(paged)
        call = partial(ops.flash_decode_paged, q, k_pool, v_pool, table,
                       q_pos=qp, prefix_k=pk, prefix_v=pv)
        out["device_us"]["flash_decode_paged"] = device_us(call, timer.flush)
        out["host_us"]["flash_decode_paged"] = host_us(call)
        bank_times("flash_decode_paged_bank_by_id",
                   bank_call(ops.flash_decode_paged, bk, bv, q, k_pool,
                             v_pool, table, q_pos=qp))
    if getattr(fa, "DMAX", 128) >= 256:
        # head dim 256 (recurrentgemma-2b): prefill of 8 x 512 tokens behind
        # 16 prefix slots, window 2048; decode against a 2048-slot buffer
        Hq, Hkv, D, win = 10, 1, 256, 2048
        q, k, v = randn(B, S, Hq, D), randn(B, n_p + S, Hkv, D), \
            randn(B, n_p + S, Hkv, D)
        prefill = partial(fa.flash_attention, q, k, v, q_pos=q_pos,
                          kv_pos=kv_pos, window=win)
        out["flash_attention_d256_ms"] = timer(prefill)
        out["device_us"]["flash_attention_d256"] = device_us(prefill,
                                                             timer.flush)
        # in its steady state, as phase 22 draws it: every row at or past
        # the window, so all 2048 + 16 slots are visible
        q, kc, vc = randn(B, Hq, D), randn(B, win, Hkv, D), \
            randn(B, win, Hkv, D)
        pk, pv = randn(n_p, Hkv, D), randn(n_p, Hkv, D)
        qp = torch.randint(win - 1, 2 * win, (B,), generator=gen,
                           device="cuda", dtype=torch.int32)
        slots = torch.arange(win, dtype=torch.int32, device="cuda")[None]
        held = slots + torch.div(qp[:, None] - slots, win,
                                 rounding_mode="floor") * win
        decode("flash_decode_d256", q, kc, vc, qp,
               held.to(torch.int32).contiguous(), pk, pv, window=win)
    # head dim 64 (vit-edge's classify): 8 x 197 tokens behind 16 prefix
    # slots, 12 / 12 heads, causal
    S, Hq, Hkv, D = 197, 12, 12, 64
    q_pos = torch.arange(S, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([torch.full((n_p,), -1, dtype=torch.int32,
                                   device="cuda"), q_pos])
    q, k, v = randn(B, S, Hq, D), randn(B, n_p + S, Hkv, D), \
        randn(B, n_p + S, Hkv, D)
    prefill = partial(fa.flash_attention, q, k, v, q_pos=q_pos,
                      kv_pos=kv_pos)
    out["flash_attention_d64_ms"] = timer(prefill)
    out["device_us"]["flash_attention_d64"] = device_us(prefill, timer.flush)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
