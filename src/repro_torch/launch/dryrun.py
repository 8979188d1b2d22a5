"""Dry-run of every (arch x input shape) on one card (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out/dryrun.json

The reference lowers and compiles each step on its 16 x 16 production
mesh and reads XLA's memory and cost analyses. The port runs on one
card, which plays one data row of that mesh: each shape's batch is
``global_batch // 16`` (``DATA_ROWS``, the mesh's data-parallel size;
``long_500k`` keeps its batch of 1), and a train step trains one
cluster. A decode of batch 1 (``long_500k``) runs under the reference's
``long_decode_rules``, which split the KV cache's slot dim (``kv_seq``)
over the data rows instead of the batch: one card counts its share of
every attention cache, ``1 / 16`` of the slots (``1 / 32`` with
``--multi-pod``; qwen2-7b's sliding-window variant keeps 256 of its
4096), while the ssm and hybrid recurrent states, which have no
``kv_seq`` dim, stay whole (:func:`card_share`). A moe prefill needs no
such change: its expert bytes a card are ``1 / 256`` of the experts
under both ``DEFAULT_RULES`` (experts on `model`, their d_model on the
data rows) and ``moe_serving_rules`` (experts on `data`, their d_model
on `model`) on the 16 x 16 mesh, and one card plays both axes' share of
them here. :func:`build_step` builds the step (the HFSL train step, the
prefill or the decode step) and its parameter, optimizer, cache and batch
tensors on ``meta`` from ``model_spec`` / ``cache_spec`` /
``input_specs``: no weight is drawn and nothing runs on a card.
:func:`run_one` counts the step with ``roofline.count_costs`` and reports
the reference's result: status, ``memory_analysis`` (argument, output
and peak bytes), the roofline terms at the H100's peaks, ``model_flops``,
and whether the step fits one H100's 80 GB. ``--multi-pod`` takes the
2 x 16 x 16 (`pod`, `data`, `model`) mesh instead: one card plays one of
its 32 data rows (``launch/mesh.py::data_parallel_size``), so the batch
is ``global_batch // 32``, and the ``mesh`` field of each record says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      get_config)
from repro_torch.core import hfsl
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import data_parallel_size, production_layout
from repro_torch.models import model as M
from repro_torch.models.attention import param_dtype
from repro_torch.models.params import init_from_spec, tree_map
from repro_torch.optim.optimizers import adamw

ASSIGNED = [
    "falcon-mamba-7b", "kimi-k2-1t-a32b", "recurrentgemma-2b", "qwen2-7b",
    "llava-next-mistral-7b", "qwen1.5-32b", "qwen2.5-32b", "qwen2.5-14b",
    "granite-moe-1b-a400m", "whisper-small",
]

# (arch, shape) pairs that are semantically inapplicable
SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec with full self+cross attention and a 448-position decoder; "
        "no sub-quadratic variant in its family",
}

# data-parallel size of the reference's make_production_mesh() (16 x 16):
# one card is one of its data rows
DATA_ROWS = data_parallel_size(production_layout())


def data_rows(multi_pod: bool = False) -> int:
    """The production mesh's data-parallel size: 16, or 32 multi-pod."""
    return data_parallel_size(production_layout(multi_pod=multi_pod))


def mesh_label(multi_pod: bool = False, kv_split: bool = False) -> str:
    lay = production_layout(multi_pod=multi_pod)
    rows = data_rows(multi_pod)
    split = (f"; long_decode_rules: the KV cache's kv_seq split over the "
             f"{rows} data rows, 1/{rows} of its slots a card"
             if kv_split else "")
    return (f"1 (one data row of the "
            f"{'x'.join(map(str, lay.shape))} mesh{split})")


def card_share(spec, multi_pod: bool = False):
    """A cache spec tree with each dim that ``long_decode_rules`` puts on
    the batch axes (`pod`, `data`) cut to one data row's share (the
    attention caches' ``kv_seq``; a dim that does not divide stays whole,
    as ``fit_spec`` leaves it); every other dim, the recurrent states
    included, as it is."""
    from repro_torch.sharding import rules as R
    lay = production_layout(multi_pod=multi_pod)
    rules = R.long_decode_rules()
    names = tuple(lay.mesh_dim_names)

    def one(s):
        p = R.fit_spec(R.spec_for(s.axes, lay, rules), s.shape, lay)
        shape = list(s.shape)
        for i, entry in enumerate(p):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            for a in axes:
                if a in ("pod", "data"):
                    shape[i] //= lay.shape[names.index(a)]
        return dataclasses.replace(s, shape=tuple(shape))
    return tree_map(one, spec)


def variant_for(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """long_500k on full-attention archs -> sliding-window variant."""
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm", "moe") \
            and cfg.attn_variant != "sliding":
        return cfg.with_(attn_variant="sliding", sliding_window=4096)
    return cfg


def row_shape(shape: InputShape, multi_pod: bool = False) -> InputShape:
    """The share of ``shape`` that one data row takes."""
    return dataclasses.replace(
        shape, global_batch=max(1, shape.global_batch
                                // data_rows(multi_pod)))


def _tensors_of(spec, device: torch.device, seed: int):
    """A spec tree's tensors: empty on ``meta``; elsewhere drawn from
    ``seed`` (zeros where the spec says so, as a fresh cache is)."""
    if device.type == "meta":
        return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device=device), spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_from_spec(gen, spec, device)


def _fill_positions(caches: dict, seq_len: int) -> None:
    """A full cache at the step at ``seq_len - 1``: each ``pos`` plane
    (L, B, S) holds the last S positions, the step's own included, all
    visible to it (as its count on ``meta`` takes them)."""
    for k, v in caches.items():
        if isinstance(v, dict):
            _fill_positions(v, seq_len)
        elif k == "pos":
            S = v.shape[-1]
            v.copy_(torch.arange(seq_len - S, seq_len,
                                 dtype=v.dtype, device=v.device))


def _inputs(cfg: ModelConfig, shape: InputShape, device: torch.device,
            seed: int) -> dict:
    """The batch of ``shape``: ``input_specs`` on ``meta``; elsewhere
    tokens and labels drawn below the vocab and modality rows at 0.1."""
    specs = M.input_specs(cfg, shape)
    if device.type == "meta":
        return specs
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {}
    for k, v in specs.items():
        if v.is_floating_point():
            out[k] = (torch.randn(v.shape, generator=gen, device=device)
                      * 0.1).to(v.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                   device=device, dtype=v.dtype)
    return out


def build_step(arch: str, shape_name: str, *, reduced: bool = False,
               device="meta", remat: bool = True, seed: int = 0,
               multi_pod: bool = False):
    """The step of (arch, shape) for one data row, and its arguments.

    ``shape_name`` names one of ``INPUT_SHAPES``, or is an ``InputShape``
    of one data row (the profile's other shapes). Returns ``(fn, args,
    meta)``: ``fn(*args)`` runs the step once. On ``meta`` (the default)
    every tensor is an empty stand-in; on a device the weights are random
    from ``seed`` and the caches full: zero K and V at the positions
    before the step, every slot visible to it (as its count on ``meta``
    takes them). ``reduced=True`` shrinks config and shape for
    the CPU tests (the reference's smoke shape: 128 tokens, batch 16).
    ``multi_pod`` takes one data row of the 2 x 16 x 16 mesh."""
    dev = torch.device(device)
    if isinstance(shape_name, InputShape):        # one data row's already
        row = shape = shape_name
        shape_name = shape.name
    else:
        shape = INPUT_SHAPES[shape_name]
        if reduced:
            shape = InputShape(shape.name, 128, 16, shape.kind)
        row = row_shape(shape, multi_pod)
    cfg = variant_for(get_config(arch), shape_name)
    if reduced:
        cfg = variant_for(get_config(arch).reduced(), shape_name)
        cfg = cfg.with_(sliding_window=64)
    # the reference's rule: a decode of global batch 1 takes
    # long_decode_rules (kv_seq on the data rows)
    kv_split = shape.kind == "decode" and shape.global_batch == 1
    params = _tensors_of(M.model_spec(cfg), dev, seed)
    batch = _inputs(cfg, row, dev, seed)

    if shape.kind == "train":
        opt = adamw(1e-4)
        state = hfsl.init_hfsl_state(seed, cfg, 1, opt,
                                     lambda c, s, device=None: params)

        def loss_fn(p, b, cfg_):
            return M.lm_loss(p, b, cfg_, remat=remat)

        fn = hfsl.make_hfsl_step(cfg, opt, loss_fn, always_sync=True)
        args = (state, {k: v[None] for k, v in batch.items()})
    elif shape.kind == "prefill":
        def fn(p, b):
            return M.prefill(p, b, cfg)
        args = (params, batch)
    else:
        window = cfg.sliding_window if cfg.attn_variant == "sliding" else 0
        cache_len = min(window, shape.seq_len) if window else shape.seq_len
        cspec = M.cache_spec(cfg, row.global_batch, cache_len)
        if kv_split:
            cspec = card_share(cspec, multi_pod)
        caches = _tensors_of(cspec, dev, seed)
        if dev.type != "meta":
            _fill_positions(caches, shape.seq_len)
        pos = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                         device=dev)

        def fn(p, token, c, pos_):
            return M.decode_step(p, token, c, pos_, cfg)
        args = (params, batch["token"], caches, pos)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": mesh_label(multi_pod, kv_split), "chips": 1,
            "data_rows": data_rows(multi_pod),
            "kind": shape.kind, "family": cfg.family, "cfg": cfg,
            "shape_obj": row, "global_batch": shape.global_batch,
            "batch": row.global_batch}
    return fn, args, meta


def memory_analysis(costs: rl.StepCosts) -> dict:
    """The reference's ``memory_analysis`` keys from a count."""
    return {"argument_size_in_bytes": costs.argument_bytes,
            "output_size_in_bytes": costs.output_bytes,
            "temp_size_in_bytes": max(0, costs.peak_live_bytes
                                      - costs.output_bytes),
            "peak_memory_in_bytes": costs.peak_bytes}


def count_one(arch: str, shape_name, *, reduced: bool = False,
              device="meta", multi_pod: bool = False
              ) -> tuple[dict, rl.StepCosts | None]:
    """The dry-run of one pair (``shape_name`` as :func:`build_step`
    takes it) and the count it came from (None for a skipped pair)."""
    name = getattr(shape_name, "name", shape_name)
    if (arch, name) in SKIPS:
        return {"arch": arch, "shape": name, "status": "skipped",
                "reason": SKIPS[(arch, name)]}, None
    t0 = time.perf_counter()
    fn, args, meta = build_step(arch, shape_name, reduced=reduced,
                                device=device, multi_pod=multi_pod)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    costs = rl.count_costs(fn, *args)
    t_count = time.perf_counter() - t0
    shape_name = meta["shape"]
    mem = memory_analysis(costs)
    model_flops = rl.model_flops_for(meta["cfg"], meta["shape_obj"])
    roof = rl.Roofline.from_costs(
        costs, arch=arch, shape=shape_name, mesh=meta["mesh"],
        chips=meta["chips"], model_flops=model_flops, memory_analysis=mem)
    dtype = param_dtype(meta["cfg"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": meta["mesh"],
        "chips": meta["chips"], "kind": meta["kind"], "status": "ok",
        "global_batch": meta["global_batch"], "batch": meta["batch"],
        "data_rows": meta["data_rows"], "build_s": round(t_build, 2),
        "count_s": round(t_count, 2), "memory_analysis": mem,
        "fits_one_h100": mem["peak_memory_in_bytes"] <= rl.HBM_BYTES,
        "roofline": roof.asdict(), "model_flops": model_flops,
        "mfu_bound": rl.mfu(model_flops, roof.step_s(), dtype)
        if roof.step_s() > 0 else 0.0,
        "kernel_calls": dict(costs.kernel_calls),
    }
    return result, costs


def run_one(arch: str, shape_name, *, reduced: bool = False,
            device="meta", verbose: bool = True,
            multi_pod: bool = False) -> dict:
    """The dry-run of one pair (:func:`count_one` without its count)."""
    result, costs = count_one(arch, shape_name, reduced=reduced,
                              device=device, multi_pod=multi_pod)
    if verbose and costs is not None:
        print(summary(result))
    return result


def _one(pair: tuple) -> dict:
    """One pair of a sweep, in a worker: its result, or its error."""
    arch, shape, reduced, device, multi_pod = pair
    try:
        return run_one(arch, shape, reduced=reduced, device=device,
                       verbose=False, multi_pod=multi_pod)
    except Exception as e:         # one pair's fault, the sweep goes on
        return {"arch": arch, "shape": shape, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()}


def sweep(pairs: list, *, reduced: bool = False, device="meta",
          multi_pod: bool = False) -> list:
    """run_one over ``pairs`` in order."""
    return [_one((a, s, reduced, device, multi_pod)) for a, s in pairs]


def summary(r: dict) -> str:
    """One line of a result."""
    if r["status"] != "ok":
        return (f"[dryrun] {r['arch']} x {r['shape']} {r['status']}: "
                f"{r.get('reason') or r.get('error')}")
    ro, m = r["roofline"], r["memory_analysis"]
    return (f"[dryrun] {r['arch']} x {r['shape']} batch {r['batch']} (of "
            f"{r['global_batch']}) ok: fits one H100 {r['fits_one_h100']} "
            f"(arguments {m['argument_size_in_bytes'] / 1e9:.2f} GB, peak "
            f"{m['peak_memory_in_bytes'] / 1e9:.2f} GB), flops "
            f"{ro['flops_per_device']:.3e}, bytes "
            f"{ro['bytes_per_device']:.3e}, {ro['bottleneck']}-bound "
            f"(compute {ro['compute_s']:.4f} s, memory {ro['memory_s']:.4f}"
            f" s), MFU bound {r['mfu_bound']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="all")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="meta",
                    help="meta (default: shapes only) or cpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    t0 = time.perf_counter()
    results = sweep([(a, s) for a in archs for s in shapes],
                    reduced=args.reduced, device=args.device,
                    multi_pod=args.multi_pod)
    for r in results:
        print(summary(r))
        if r["status"] == "error":
            print(r["traceback"], file=sys.stderr)
    failures = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] {len(results)} pairs, {failures} error(s) in "
          f"{time.perf_counter() - t0:.1f}s")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.json}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
