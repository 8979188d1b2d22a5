#!/usr/bin/env python3
"""How far two correct scans drift apart through falcon-mamba-7b's layers.

    PYTHONPATH=src python3 scripts/ssm_divergence.py [--dtype bfloat16]
        [--layers 64] [--tokens 128] [--seed 0]

Runs one prompt through the model layer by layer three times from the same
embeddings: with the ``selective_scan`` CUDA kernel, with its plain version,
and with the plain oracle ``kernels/ref.py::selective_scan`` (the same
function, whose step rounds ``(dt B) x`` where the kernel rounds
``(dt x) B``). Prints, every few layers, the cosine similarity and the
largest difference of the hidden states (kernel vs plain, and plain vs
oracle), and the same for the last token's logits. Two plain versions
that differ only in rounding order show how much the network itself
amplifies a one-ulp difference; a kernel fault would show as a kernel
drift far beyond it. Random weights from the seed; needs one GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_divergence: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import model as M
    from repro_torch.models.layers import embed, rmsnorm, unembed
    from repro_torch.models.transformer import stack_seq

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config("falcon-mamba-7b").with_(n_layers=args.layers,
                                              dtype=args.dtype)
    params = M.init(cfg, args.seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (1, args.tokens), generator=g,
                         device="cuda")
    one = cfg.with_(n_layers=1)
    pos = torch.arange(args.tokens, device="cuda")
    layers = params["backbone"]["layers"]["g0"]
    adapters = params["adapters"]["stack"]["g0"]
    plain = ss.selective_scan_torch

    def oracle(*a):
        return ref.selective_scan(*a)

    xs = {k: embed(params["backbone"]["embed"], toks) for k in
          ("kernel", "plain", "oracle")}
    print(f"falcon-mamba-7b {args.layers} layers {args.dtype}, "
          f"{args.tokens} tokens, seed {args.seed}")
    print("layer  cos(kernel,plain)  max|kernel-plain|  cos(plain,oracle)  "
          "max|plain-oracle|  max|x|")
    with torch.no_grad():
        for l in range(args.layers):
            for k in xs:
                run = {"g0": [layers[l]]}
                ad = {"g0": [adapters[l]]}
                if k == "kernel":
                    xs[k], _, _ = stack_seq(run, ad, xs[k], one,
                                            positions=pos)
                else:
                    ss.selective_scan_torch = plain if k == "plain" \
                        else oracle
                    try:
                        with ops.backend("torch"):
                            xs[k], _, _ = stack_seq(run, ad, xs[k], one,
                                                    positions=pos)
                    finally:
                        ss.selective_scan_torch = plain
            if l % 8 == 0 or l == args.layers - 1:
                a, b, c = (xs[k].float().flatten() for k in
                           ("kernel", "plain", "oracle"))
                print(f"{l:5d}  {F.cosine_similarity(a, b, dim=0).item():.6f}"
                      f"  {(a - b).abs().max().item():.4e}"
                      f"  {F.cosine_similarity(b, c, dim=0).item():.6f}"
                      f"  {(b - c).abs().max().item():.4e}"
                      f"  {b.abs().max().item():.4e}")
        lg = {k: unembed(M._head(params),
                         rmsnorm(params["backbone"]["final_norm"],
                                 x[:, -1:])).flatten()
              for k, x in xs.items()}
    print(f"logits: cos(kernel,plain) "
          f"{F.cosine_similarity(lg['kernel'], lg['plain'], dim=0).item():.6f}"
          f" cos(plain,oracle) "
          f"{F.cosine_similarity(lg['plain'], lg['oracle'], dim=0).item():.6f}"
          f"; top-1 kernel {int(lg['kernel'].argmax())} plain "
          f"{int(lg['plain'].argmax())} oracle {int(lg['oracle'].argmax())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
