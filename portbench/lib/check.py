"""What decides ``correct`` for a served model.

After the window, a sample of the finished requests, drawn from the
seed and holding the one with the most served tokens, is replayed
through the plain reference (float32, TF32 off): the prompt followed by
the served tokens, each request with its own domain's adapters. At each
served position the reference's logits are read, and the number
compared is the widest gap by which a served token's logit lies below
the reference's best there (greedy decoding serves the argmax of the
program's own logits, so a sound program stays within its rounding), or,
where a cell's file says so, the mean of those gaps.

The control (``controls.py``, not run by the benchmark) reads, at the
same positions, the gap of the token that the reference computed in
float8 puts first.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import traffic


def sample(done: list[dict], seed: int, tokens: int, most: int) -> list:
    """Indices into ``done`` (requests with ``out`` tokens): the longest,
    then seed-drawn others until ``tokens`` served tokens or ``most``
    requests."""
    if not done:
        return []
    lens = np.array([len(r["out"]) for r in done])
    first = int(np.argmax(lens))
    rest = [i for i in traffic.rng_for(seed, "check").permutation(len(done))
            if i != first]
    picked, total = [first], int(lens[first])
    for i in rest:
        if total >= tokens or len(picked) >= most:
            break
        picked.append(int(i))
        total += int(lens[i])
    return picked


def ref_logits(ref, params, adapters, sizes, req, device,
               precision="f32") -> torch.Tensor:
    """(n_out, vocab) reference logits at the positions whose argmax the
    served tokens are."""
    prompt = np.asarray(req["tokens"], np.int64)
    out = np.asarray(req["out"], np.int64)
    seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]), device=device)
    with torch.no_grad():
        return ref.logits(params, adapters, sizes, seq, len(prompt) - 1,
                          precision)


def gaps_of(ref_lg: torch.Tensor, chosen: torch.Tensor) -> np.ndarray:
    """``max(ref) - ref[chosen]`` at each position."""
    best = ref_lg.max(-1).values
    got = ref_lg.gather(-1, chosen.long()[:, None])[:, 0]
    return (best - got).double().cpu().numpy()


def numbers(gaps: np.ndarray) -> dict:
    """The numbers a cell may compare, from the gaps of every checked
    position: the widest (``logit_gap``), the mean (``logit_gap_mean``),
    and, for the record, the 90th percentile and the share of positions
    whose token is not the reference's first."""
    return {"logit_gap": float(gaps.max()),
            "logit_gap_mean": float(gaps.mean()),
            "logit_gap_p90": float(np.percentile(gaps, 90)),
            "off_top_share": float((gaps > 0).mean())}


def served_gaps(ref, params, adapters_of, sizes, reqs, device) -> dict:
    """:func:`numbers` of the served tokens of ``reqs`` (each with
    ``tokens``, ``out`` and ``domain``)."""
    gaps = []
    for r in reqs:
        lg = ref_logits(ref, params, adapters_of[r["domain"]], sizes, r,
                        device)
        out = torch.as_tensor(np.asarray(r["out"], np.int64), device=device)
        gaps.append(gaps_of(lg, out))
        del lg
    return numbers(np.concatenate(gaps))


def control_gaps(ref, params, adapters_of, sizes, reqs, device) -> dict:
    """:func:`numbers` of the tokens the float8 reference puts first, at
    the same positions, their gaps read in the float32 reference."""
    gaps = []
    for r in reqs:
        lg = ref_logits(ref, params, adapters_of[r["domain"]], sizes, r,
                        device)
        lo = ref_logits(ref, params, adapters_of[r["domain"]], sizes, r,
                        device, "fp8")
        gaps.append(gaps_of(lg, lo.argmax(-1)))
        del lg, lo
    return numbers(np.concatenate(gaps))
